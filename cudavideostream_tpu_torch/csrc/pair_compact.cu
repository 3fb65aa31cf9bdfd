// K2 on Hopper: stable compaction of (xs, vals) pairs by vals != 0; and
// K3: the same compaction of a vals stream alone.
//
// K2 replaces the TPU kernel cudavideostream_tpu/ops/logcompact.py:_kernel_pair
// (launched by _pair_compact from _merge_tiles_two_stage, which
// merge_tiles takes past MERGE_SERIAL_MAX_UNITS = 256 units) together with
// the serial merge _merge_tiles_impl that follows it there.
//
// What it computes, over n pairs (xs[i] int32, vals[i] uint8): the pairs
// with vals[i] != 0, in input order, at xs_out[0..pos) and
// vals_out[0..pos), zeros in [pos, n), and pos (their count). An xs value
// of 0 is an ordinary index: validity follows vals alone. On the tiled
// path the input is K1's per-unit blocks flattened, which are zero past
// each unit's count, so the output is the flat payload.
//
// The TPU kernel writes per-tile blocks that a serial loop of
// dynamic_update_slices then merges; that split exists for the TPU's
// sequential grid. Here the output is flat in ONE launch that reads each
// input byte once (pair_lookback_kernel), with decoupled look-back
// (csrc/lookback.cuh): a persistent grid (occupancy x SMs,
// cvs_pair_blocks: 3 blocks an SM under an 80-register cap) takes tiles of
// kPairTile = 8,192 pairs in ascending order from a ticket. Per tile, each
// thread has its 2 groups of 16 vals (loaded during the previous tile),
// issues the loads of the 16-byte words of xs that hold a valid pair,
// ranks its groups in the tile (one block scan of packed counts, while
// those loads fly), publishes the tile's count, issues the next tile's
// vals loads, and stages (xs, vals) in rank order in 40 KB of dynamic
// shared memory. Warp 0 then looks back for the tile's offset, and the
// tile's pairs go out coalesced at offset + rank, with the tile's band of
// the zero tail of both outputs in 16-byte stores. No atomics decide where
// a pair goes: the order is the input order by construction.
//
// Bound. Device-memory bytes: it reads vals (n) and, where a pair is
// valid, its xs (4 pos; a 16-byte word of xs is read only when it holds
// one), and writes xs_out and vals_out full length (5 n) plus pos. At
// 1080p and sub_rows = 1 (n = 6,221,824) with pos = 10% of n that is
// about 40 MB, 12 us at 3.35 TB/s; reading every xs would add 4 n
// (18.57 us for the whole function). The zero tail is most of it (about
// 28 MB at 10% valid); a two-pass design (count, then compact) also paid
// a second launch and a second read of vals. As in K1's flat emission,
// the look-back chain bounds it at 1080p; the xs loads, which wait on the
// vals, add a second round trip to each tile that the block scan and the
// look-back only partly hide.
//
// K3 replaces the TPU kernel cudavideostream_tpu/ops/logcompact.py:_kernel_vals
// (launched by _vals_compact from _merge_vals_two_stage) together with
// the serial merge _merge_vals_impl, i.e. both branches of merge_vals:
// the merge of the bitmask-only emission's per-unit vals blocks, whose
// indices the landing rebuilds from the packed bits. It is K2's function
// with the xs stream removed, in the two-pass design: count_kernel counts
// the valid vals of each block's span of 4,096-byte tiles (ops/
// logcompact.py:tile_plan), then vals_compact_kernel sums the counts of
// the blocks before it, rereads vals, ranks, stages and writes the valid
// vals and zero-fills [pos, n) in 16-byte stores. Bound: it reads n bytes and writes
// n bytes (plus pos): 12,451,844 B at 1080p's mask geometry
// (n = 6,225,920), 3.72 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

namespace lb = cvs_lookback;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTileBytes = kThreads * kPerThread;  // 4096 pairs
constexpr unsigned kFull = 0xffffffffu;

using Vec16 = lb::Vec16;

// The 16-bit validity mask (bit k: vals[i0 + k] != 0) and the vals;
// pairs at or past n are invalid.
__device__ __forceinline__ unsigned valid_mask(const uint8_t* __restrict__ vals,
                                               long long i0, long long n,
                                               Vec16& v) {
  if (i0 + 16 <= n) {
    v.v = *reinterpret_cast<const uint4*>(vals + i0);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) v.b[k] = (i0 + k < n) ? vals[i0 + k] : 0;
  }
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (v.b[k]) m |= 1u << k;
  return m;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ vals, long long n,
             int tiles_per_block, int* __restrict__ counts) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * tiles_per_block * kTileBytes;
  int cnt = 0;
  for (int t = 0; t < tiles_per_block; ++t) {
    const long long i0 = base + (long long)t * kTileBytes + threadIdx.x * kPerThread;
    if (i0 < n) {
      Vec16 v;
      cnt += __popc(valid_mask(vals, i0, n, v));
    }
  }
  cnt = warp_sum(cnt);
  if (lane == 0) s_warp[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += s_warp[w];
    counts[blockIdx.x] = tot;
  }
}

// ---- K2: one pass with decoupled look-back ------------------------------

// 16-pair groups per thread per tile, and the blocks an SM must hold (the
// register cap)
constexpr int kPairVecs = 2;
constexpr int kPairMinBlocks = 3;
constexpr int kPairTile = kTileBytes * kPairVecs;  // 8,192 pairs
// staging per slot: xs (int32) and vals (uint8)
constexpr size_t kPairSmem = 5 * (size_t)kPairTile;

// The vals of the thread's groups of the tile at base (zeros past n).
__device__ __forceinline__ void pair_load(const uint8_t* __restrict__ vals,
                                          long long n, long long base,
                                          Vec16 (&v)[kPairVecs]) {
#pragma unroll
  for (int q = 0; q < kPairVecs; ++q) {
    const long long i0 = base + q * kTileBytes + threadIdx.x * kPerThread;
    if (i0 + 16 <= n) {
      v[q].v = *reinterpret_cast<const uint4*>(vals + i0);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) v[q].b[k] = (i0 + k < n) ? vals[i0 + k] : 0;
    }
  }
}

// The validity masks of the thread's groups of the tile at base and their
// counts, from its vals, and the loads of the 16-byte words of xs that
// hold a valid pair (issued, not waited for).
__device__ __forceinline__ void pair_xs(const int* __restrict__ xs,
                                        long long n, long long base,
                                        const Vec16 (&v)[kPairVecs],
                                        unsigned (&m)[kPairVecs],
                                        int (&cnt)[kPairVecs],
                                        Vec16 (&x)[kPairVecs][4]) {
#pragma unroll
  for (int q = 0; q < kPairVecs; ++q) {
    m[q] = lb::nonzero_bits(v[q].v);
    cnt[q] = __popc(m[q]);
    const long long i0 = base + q * kTileBytes + threadIdx.x * kPerThread;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (!((m[q] >> (4 * w)) & 0xfu)) continue;
      const long long j0 = i0 + 4 * w;
      if (j0 + 4 <= n) {
        x[q][w].v = *reinterpret_cast<const uint4*>(xs + j0);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) x[q][w].i[k] = (j0 + k < n) ? xs[j0 + k] : 0;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kPairMinBlocks)
pair_lookback_kernel(const int* __restrict__ xs,
                     const uint8_t* __restrict__ vals, long long n,
                     unsigned long long* scratch, int* __restrict__ xs_out,
                     uint8_t* __restrict__ vals_out,
                     int* __restrict__ pos_out) {
  constexpr int V = kPairVecs;
  extern __shared__ __align__(16) uint8_t smem[];
  int* s_xs = reinterpret_cast<int*>(smem);
  uint8_t* s_vals = smem + 4 * kPairTile;
  __shared__ unsigned s_warp[(V + 1) / 2 * kWarps];
  __shared__ long long s_off, s_next[2];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const lb::Scratch sc = lb::scratch_at(scratch);
  const long long tiles = (n + kPairTile - 1) / kPairTile;

  if (t == 0) s_next[0] = atomicAdd(sc.ticket, 1u);
  __syncthreads();
  long long tile = s_next[0];
  Vec16 v[V];
  unsigned m[V];
  int cnt[V];
  Vec16 x[V][4];
  if (tile < tiles) pair_load(vals, n, tile * kPairTile, v);
  // s_next alternates between two words, as in K1's flat_lookback_kernel
  for (int it = 1; tile < tiles; it ^= 1) {
    const long long base = tile * kPairTile;
    // xs at the valid pairs: in flight through the block scan and the
    // look-back
    pair_xs(xs, n, base, v, m, cnt, x);
    if (t == 0) s_next[it] = atomicAdd(sc.ticket, 1u);
    int rank[V], total;
    lb::tile_ranks<V>(cnt, s_warp, rank, total);
    if (t == 0) lb::publish_count(sc.status, tile, total);
    // the next tile's vals fly while this one looks back, is staged and
    // goes out
    const long long next = s_next[it];
    Vec16 vn[V];
    if (next < tiles) pair_load(vals, n, next * kPairTile, vn);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      int r = rank[q];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((m[q] >> (4 * w + k)) & 1u) {
            s_xs[r] = x[q][w].i[k];
            s_vals[r] = v[q].b[4 * w + k];
            ++r;
          }
        }
      }
    }
    // warp 0 looks back once it has staged: by then the predecessors have
    // mostly published, and it spins little
    if (t < 32) {
      const long long off = lb::tile_offset(sc.status, tile, total);
      if (t == 0) {
        s_off = off;
        if (tile == tiles - 1) *pos_out = (int)(off + total);
      }
    }
    __syncthreads();
    const long long off = s_off;
    for (int j = t; j < total; j += kThreads) {
      xs_out[off + j] = s_xs[j];
      vals_out[off + j] = s_vals[j];
    }
    long long lo, hi;
    lb::tail_band(base, base + kPairTile < n ? base + kPairTile : n, off,
                  total, n, n, lo, hi);
    lb::zero_fill(xs_out, lo, hi);
    lb::zero_fill(vals_out, lo, hi);
    // No barrier before the next tile (as in K1's flat_lookback_kernel).
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = vn[q];
    tile = next;
  }
  lb::release_scratch(sc, tiles, &s_last);
}

__global__ void __launch_bounds__(kThreads)
vals_compact_kernel(const uint8_t* __restrict__ vals, long long n,
                    int tiles_per_block, const int* __restrict__ counts,
                    int grid, uint8_t* __restrict__ vals_out,
                    int* __restrict__ pos_out) {
  __shared__ uint8_t s_vals[kTileBytes];
  __shared__ int s_warp[kWarps];
  __shared__ long long s_red[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // this block's output offset (counts of the blocks before it) and pos
  long long before = 0, total = 0;
  for (int j = threadIdx.x; j < grid; j += kThreads) {
    long long cj = counts[j];
    total += cj;
    if (j < (int)blockIdx.x) before += cj;
  }
  before = warp_sum(before);
  total = warp_sum(total);
  if (lane == 0) {
    s_red[0][warp] = before;
    s_red[1][warp] = total;
  }
  __syncthreads();
  before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += s_red[0][w];
    total += s_red[1][w];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *pos_out = (int)total;

  const long long span = (long long)tiles_per_block * kTileBytes;
  const long long base = (long long)blockIdx.x * span;
  long long off = before;
  for (int t = 0; t < tiles_per_block; ++t) {
    const long long i0 = base + (long long)t * kTileBytes + threadIdx.x * kPerThread;
    Vec16 v;
    const unsigned m = i0 < n ? valid_mask(vals, i0, n, v) : 0u;
    const int cnt = __popc(m);

    // rank within the tile: warp inclusive scan, then the warp totals
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int wpre = 0, tile_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      int x = s_warp[w];
      if (w < warp) wpre += x;
      tile_total += x;
    }
    int r = wpre + incl - cnt;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if ((m >> k) & 1u) s_vals[r++] = v.b[k];
    __syncthreads();

    // coalesced write-out of the tile's vals at off + rank
    for (int q = threadIdx.x; q < tile_total; q += kThreads)
      vals_out[off + q] = s_vals[q];
    off += tile_total;
    // No barrier needed before the next tile (as in compact_kernel).
  }

  // zero fill of this block's slots [base, base + span) past pos: bytes up
  // to a 16-byte boundary, then 16-byte stores, then the bytes after them
  const long long z0 = total > base ? total : base;
  const long long z1 = n < base + span ? n : base + span;
  if (z0 >= z1) return;
  long long a = (z0 + 15) & ~15LL, b = z1 & ~15LL;
  if (a > b) a = b = z1;
  for (long long o = z0 + threadIdx.x; o < a; o += kThreads) vals_out[o] = 0;
  for (long long o = a + 16LL * threadIdx.x; o < b; o += 16LL * kThreads)
    *reinterpret_cast<uint4*>(vals_out + o) = make_uint4(0, 0, 0, 0);
  for (long long o = b + threadIdx.x; o < z1; o += kThreads) vals_out[o] = 0;
}

}  // namespace

extern "C" {

// K2's persistent grid on `device` (blocks per SM at its shared memory,
// times the SM count); sets the attribute that admits its dynamic shared
// memory there.
int cvs_pair_blocks(int device, int* blocks) {
  return (int)lb::persistent_blocks(device, pair_lookback_kernel, kPairSmem,
                                    blocks);
}

int cvs_pair_tile(void) { return kPairTile; }

// Launch K2 on `stream`: ONE kernel, grid blocks (at most cvs_pair_blocks'
// count, after that call on this device). `scratch` holds 2 + ceil(n /
// cvs_pair_tile()) zeroed 8-byte words that no launch on another stream
// uses (see csrc/lookback.cuh); the launch leaves them zero. xs, vals,
// xs_out and vals_out have n entries and are 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success).
int cvs_pair_compact(int device, const int* xs, const uint8_t* vals,
                     long long n, int grid, unsigned long long* scratch,
                     int* xs_out, uint8_t* vals_out, int* pos_out,
                     cudaStream_t stream) {
  if (n < 1 || grid < 1 || ((uintptr_t)xs & 15) || ((uintptr_t)vals & 15)
      || ((uintptr_t)xs_out & 15) || ((uintptr_t)vals_out & 15))
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  pair_lookback_kernel<<<grid, kThreads, kPairSmem, stream>>>(
      xs, vals, n, scratch, xs_out, vals_out, pos_out);
  return (int)cudaGetLastError();
}

// Launch K3 on `stream`: count_kernel, then vals_compact_kernel. `counts`
// is scratch of `grid` ints; the caller picks tiles_per_block and grid so
// that grid * tiles_per_block * 4096 >= n. vals_out has n bytes and is
// 16-byte aligned. Returns the cudaError_t of the launches (0 on success).
int cvs_vals_compact(int device, const uint8_t* vals, long long n,
                     int tiles_per_block, int grid, int* counts,
                     uint8_t* vals_out, int* pos_out, cudaStream_t stream) {
  if ((uintptr_t)vals_out & 15) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  count_kernel<<<grid, kThreads, 0, stream>>>(vals, n, tiles_per_block,
                                               counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  vals_compact_kernel<<<grid, kThreads, 0, stream>>>(
      vals, n, tiles_per_block, counts, grid, vals_out, pos_out);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_tile_bytes(void) { return kTileBytes; }

}  // extern "C"
