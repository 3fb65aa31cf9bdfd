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
// with the xs stream removed, on the same one-pass machinery
// (vals_lookback_kernel, csrc/lookback.cuh): a persistent grid
// (occupancy x SMs, cvs_vals_blocks) takes tiles of kValsTile bytes in
// ascending order from a ticket; per tile, each thread ranks its groups
// of 16 vals (loaded during the previous tile) in one block scan,
// publishes the tile's count, issues the next tile's loads, and stages
// the valid vals in rank order in shared memory; warp 0 looks back for
// the tile's offset, and the tile's vals go out coalesced at offset +
// rank, in 16-byte stores wherever the output's alignment allows (each
// store's 16 bytes funnel-shifted out of two aligned staging words:
// write_shifted), with the tile's band of the zero tail. A two-pass
// design (count every tile, then compact) reads vals twice and pays a
// second launch. With no xs stream, no load waits on another: one round
// trip a tile, as in K1's flat emission.
// A K3 tile reads one byte an entry where K1 flat reads two, so its tile
// is larger: kValsTile bytes, picked by timing (PERF.md, section 6).
// Bound: it reads n bytes and writes n bytes (plus pos): 12,451,844 B at
// 1080p's mask geometry (n = 6,225,920), 3.72 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

namespace lb = cvs_lookback;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTileBytes = kThreads * kPerThread;  // 4096 pairs

using Vec16 = lb::Vec16;

// ---- K2: one pass with decoupled look-back ------------------------------

// 16-pair groups per thread per tile, and the blocks an SM must hold (the
// register cap)
constexpr int kPairVecs = 2;
constexpr int kPairMinBlocks = 3;
constexpr int kPairTile = kTileBytes * kPairVecs;  // 8,192 pairs
// staging per slot: xs (int32) and vals (uint8)
constexpr size_t kPairSmem = 5 * (size_t)kPairTile;

// The vals of the thread's V groups of the tile at base (zeros past n).
template <int V>
__device__ __forceinline__ void vals_load(const uint8_t* __restrict__ vals,
                                          long long n, long long base,
                                          Vec16 (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V; ++q) {
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
  if (tile < tiles) vals_load<V>(vals, n, tile * kPairTile, v);
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
    if (next < tiles) vals_load<V>(vals, n, next * kPairTile, vn);
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

// ---- K3: one pass with decoupled look-back ------------------------------

// 16-byte groups per thread per tile
constexpr int kValsVecs = 4;
constexpr int kValsTile = kTileBytes * kValsVecs;  // 16,384 bytes
// staging, and one 16-byte word past it that write_shifted may read
constexpr size_t kValsSmem = (size_t)kValsTile + 16;

// Bytes [e, e + 16) of the 32 bytes lo:hi (0 <= e < 16, the same in every
// thread): four funnel shifts of the word pairs that hold them.
__device__ __forceinline__ uint4 shift_bytes(const uint4& lo, const uint4& hi,
                                             int e) {
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = e >> 2, sh = 8 * (e & 3);
  unsigned r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // w[q + i] and w[q + i + 1], with constant indices: selects, not a
    // local-memory array
    unsigned a = w[i], b = w[i + 1];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      if (q == k) {
        a = w[i + k];
        b = w[i + k + 1];
      }
    }
    r[i] = __funnelshift_r(a, b, sh);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// out[off, off + total) = s[0, total): the bytes up to out's first 16-byte
// boundary and after its last one one at a time, the words between them
// in 16-byte stores, each from two aligned 16-byte staging words (s is
// 16-byte aligned and readable 16 bytes past total); the block's threads
// stride the words.
__device__ __forceinline__ void write_shifted(const uint8_t* s, int total,
                                              uint8_t* __restrict__ out,
                                              long long off) {
  const long long end = off + total;
  long long a = (off + 15) & ~15LL, b = end & ~15LL;
  if (a > b) a = b = end;  // inside one word: all of it in the head
  for (long long o = off + threadIdx.x; o < a; o += kThreads) out[o] = s[o - off];
  for (long long o = b + threadIdx.x; o < end; o += kThreads)
    out[o] = s[o - off];
  const uint4* s4 = reinterpret_cast<const uint4*>(s);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int e = (int)((a - off) & 15);  // every word's staging offset, mod 16
  for (long long o = a + 16LL * threadIdx.x; o < b; o += 16LL * kThreads) {
    const int so = (int)(o - off) >> 4;
    o4[o >> 4] = e ? shift_bytes(s4[so], s4[so + 1], e) : s4[so];
  }
}

__global__ void __launch_bounds__(kThreads)
vals_lookback_kernel(const uint8_t* __restrict__ vals, long long n,
                     unsigned long long* scratch,
                     uint8_t* __restrict__ vals_out,
                     int* __restrict__ pos_out) {
  constexpr int V = kValsVecs;
  extern __shared__ __align__(16) uint8_t s_vals[];
  __shared__ unsigned s_warp[(V + 1) / 2 * kWarps];
  __shared__ long long s_off, s_next[2];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const lb::Scratch sc = lb::scratch_at(scratch);
  const long long tiles = (n + kValsTile - 1) / kValsTile;

  if (t == 0) s_next[0] = atomicAdd(sc.ticket, 1u);
  __syncthreads();
  long long tile = s_next[0];
  Vec16 v[V];
  if (tile < tiles) vals_load<V>(vals, n, tile * kValsTile, v);
  // s_next alternates between two words, as in K1's flat_lookback_kernel
  for (int it = 1; tile < tiles; it ^= 1) {
    const long long base = tile * kValsTile;
    unsigned m[V];
    int cnt[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      m[q] = lb::nonzero_bits(v[q].v);
      cnt[q] = __popc(m[q]);
    }
    if (t == 0) s_next[it] = atomicAdd(sc.ticket, 1u);
    int rank[V], total;
    lb::tile_ranks<V>(cnt, s_warp, rank, total);
    if (t == 0) lb::publish_count(sc.status, tile, total);
    // the next tile's vals fly while this one looks back, is staged and
    // goes out
    const long long next = s_next[it];
    Vec16 vn[V];
    if (next < tiles) vals_load<V>(vals, n, next * kValsTile, vn);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      int r = rank[q];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if ((m[q] >> k) & 1u) s_vals[r++] = v[q].b[k];
    }
    // warp 0 looks back once it has staged (as in K1's flat_lookback_kernel)
    if (t < 32) {
      const long long off = lb::tile_offset(sc.status, tile, total);
      if (t == 0) {
        s_off = off;
        if (tile == tiles - 1) *pos_out = (int)(off + total);
      }
    }
    __syncthreads();
    const long long off = s_off;
    write_shifted(s_vals, total, vals_out, off);
    long long lo, hi;
    lb::tail_band(base, base + kValsTile < n ? base + kValsTile : n, off,
                  total, n, n, lo, hi);
    lb::zero_fill(vals_out, lo, hi);
    // No barrier before the next tile (as in K1's flat_lookback_kernel).
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = vn[q];
    tile = next;
  }
  lb::release_scratch(sc, tiles, &s_last);
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

// K3's persistent grid on `device`, as cvs_pair_blocks.
int cvs_vals_blocks(int device, int* blocks) {
  return (int)lb::persistent_blocks(device, vals_lookback_kernel, kValsSmem,
                                    blocks);
}

int cvs_vals_tile(void) { return kValsTile; }

// Launch K3 on `stream`: ONE kernel, grid blocks (at most cvs_vals_blocks'
// count, after that call on this device). `scratch` holds 2 + ceil(n /
// cvs_vals_tile()) zeroed 8-byte words that no launch on another stream
// uses (see csrc/lookback.cuh); the launch leaves them zero. vals and
// vals_out have n bytes and are 16-byte aligned. Returns the cudaError_t
// of the launch (0 on success).
int cvs_vals_compact(int device, const uint8_t* vals, long long n, int grid,
                     unsigned long long* scratch, uint8_t* vals_out,
                     int* pos_out, cudaStream_t stream) {
  if (n < 1 || grid < 1 || ((uintptr_t)vals & 15)
      || ((uintptr_t)vals_out & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  vals_lookback_kernel<<<grid, kThreads, kValsSmem, stream>>>(
      vals, n, scratch, vals_out, pos_out);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_tile_bytes(void) { return kTileBytes; }

}  // extern "C"
