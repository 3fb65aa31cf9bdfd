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
// sequential grid. Here the output is flat in one launch pair, the same
// design as K1's flat emission (csrc/logcompact.cu):
//   1. count_kernel: each block counts the valid pairs of its span of
//      tiles_per_block tiles of 4096 pairs (16-byte loads of vals);
//   2. compact_kernel: each block sums the counts of the blocks before it
//      (its offset) and of all blocks (pos), then tile by tile ranks the
//      valid pairs with a block scan, loads xs only for the 16-byte words
//      that hold a valid pair, stages (xs, vals) in shared memory in rank
//      order, writes them out coalesced at offset + rank, and zero-fills
//      its own share of the slots [pos, n).
// No atomics: the order is the input order by construction.
//
// Bound. Device-memory bytes: it reads vals (n) and, where a pair is
// valid, its xs (4 pos; a 16-byte word of xs is read only when it holds
// one), and writes xs_out and vals_out full length (5 n) plus pos. At
// 1080p and sub_rows = 1 (n = 6,221,824) with pos = 10% of n that is
// about 40 MB, 12 us at 3.35 TB/s; reading every xs would add 4 n
// (18.57 us for the whole function). The count pass rereads vals.
//
// K3 replaces the TPU kernel cudavideostream_tpu/ops/logcompact.py:_kernel_vals
// (launched by _vals_compact from _merge_vals_two_stage) together with
// the serial merge _merge_vals_impl, i.e. both branches of merge_vals:
// the merge of the bitmask-only emission's per-unit vals blocks, whose
// indices the landing rebuilds from the packed bits. It is K2 with the xs
// stream removed: count_kernel as above, then vals_compact_kernel, which
// ranks, stages and writes the valid vals and zero-fills [pos, n) in
// 16-byte stores. Bound: it reads n bytes and writes n bytes (plus pos):
// 12,451,844 B at 1080p's mask geometry (n = 6,225,920), 3.72 us at
// 3.35 TB/s. The count pass rereads vals, as in K2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTileBytes = kThreads * kPerThread;  // 4096 pairs
constexpr unsigned kFull = 0xffffffffu;

union Vec16 {
  uint4 v;
  uint8_t b[16];
};

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

__global__ void __launch_bounds__(kThreads)
compact_kernel(const int* __restrict__ xs, const uint8_t* __restrict__ vals,
               long long n, int tiles_per_block,
               const int* __restrict__ counts, int grid,
               int* __restrict__ xs_out, uint8_t* __restrict__ vals_out,
               int* __restrict__ pos_out) {
  __shared__ int s_xs[kTileBytes];
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
    // xs, read only for the 16-byte words that hold a valid pair
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned mq = (m >> (4 * q)) & 0xfu;
      if (!mq) continue;
      const long long j0 = i0 + 4 * q;
      int x[4];
      if (j0 + 4 <= n) {
        const int4 w4 = *reinterpret_cast<const int4*>(xs + j0);
        x[0] = w4.x; x[1] = w4.y; x[2] = w4.z; x[3] = w4.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) x[k] = (j0 + k < n) ? xs[j0 + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((mq >> k) & 1u) {
          s_xs[r] = x[k];
          s_vals[r] = v.b[4 * q + k];
          ++r;
        }
      }
    }
    __syncthreads();

    // coalesced write-out of the tile's pairs at off + rank
    for (int q = threadIdx.x; q < tile_total; q += kThreads) {
      xs_out[off + q] = s_xs[q];
      vals_out[off + q] = s_vals[q];
    }
    off += tile_total;
    // No barrier needed before the next tile: its writes to s_warp come
    // after every read of s_warp (which precede the barrier above), and
    // its writes to s_xs/s_vals come after its own first barrier, which
    // no thread passes before all have finished this write-out.
  }

  // zero fill: this block owns output slots [base, base + span)
  const long long z0 = total > base ? total : base;
  const long long z1 = n < base + span ? n : base + span;
  for (long long o = z0 + threadIdx.x; o < z1; o += kThreads) {
    xs_out[o] = 0;
    vals_out[o] = 0;
  }
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

// Launch K2 on `stream`. `counts` is scratch of `grid` ints; the caller
// picks tiles_per_block and grid so that grid * tiles_per_block * 4096
// >= n. xs_out and vals_out have n entries. Returns the cudaError_t of
// the launches (0 on success).
int cvs_pair_compact(int device, const int* xs, const uint8_t* vals,
                     long long n, int tiles_per_block, int grid, int* counts,
                     int* xs_out, uint8_t* vals_out, int* pos_out,
                     cudaStream_t stream) {
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  count_kernel<<<grid, kThreads, 0, stream>>>(vals, n, tiles_per_block,
                                               counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_kernel<<<grid, kThreads, 0, stream>>>(
      xs, vals, n, tiles_per_block, counts, grid, xs_out, vals_out, pos_out);
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
