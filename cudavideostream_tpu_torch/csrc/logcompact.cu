// K1 on Hopper: fused threshold diff + negative feedback + stable
// (ascending) stream compaction, flat emission.
//
// Replaces the TPU kernel cudavideostream_tpu/ops/logcompact.py:_kernel_v2
// (dispatched by _run_kernel, called from fused_diff_compact) together with
// the XLA tile merge _merge_tiles_impl that follows it on the flat path.
//
// What it computes, for every byte i of an n-byte frame, with
// c = i < region_len ? region[i] : cur[i] and p = prev[i]:
//   * byte i ships iff |c - p| > thr, computed in int (never in uint8);
//   * xs[k] / vals[k] hold the k-th shipped index / (c - p) & 255, in
//     ascending index order; pos (the count) goes to *pos_out;
//   * xs and vals are zero from pos to cap (the length of both buffers);
//     a frame that ships more than cap bytes writes only the first cap
//     entries, and the caller sees pos > cap;
//   * new_prev = shipped ? c : p under negative feedback, else c. It is
//     written into prev IN PLACE (the counterpart of the JAX buffer
//     donation); each byte of prev is read and written by the same thread
//     of the second kernel only, after the first kernel's last read.
//
// Design. The TPU kernel's tile geometry, MXU prefix sums and shift passes
// exist for Mosaic; flat output is a global stable compaction and does not
// depend on them. Here:
//   1. count_kernel: each block counts the shipped bytes of its span of
//      tiles_per_block tiles of 4096 bytes (256 threads x 16-byte loads);
//   2. compact_kernel: each block sums the counts of the blocks before it
//      (its output offset) and of all blocks (pos) — a few hundred ints
//      from L2 — then, tile by tile, recomputes the mask, ranks the
//      shipped bytes with a warp shuffle scan plus a scan of the 8 warp
//      totals, stages (index, value) in shared memory in rank order and
//      writes them out coalesced at offset + rank. It writes new_prev and
//      zero-fills its share of the slots [pos, cap).
// No atomics: the order is ascending by construction.
//
// Bound. On an H100 the function is bound by device-memory bytes: it
// reads prev and cur (2n; the region stands in for the first region_len
// bytes of cur, which are never loaded) and writes new_prev (n), xs
// (4 * cap) and vals
// (cap), all full length because of the zero fill: about 8n at
// cap = n, 49.8 MB at 1080p (n = 6,220,800), or about 15 us at 3.35 TB/s.
// The second pass rereads cur and prev (another 2n, mostly from the
// 50 MB L2 at this size), which this simple two-pass design accepts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerThread = 16;
constexpr int kTileBytes = kThreads * kBytesPerThread;  // 4096
constexpr unsigned kFull = 0xffffffffu;

union Vec16 {
  uint4 v;
  uint8_t b[16];
};

// Bytes [i0, i0 + 16) of src; bytes at or past lim read as 0.
__device__ __forceinline__ Vec16 load16(const uint8_t* __restrict__ src,
                                        long long i0, long long lim) {
  Vec16 r;
  if (i0 + 16 <= lim) {
    r.v = *reinterpret_cast<const uint4*>(src + i0);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) r.b[k] = (i0 + k < lim) ? src[i0 + k] : 0;
  }
  return r;
}

// The 16-bit ship mask of the group of 16 bytes at i0 (bit k = byte
// i0 + k), with the current bytes (region-substituted) in c and the
// previous bytes in p. Bytes past n never ship.
__device__ __forceinline__ unsigned group_mask(
    const uint8_t* __restrict__ cur, const uint8_t* prev,
    const uint8_t* __restrict__ region, long long region_len, long long n,
    int thr, long long i0, Vec16& c, Vec16& p) {
  if (i0 >= n) {
    c.v = make_uint4(0, 0, 0, 0);
    p.v = c.v;
    return 0;
  }
  p = load16(prev, i0, n);
  if (i0 + 16 <= region_len) {
    c = load16(region, i0, region_len);
  } else if (i0 >= region_len) {
    c = load16(cur, i0, n);
  } else {  // the group straddles the end of the overlay region
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      long long i = i0 + k;
      c.b[k] = i < region_len ? region[i] : (i < n ? cur[i] : 0);
    }
  }
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    int d = int(c.b[k]) - int(p.b[k]);
    if ((d < 0 ? -d : d) > thr) m |= 1u << k;
  }
  return m;  // c == p == 0 past n, so those bytes never ship
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev,
             const uint8_t* __restrict__ region, long long region_len,
             long long n, int thr, int tiles_per_block,
             int* __restrict__ counts) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * tiles_per_block * kTileBytes;
  int cnt = 0;
  for (int t = 0; t < tiles_per_block; ++t) {
    long long i0 = base + (long long)t * kTileBytes + threadIdx.x * kBytesPerThread;
    Vec16 c, p;
    cnt += __popc(group_mask(cur, prev, region, region_len, n, thr, i0, c, p));
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
compact_kernel(const uint8_t* __restrict__ cur, uint8_t* prev,
               const uint8_t* __restrict__ region, long long region_len,
               long long n, int thr, int negfeed, int tiles_per_block,
               const int* __restrict__ counts, int grid,
               int* __restrict__ xs, uint8_t* __restrict__ vals,
               long long cap, int* __restrict__ pos_out) {
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
    const long long i0 = base + (long long)t * kTileBytes + threadIdx.x * kBytesPerThread;
    Vec16 c, p;
    const unsigned m = group_mask(cur, prev, region, region_len, n, thr, i0, c, p);
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
      int v = s_warp[w];
      if (w < warp) wpre += v;
      tile_total += v;
    }
    int r = wpre + incl - cnt;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if ((m >> k) & 1u) {
        s_xs[r] = (int)(i0 + k);
        s_vals[r] = (uint8_t)(c.b[k] - p.b[k]);  // (c - p) mod 256
        ++r;
      }
    }

    // new_prev, in place: these 16 bytes of prev were read above by this
    // thread and are read by no other thread of this kernel
    if (i0 < n) {
      Vec16 np;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        np.b[k] = (!negfeed || ((m >> k) & 1u)) ? c.b[k] : p.b[k];
      if (i0 + 16 <= n) {
        *reinterpret_cast<uint4*>(prev + i0) = np.v;
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (i0 + k < n) prev[i0 + k] = np.b[k];
      }
    }
    __syncthreads();

    // coalesced write-out of the tile's entries at off + rank
    for (int q = threadIdx.x; q < tile_total; q += kThreads) {
      long long o = off + q;
      if (o < cap) {
        xs[o] = s_xs[q];
        vals[o] = s_vals[q];
      }
    }
    off += tile_total;
    // No barrier needed before the next tile: its writes to s_warp come
    // after every read of s_warp (which precede the barrier above), and
    // its writes to s_xs/s_vals come after its own first barrier, which
    // no thread passes before all have finished this write-out.
  }

  // zero fill: this block owns output slots [base, base + span)
  const long long z0 = total > base ? total : base;
  const long long z1 = cap < base + span ? cap : base + span;
  for (long long o = z0 + threadIdx.x; o < z1; o += kThreads) {
    xs[o] = 0;
    vals[o] = 0;
  }
}

}  // namespace

extern "C" {

// Launch K1 on `stream`. `counts` is scratch of `grid` ints; the caller
// picks tiles_per_block and grid so that grid * tiles_per_block * 4096
// >= n (which also covers every slot below cap <= n). Returns the
// cudaError_t of the launches (0 on success).
int cvs_fused_diff_compact(int device, const uint8_t* cur, uint8_t* prev,
                           const uint8_t* region, long long region_len,
                           long long n, int thr, int negfeed,
                           int tiles_per_block, int grid, int* counts,
                           int* xs, uint8_t* vals, long long cap,
                           int* pos_out, cudaStream_t stream) {
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  count_kernel<<<grid, kThreads, 0, stream>>>(
      cur, prev, region, region_len, n, thr, tiles_per_block, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_kernel<<<grid, kThreads, 0, stream>>>(
      cur, prev, region, region_len, n, thr, negfeed, tiles_per_block,
      counts, grid, xs, vals, cap, pos_out);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_tile_bytes(void) { return kTileBytes; }

}  // extern "C"
