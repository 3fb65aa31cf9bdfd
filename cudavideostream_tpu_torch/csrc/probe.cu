// K7 on Hopper: the compare probe. For each tile of an (M, 128) int32
// grid, the sum over its values g and the 256 bins b of (g == b): 256
// compares and adds per value, then one int32 per tile. For gray values
// every value matches one bin, so each checksum is the tile's element
// count; values outside [0, 255] add nothing.
//
// Replaces the TPU kernel cudavideostream_tpu/ops/hist_pallas.py:
// _probe_kernel (launched by vpu_probe, hist_pallas.py:118), the probe of
// benchmarks/binarize_pallas_ab: the intended compute floor of a
// compare-based 256-bin histogram. The compares ARE the work: a kernel
// that computed the checksum some cheaper way would no longer be the
// probe. So the bin values come in as a kernel parameter (constant bank
// 0, a runtime value to the compiler): nvcc cannot fold sum_b (g == b)
// into one range test, as it could with literal bins. chip_smoke.py counts
// the ISETP instructions of probe_kernel in the SASS (cuobjdump) and fails
// below 256.
//
// Design: every SM an equal share of the values. The JAX tiles are too
// few to share out whole (45 at 1080p gray, 15 at 720p, 135 at 4K, on 132
// SMs), and a cluster of CTAs per tile cannot fix that: 15 tiles of at
// most 16 CTAs leave the busiest of 132 SMs 10% above the mean at best. So
// the tiles are flattened: one launch of `slices` CTAs of 1,024 threads, a
// whole number of kCtasPerSm x the SMs (264 at most frames: two an SM,
// all resident at once), and at least the tile count, each CTA an equal
// slice of the 16-byte vectors, [c V / slices, (c + 1) V / slices). A
// slice is no longer than a tile, so it touches at most two: each thread
// keeps one accumulator per value of its vector across the 256 unrolled
// compare-and-adds, adds the vector's count to the partial sum of the
// tile it lies in, and the CTA reduces its two partials and stores them.
// Each compare-and-add is written in PTX, a setp and a predicated add: one
// ISETP and one predicated VIADD (or IADD3) a value and bin in the SASS,
// where `acc += (v == bin)` compiled to 3.6 instructions (predicated moves
// and SELs around each add).
// The CTA that finds every other one done (a count in a per-stream
// scratch word, zero between launches) adds each tile's partials into its
// one store in out and puts the count back to zero: no memset, no atomics
// into out, one kernel a call. The TPU kernel's `unroll` picks its code
// shape only and is not taken here.
//
// Bound. The one compute-bound kernel of the port: 2 integer operations
// (compare, add) per value and bin, 2,073,600 x 256 x 2 = 1,061,683,200
// at 1080p, over 132 SMs x 128 lanes (4 schedulers issuing one warp
// instruction per clock) at the SM clock: 0.0317 ms at 1.98 GHz. Its
// bytes (8,294,400 read) bound it at 0.0025 ms.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 1024;
constexpr int kCtasPerSm = 2;  // registers capped to fit: one wave
constexpr unsigned kAll = 0xffffffffu;

struct Bins {
  int v[kBins];
};

struct Args {
  const int4* g;
  long long vecs;  // the grid's whole tiles, in 16-byte vectors
  int tile_vecs;
  int tiles;
  int slices;
  int* part;  // two partial sums per slice
  int* done;  // the per-stream count of finished slices, zero between calls
  int* out;
};

// the slice holding vector v: the largest c with c * vecs / slices <= v
__device__ __forceinline__ int slice_of(const Args& a, long long v) {
  return (int)(((v + 1) * a.slices - 1) / a.vecs);
}

__device__ __forceinline__ long long slice_start(const Args& a, int c) {
  return (long long)c * a.vecs / a.slices;
}

// acc += (v == bin): one compare and one predicated add
__device__ __forceinline__ void count_eq(int& acc, int v, int bin) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(acc) : "r"(v), "r"(bin));
}

// the sum of x over the CTA, in thread 0
__device__ __forceinline__ int block_sum(int x, int* s_warp) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kAll, x, d);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0;
  if (threadIdx.x < 32) {
    x = s_warp[threadIdx.x];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kAll, x, d);
  }
  __syncthreads();  // s_warp free again
  return x;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    probe_kernel(const Args a, const Bins bins) {
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_last;
  const int c = blockIdx.x;
  const long long v0 = slice_start(a, c), v1 = slice_start(a, c + 1);
  // the first tile the slice touches, and where the next one begins
  const long long t0 = v0 / a.tile_vecs;
  const long long split = min(v1, (t0 + 1) * a.tile_vecs);
  int head = 0, next = 0;  // the slice's partials of tiles t0 and t0 + 1
  for (long long q = v0 + threadIdx.x; q < v1; q += kThreads) {
    const int4 v = __ldg(a.g + q);
    int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      const int bin = bins.v[b];
      count_eq(a0, v.x, bin);
      count_eq(a1, v.y, bin);
      count_eq(a2, v.z, bin);
      count_eq(a3, v.w, bin);
    }
    const int s = a0 + a1 + a2 + a3;
    if (q < split) head += s;
    else next += s;
  }
  head = block_sum(head, s_warp);
  next = block_sum(next, s_warp);
  if (threadIdx.x == 0) {
    a.part[2 * c] = head;
    a.part[2 * c + 1] = next;
    // release this slice's partials; acquire every earlier slice's
    cuda::atomic_ref<int, cuda::thread_scope_device> done(*a.done);
    s_last = done.fetch_add(1, cuda::memory_order_acq_rel)
             == a.slices - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last slice done: each tile's partials, from the slices over it
  for (int t = threadIdx.x; t < a.tiles; t += kThreads) {
    const long long first = (long long)t * a.tile_vecs;
    const int ca = slice_of(a, first);
    const int cb = slice_of(a, first + a.tile_vecs - 1);
    int sum = 0;
    for (int k = ca; k <= cb; ++k)  // only ca may start in tile t - 1
      sum += __ldcg(a.part + 2 * k
                    + (slice_start(a, k) / a.tile_vecs == t ? 0 : 1));
    a.out[t] = sum;
  }
  if (threadIdx.x == 0) *a.done = 0;  // zero for the next launch
}

}  // namespace

extern "C" {

// Launch K7 on `stream`: `tiles` tiles of tile_elems int32 values (a
// multiple of 4; g is 16-byte aligned), one checksum each into out, over
// `slices` CTAs (at least `tiles`; ops/hist.py:probe_slices gives the
// plan: whole waves of kCtasPerSm CTAs an SM). part
// holds 2 * slices int32 (no initial value); done is one int32 that is
// zero, and is zero again when the launch ends. Returns the cudaError_t of
// the launch (0 on success).
int cvs_vpu_probe(int device, const int* g, int tile_elems, int tiles,
                  int slices, int* part, int* done, int* out,
                  cudaStream_t stream) {
  if (tile_elems <= 0 || tile_elems % 4 || tiles <= 0 || slices < tiles
      || ((uintptr_t)g & 15))
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Bins bins;
  for (int b = 0; b < kBins; ++b) bins.v[b] = b;
  const int tile_vecs = tile_elems / 4;
  const Args a = {reinterpret_cast<const int4*>(g),
                  (long long)tiles * tile_vecs, tile_vecs, tiles, slices,
                  part, done, out};
  probe_kernel<<<slices, kThreads, 0, stream>>>(a, bins);
  return (int)cudaGetLastError();
}

// The launch's shape on `device`: threads per CTA, the CTAs an SM is
// planned to hold, and the CTAs it can hold
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; below the plan, the
// slices would not run in one wave of equal shares).
int cvs_probe_plan(int device, int* threads, int* per_sm, int* resident) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  *threads = kThreads;
  *per_sm = kCtasPerSm;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, probe_kernel, kThreads, 0);
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_probe_bins(void) { return kBins; }

}  // extern "C"
