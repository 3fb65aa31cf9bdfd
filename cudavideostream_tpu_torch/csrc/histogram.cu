// K4 on Hopper: the exact 256-bin histogram of gray values.
//
// Replaces the TPU kernel cudavideostream_tpu/ops/hist_pallas.py:_hist_kernel
// (launched by pallas_histogram, which filters.value_histogram routes every
// (M, 128) gray grid to on hardware: the binarize visualizer's histogram,
// once per frame under --visualizer 5).
//
// What it computes: out[b] = the number of i < n with g[i] == b, for the
// 256 bins b, as int32. The input is the port's per-pixel gray values,
// one uint8 per pixel (2,073,600 at 1080p); the TPU kernel reads them as
// an int32 (M, 128) grid, a layout choice that leaves the counts unchanged.
//
// The TPU kernel keeps the 256 counts in SMEM across its sequential grid
// and adds, per tile, 256 unrolled compare-and-reduce passes. Blocks here
// run in parallel and in no order, so the design is instead the
// reference's own privatized histogram (generate_histogram_v2,
// kernels.cu:152-174):
//   * each block keeps its bins in shared memory, one sub-histogram per
//     warp, so that a burst of one value (a flat region, a uniform frame)
//     piles onto 8 counters per block and not one;
//   * each thread reads 16 bytes at a time over a grid-stride loop and
//     adds each byte to its warp's bins with a shared-memory atomic; a
//     32-bit word of four equal bytes is added once, as 4;
//   * at the end thread b sums bin b over the block's warps and adds it
//     to the global bins with one atomic add; the wrapper's entry point
//     zeroes the global bins on the same stream first.
// The atomics are integer adds, which commute: the counts are the same
// whatever order the blocks run in. That is unlike the atomic APPENDS of
// the reference's compaction (atomicInc, kernels.cu:313-315), whose
// output ORDER changes from run to run; nothing here is ordered.
//
// Bound. Device-memory bytes: n read, 1,024 written, 2,074,624 B at 1080p,
// 0.62 us at 3.35 TB/s. At that size the time goes to the launch, the
// memset and the merge of one 1 KB partial per block, not to bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kBlocksPerSM = 4;
static_assert(kThreads == kBins, "thread b merges bin b");

__device__ __forceinline__ void add_word(unsigned* bins, unsigned x) {
  if (x == (x & 255u) * 0x01010101u) {  // four equal bytes
    atomicAdd(bins + (x & 255u), 4u);
    return;
  }
  atomicAdd(bins + (x & 255u), 1u);
  atomicAdd(bins + ((x >> 8) & 255u), 1u);
  atomicAdd(bins + ((x >> 16) & 255u), 1u);
  atomicAdd(bins + (x >> 24), 1u);
}

__global__ void __launch_bounds__(kThreads)
    hist_kernel(const uint8_t* __restrict__ g, long long n,
                int* __restrict__ out) {
  __shared__ unsigned sub[kWarps][kBins];  // 8 KB: one histogram per warp
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&sub[0][0])[i] = 0;
  __syncthreads();
  unsigned* bins = sub[threadIdx.x >> 5];
  const long long n16 = n >> 4;  // whole 16-byte vectors
  const uint4* v = reinterpret_cast<const uint4*>(g);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16;
       i += stride) {
    const uint4 w = __ldg(v + i);
    add_word(bins, w.x);
    add_word(bins, w.y);
    add_word(bins, w.z);
    add_word(bins, w.w);
  }
  // the ragged tail, fewer than 16 bytes: one each to block 0's threads
  if (blockIdx.x == 0) {
    const long long i = (n16 << 4) + threadIdx.x;
    if (i < n) atomicAdd(bins + g[i], 1u);
  }
  __syncthreads();
  unsigned s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sub[w][threadIdx.x];
  if (s) atomicAdd(out + threadIdx.x, (int)s);
}

}  // namespace

extern "C" {

// Launch K4 on `stream`: zero out[0..256), then count the n bytes of g
// into it. g is 16-byte aligned; n < 2^31. Returns the cudaError_t of the
// memset and the launch (0 on success).
int cvs_histogram(int device, const uint8_t* g, long long n, int* out,
                  cudaStream_t stream) {
  if ((uintptr_t)g & 15) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(out, 0, kBins * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const long long want = ((n >> 4) + kThreads - 1) / kThreads;
  long long grid = (long long)sms * kBlocksPerSM;
  if (want < grid) grid = want > 0 ? want : 1;
  hist_kernel<<<(int)grid, kThreads, 0, stream>>>(g, n, out);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_hist_bins(void) { return kBins; }

}  // extern "C"
