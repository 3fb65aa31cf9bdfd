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
// kernels.cu:152-174), cut to one launch and few global atomics:
//   * at most one block of 1,024 threads per SM: at 1080p each thread
//     reads one 16-byte vector, which it loads before anything else (the
//     zeroing of the block's shared bins waits behind the load, not the
//     load behind it);
//   * each warp keeps its own 256 bins in shared memory, so that a burst
//     of one value (a flat region, a uniform frame) piles onto 32
//     counters per block and not one; a 16-byte vector of one value is
//     added once, as 16, and a 32-bit word of four equal bytes once, as 4;
//   * the block sums its warps' bins and adds the 256 sums to a 256-word
//     scratch of the launching stream (ops/hist.py:hist_scratch) with one
//     global atomic each: at 1080p 127 blocks x 256, 127 deep on a word;
//   * the last block to finish, which learns it from a done counter that
//     each block adds to with release-acquire ordering (cheaper than a
//     full fence on each side), swaps the 256 sums out of the scratch into
//     `out` and resets the counter: the scratch is zero between launches,
//     so nothing is zeroed in front of the kernel and a call is one
//     launch.
// The atomics are integer adds, which commute: the counts are the same
// whatever order the blocks run or finish in. That is unlike the atomic
// APPENDS of the reference's compaction (atomicInc, kernels.cu:313-315),
// whose output ORDER changes from run to run; nothing here is ordered.
//
// Bound. Device-memory bytes: n read, 1,024 written, 2,074,624 B at 1080p,
// 0.62 us at 3.35 TB/s. At that size the time goes to the launch, one
// load's latency, the shared-memory atomics and the chain of the merge
// (the blocks' atomics, the fence, the done count, the last block's
// swap), not to bytes: on an H100 80GB HBM3 at 700 W a 1080p call takes
// 0.0077-0.0081 ms between CUDA events (tools/time_k1_flat.py hist; about
// 0.005 ms of it an empty launch's). Full fences around the done count,
// plain stores of each block's sums reduced by the last block, a cluster
// of 4 CTAs merging through distributed shared memory, 512-thread blocks,
// two vectors a thread and sums strided over 8 or 32 words each were
// slower there.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kParts = kThreads / kBins;  // threads summing one bin
constexpr int kScratchWords = kBins + 1;  // the sums, then the done count
static_assert(kWarps % kParts == 0, "each thread sums whole warps");

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

__device__ __forceinline__ void add_vector(unsigned* bins, uint4 w) {
  if (w.x == w.y && w.x == w.z && w.x == w.w
      && w.x == (w.x & 255u) * 0x01010101u) {  // sixteen equal bytes
    atomicAdd(bins + (w.x & 255u), 16u);
    return;
  }
  add_word(bins, w.x);
  add_word(bins, w.y);
  add_word(bins, w.z);
  add_word(bins, w.w);
}

__global__ void __launch_bounds__(kThreads)
    hist_kernel(const uint8_t* __restrict__ g, long long n,
                unsigned* __restrict__ scratch, int* __restrict__ out) {
  __shared__ unsigned sub[kWarps][kBins];  // 32 KB: one histogram per warp
  __shared__ int s_last;
  const long long n16 = n >> 4;  // whole 16-byte vectors
  const uint4* v = reinterpret_cast<const uint4*>(g);
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the loads first: this thread's first vector, and in block 0 the
  // ragged tail of fewer than 16 bytes, one byte to each of its threads
  const bool first = i < n16;
  const uint4 w0 = first ? __ldg(v + i) : make_uint4(0, 0, 0, 0);
  const long long t = (n16 << 4) + threadIdx.x;
  const int tail = blockIdx.x == 0 && t < n ? (int)__ldg(g + t) : -1;

  uint4* s4 = reinterpret_cast<uint4*>(&sub[0][0]);
  for (int j = threadIdx.x; j < kWarps * kBins / 4; j += kThreads)
    s4[j] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  unsigned* bins = sub[threadIdx.x >> 5];
  if (first) add_vector(bins, w0);
  for (i += stride; i < n16; i += stride) add_vector(bins, __ldg(v + i));
  if (tail >= 0) atomicAdd(bins + tail, 1u);
  __syncthreads();

  // the block's sums: kParts threads per bin, each over kWarps / kParts
  // warps, then one thread per bin over the parts
  const int b = threadIdx.x % kBins, part = threadIdx.x / kBins;
  unsigned s = 0;
#pragma unroll
  for (int w = 0; w < kWarps / kParts; ++w)
    s += sub[part * (kWarps / kParts) + w][b];
  __syncthreads();
  sub[part][b] = s;
  __syncthreads();
  if (threadIdx.x < kBins) {
    s = 0;
#pragma unroll
    for (int p = 0; p < kParts; ++p) s += sub[p][b];
    if (s) atomicAdd(scratch + b, s);
  }

  // the last block to finish moves the sums to `out` and leaves the
  // scratch zero for the next launch on this stream
  __syncthreads();
  if (threadIdx.x == 0) {
    // release: the block's sums (ordered before by the barrier) reach the
    // scratch before its count; acquire, in the last block: every other
    // block's sums are there before it swaps them out
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> done(
        scratch[kBins]);
    s_last = done.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    if (threadIdx.x < kBins) out[b] = (int)atomicExch(scratch + b, 0u);
    if (threadIdx.x == 0) scratch[kBins] = 0;
  }
}

}  // namespace

extern "C" {

// Launch K4 on `stream`: count the n bytes of g into out[0..256), in one
// kernel launch of `grid` blocks (ops/hist.py:hist_plan: at most one per
// SM, none without a vector to read). g is 16-byte aligned; 0 < n < 2^31.
// scratch holds cvs_hist_scratch_words() words, zero before the launch
// and zero after it; launches that may overlap (other streams) each need
// their own. Returns the cudaError_t of the launch (0 on success).
int cvs_histogram(int device, const uint8_t* g, long long n, int grid,
                  unsigned* scratch, int* out, cudaStream_t stream) {
  if (((uintptr_t)g & 15) || n <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  hist_kernel<<<grid, kThreads, 0, stream>>>(g, n, scratch, out);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_hist_bins(void) { return kBins; }

int cvs_hist_threads(void) { return kThreads; }

int cvs_hist_scratch_words(void) { return kScratchWords; }

}  // extern "C"
