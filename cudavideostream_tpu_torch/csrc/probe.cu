// K7 on Hopper: the compare probe. For each tile of an (M, 128) int32
// grid, the sum over its values g and the 256 bins b of (g == b): 256
// compares and adds per value into an accumulator, then one int32 per
// tile. For gray values every value matches one bin, so each checksum is
// the tile's element count; values outside [0, 255] add nothing.
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
// Design. One block of 1,024 threads per JAX tile (hist_pallas._tile: 360
// rows, 46,080 values, 45 tiles at 1080p gray); each thread reads 16
// bytes (4 values) at a time and keeps one register accumulator per value
// across the 256 unrolled compare-and-adds; a warp-shuffle and
// shared-memory reduction gives the block's one store. The TPU kernel's
// `unroll` picks its code shape only and is not taken here.
//
// Bound. The one compute-bound kernel of the port: 2 integer operations
// (compare, add) per value and bin, 2,073,600 x 256 x 2 = 1,061,683,200
// at 1080p, one ISETP and one IADD each in the SASS, over 132 SMs x 128
// lanes (4 schedulers issuing one warp instruction per clock; this
// kernel outruns the data sheet's 64 INT32 lanes per SM) at the SM
// clock: 0.0317 ms at 1.98 GHz. Its bytes (8,294,400 read) bound it at
// 0.0025 ms. With one block per JAX tile only 45 of the 132 SMs work, so
// this design sits near 132 / 45 times the bound at best.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;

struct Bins {
  int v[kBins];
};

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int* __restrict__ g, int tile_elems, const Bins bins,
             int* __restrict__ out) {
  __shared__ int s_warp[kThreads / 32];
  const int4* t =
      reinterpret_cast<const int4*>(g + (long long)blockIdx.x * tile_elems);
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int q = threadIdx.x; q < tile_elems / 4; q += kThreads) {
    const int4 v = __ldg(t + q);
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      const int bin = bins.v[b];
      a0 += v.x == bin;
      a1 += v.y == bin;
      a2 += v.z == bin;
      a3 += v.w == bin;
    }
  }
  int acc = a0 + a1 + a2 + a3;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(kAll, acc, d);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = s_warp[threadIdx.x];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(kAll, acc, d);
    if (threadIdx.x == 0) out[blockIdx.x] = acc;
  }
}

}  // namespace

extern "C" {

// Launch K7 on `stream`: grid tiles of tile_elems int32 values (a multiple
// of 4; g is 16-byte aligned), one checksum each into out. Returns the
// cudaError_t of the launch (0 on success).
int cvs_vpu_probe(int device, const int* g, int tile_elems, int grid,
                  int* out, cudaStream_t stream) {
  if (tile_elems <= 0 || tile_elems % 4 || grid <= 0 || ((uintptr_t)g & 15))
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Bins bins;
  for (int b = 0; b < kBins; ++b) bins.v[b] = b;
  probe_kernel<<<grid, kThreads, 0, stream>>>(g, tile_elems, bins, out);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_probe_bins(void) { return kBins; }

}  // extern "C"
