// K8 on Hopper: the noise filter, a zero-padded KxK Q16 stencil per channel.
//
// Replaces no TPU kernel. The JAX package computes the noise filter outside
// Pallas (cudavideostream_tpu/ops/convolve.py:25 convolve_q16 and :41
// accumulate_q16, K^2 shifted int32 adds that XLA fuses). Its first port
// was the same chain of torch ops: an int32 copy of the frame, F.pad, a
// zeroed int32 accumulator and K^2 multiply-adds over shifted views, each a
// pass over a 24.9 MB int32 image at 1080p, 126-135x over the bound below
// on an H100. This kernel replaces that chain on every served path (solo,
// batched, row-sharded).
//
// What it computes, for output byte c of row r of the (rows, row_bytes)
// byte view of a BGR24 frame (row_bytes = 3 * width):
//   S   = sum_{i,j} w[i][j] * x[r + i + row_off][c + 3 * (j - p)],  p = K / 2
//   out = clamp(S >> 16, 0, 255)
// where x is zero outside its rows [0, src_rows) and bytes [0, row_bytes).
// A pixel's horizontal neighbour lies 3 bytes away, so channels never mix.
// row_off is -p for a whole frame (zero rows above and below it) and 0 for
// a row shard whose p halo rows above and below are already in place
// (parallel/halo_conv.py). S is the int32 of the plain version, which wraps
// on overflow: it is summed here in unsigned arithmetic (defined wrap) and
// shifted as a signed int (arithmetic shift, as torch and JAX shift), so
// taps that are signed or not normalized give the plain version's bytes.
// K is 1..15, odd or even (an even K's window is rows r-p .. r-p+K-1, as
// the plain version's p = K // 2 padding makes it).
//
// Design. One block of 256 threads makes an output tile of 32 rows x 256
// bytes. It stages the tile's input, 32 + K - 1 rows of 256 + 2 x 32 bytes
// (32 >= 3p for every K up to 15), in shared memory, zero outside the
// frame, with one 16-byte load a chunk wherever the chunk lies whole inside
// the row and its address is 16-byte aligned, else byte by byte. Then each
// thread owns one output column and walks the tile's 32 rows, summing the
// K^2 taps from shared memory. The taps come by value in the kernel's
// parameters (a struct of 225 int32), so each multiply reads its tap from
// the constant bank with a compile-time offset, and no weight is ever
// uploaded (nothing to upload inside a CUDA graph capture). B streams at a
// stride are one launch (gridDim.z), each reading only its own rows. There
// is no int32 image and no accumulator in device memory: the frame is read
// once (plus the halo rows of each tile) and the result written once.
//
// Bound at 1080p (6,220,800 B read, 6,220,800 B written): 0.00371 ms at
// 3.35 TB/s. In operations, K^2 int32 multiply-adds a byte at 64 IMAD a
// clock an SM on 132 SMs at 1,980 MHz: 0.00335 / 0.0093 / 0.0182 / 0.0301
// ms for K = 3 / 5 / 7 / 9. This simple kernel also spends a shared-memory
// byte load on every tap; keeping a column of loads in registers across
// the K rows that use it is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;      // one output column a thread
constexpr int kTileRows = 32;      // output rows of a tile
constexpr int kTileBytes = kThreads;  // output bytes of a tile row
constexpr int kHalo = 32;          // staged bytes each side (>= 3 * 7)
constexpr int kStageBytes = kTileBytes + 2 * kHalo;  // 320: 20 chunks
constexpr int kMaxK = 15;

struct Taps {
  int w[kMaxK * kMaxK];
};

template <int K>
__global__ void __launch_bounds__(kThreads)
    conv_kernel(const uint8_t* __restrict__ src, long long src_stride,
                int src_rows, int row_off, uint8_t* __restrict__ out,
                long long out_stride, int rows, int row_bytes,
                const Taps taps) {
  constexpr int kStageRows = kTileRows + K - 1;
  constexpr int p = K / 2;
  __shared__ __align__(16) uint8_t stage[kStageRows][kStageBytes];
  const int c0 = blockIdx.x * kTileBytes;
  const int r0 = blockIdx.y * kTileRows;
  const uint8_t* s = src + (long long)blockIdx.z * src_stride;
  uint8_t* o = out + (long long)blockIdx.z * out_stride;

  // stage the input: chunk q of staged row t holds bytes
  // [c0 - kHalo + 16q, +16) of input row r0 + row_off + t
  constexpr int kChunks = kStageBytes / 16;
  for (int idx = threadIdx.x; idx < kStageRows * kChunks; idx += kThreads) {
    const int t = idx / kChunks, q = idx % kChunks;
    const int gr = r0 + row_off + t;
    const int gc = c0 - kHalo + 16 * q;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gr >= 0 && gr < src_rows) {
      const uint8_t* a = s + (long long)gr * row_bytes + gc;
      if (gc >= 0 && gc + 16 <= row_bytes && ((uintptr_t)a & 15) == 0) {
        v = __ldg(reinterpret_cast<const uint4*>(a));
      } else {
        unsigned b[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (gc + k >= 0 && gc + k < row_bytes)
            b[k >> 2] |= (unsigned)__ldg(a + k) << (8 * (k & 3));
        v = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
    *reinterpret_cast<uint4*>(&stage[t][16 * q]) = v;
  }
  __syncthreads();

  const int c = c0 + threadIdx.x;
  if (c >= row_bytes) return;
  const int last = min(kTileRows, rows - r0);
  // output column c reads staged bytes kHalo + threadIdx.x + 3 (j - p)
  const uint8_t* col = &stage[0][kHalo + threadIdx.x - 3 * p];
#pragma unroll 1
  for (int t = 0; t < last; ++t) {
    unsigned acc = 0;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j)
        acc += (unsigned)taps.w[i * K + j]
               * (unsigned)col[(t + i) * kStageBytes + 3 * j];
    const int v = (int)acc >> 16;
    o[(long long)(r0 + t) * row_bytes + c] =
        (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

template <int K>
cudaError_t launch(const uint8_t* src, long long src_stride, int src_rows,
                   int row_off, uint8_t* out, long long out_stride, int rows,
                   int row_bytes, const Taps& taps, int streams,
                   cudaStream_t stream) {
  const dim3 grid((row_bytes + kTileBytes - 1) / kTileBytes,
                  (rows + kTileRows - 1) / kTileRows, streams);
  conv_kernel<K><<<grid, kThreads, 0, stream>>>(
      src, src_stride, src_rows, row_off, out, out_stride, rows, row_bytes,
      taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K8 on `stream`: for each of `streams` streams b, the rows x
// row_bytes output at out + b * out_stride from the src_rows x row_bytes
// input at src + b * src_stride, input row r + i + row_off for output row r
// and tap row i (row_off = -(k / 2) for a whole frame, 0 for a shard whose
// halo rows are in place). taps holds k * k int32 Q16 taps, row-major; they
// are copied into the launch's parameters. One kernel launch. Returns the
// cudaError_t of the launch (0 on success).
int cvs_convolve_q16(int device, const uint8_t* src, long long src_stride,
                     int src_rows, int row_off, uint8_t* out,
                     long long out_stride, int rows, int row_bytes,
                     const int* taps, int k, int streams,
                     cudaStream_t stream) {
  if (k < 1 || k > kMaxK || rows <= 0 || row_bytes <= 0 || src_rows <= 0
      || streams <= 0 || streams > 65535
      || (rows + kTileRows - 1) / kTileRows > 65535)
    return (int)cudaErrorInvalidValue;
  Taps t;
  memset(&t, 0, sizeof t);
  memcpy(t.w, taps, sizeof(int) * k * k);
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  switch (k) {
#define CVS_CONV_CASE(K)                                                  \
  case K:                                                                 \
    return (int)launch<K>(src, src_stride, src_rows, row_off, out,        \
                          out_stride, rows, row_bytes, t, streams, stream);
    CVS_CONV_CASE(1) CVS_CONV_CASE(2) CVS_CONV_CASE(3) CVS_CONV_CASE(4)
    CVS_CONV_CASE(5) CVS_CONV_CASE(6) CVS_CONV_CASE(7) CVS_CONV_CASE(8)
    CVS_CONV_CASE(9) CVS_CONV_CASE(10) CVS_CONV_CASE(11) CVS_CONV_CASE(12)
    CVS_CONV_CASE(13) CVS_CONV_CASE(14) CVS_CONV_CASE(15)
#undef CVS_CONV_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_conv_threads(void) { return kThreads; }

int cvs_conv_tile_rows(void) { return kTileRows; }

int cvs_conv_halo_bytes(void) { return kHalo; }

int cvs_conv_max_k(void) { return kMaxK; }

}  // extern "C"
