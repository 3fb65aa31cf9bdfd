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
// Design (the first version of this kernel read all K^2 taps of every
// output byte from shared memory with byte loads, 9 LDS.U8 a byte at
// K = 3):
// * A block of 128 threads makes a tile of 1,024 output bytes of a row by
//   tile_rows rows (the wrapper's plan, ops/convolve.py conv_plan, sizes
//   tile_rows so that one wave of about 4 blocks an SM covers the frame).
//   Each thread makes a strip of 8 consecutive output bytes of a row and
//   walks down the tile's rows with K partial sums of 8 bytes in
//   registers, one for each output row in flight. It reads each staged
//   input row once, as 8-byte words from shared memory (3 LDS.64 for 8
//   output bytes at K = 3), takes the 8 + 3(K - 1) bytes it needs out of
//   the words with byte permutes, and adds each, times its tap, to all K
//   partial sums it belongs to: input row q feeds output row q - K + 1 + t
//   with tap row K - 1 - t. The output row whose last input row that was
//   leaves the registers, clamped, as one 8-byte store.
// * The stage holds bands of 8 input rows, 1,024 bytes plus a halo of
//   3p rounded up to 16 bytes on each side, in a ring of 2 x 8 + K - 1
//   rows: while the block sums one band, the next band's rows are already
//   in flight as cp.async 16-byte copies (zero-filled past the row's end;
//   zeros stored outside the frame; byte loads only where a row does not
//   start 16-byte aligned, as on a frame whose row_bytes % 16 != 0).
// * The taps come by value in the kernel's parameters (a struct of 225
//   int32), so each multiply reads its tap from the constant bank, and no
//   weight is ever uploaded (nothing to upload inside a CUDA graph
//   capture). B streams at a stride are one launch (gridDim.z).
//
// Bound at 1080p (6,220,800 B read, 6,220,800 B written): 0.00371 ms at
// 3.35 TB/s. In operations, K^2 int32 multiply-adds a byte at 64 IMAD a
// clock an SM on 132 SMs at 1,980 MHz: 0.00335 / 0.0093 / 0.0182 / 0.0301
// ms for K = 3 / 5 / 7 / 9. The design spends one permute a distinct byte
// of a row and about 2 more ALU instructions an output byte beside the K^2
// IMAD, which run on the other pipe.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;                  // threads a block
constexpr int kStrip = 8;                      // output bytes a thread a row
constexpr int kTileBytes = kThreads * kStrip;  // output bytes of a tile row
constexpr int kBand = 8;                       // input rows staged at a time
constexpr int kMaxK = 15;

struct Taps {
  int w[kMaxK * kMaxK];
};

template <int K>
struct Geo {
  static constexpr int p = K / 2;
  // bytes a thread's window reaches past its strip on each side (>= 3p,
  // whole 8-byte words), and the stage's halo (>= 3p, whole 16-byte chunks)
  static constexpr int H = (3 * p + 7) / 8 * 8;
  static constexpr int Hs = (3 * p + 15) / 16 * 16;
  static constexpr int SW = kTileBytes + 2 * Hs;  // staged bytes a row
  static constexpr int NS = 2 * kBand + K - 1;    // staged rows (a ring)
  static constexpr int W = (kStrip + 2 * H) / 4;  // 32-bit words a window
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  // copies `bytes` (1..16) and zero-fills the rest of the 16
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte m of the window u, zero-extended (one PRMT)
template <int W>
__device__ __forceinline__ unsigned byte_at(const unsigned (&u)[W], int m) {
  return __byte_perm(u[m >> 2], 0u, 0x4440u | (unsigned)(m & 3));
}

// Stage input rows [q0, q1) of the block (input row gr0 + q of the
// stream), each into ring slot q % NS: chunk ch holds input bytes
// [c0 - Hs + 16 ch, +16) of its row, zero outside the frame.
template <int K>
__device__ __forceinline__ void stage_rows(uint8_t* stage, const uint8_t* s,
                                           int q0, int q1, int gr0,
                                           int src_rows, int c0,
                                           int row_bytes) {
  using G = Geo<K>;
  constexpr int kChunks = G::SW / 16;
  for (int idx = threadIdx.x; idx < (q1 - q0) * kChunks; idx += kThreads) {
    const int q = q0 + idx / kChunks, ch = idx % kChunks;
    uint8_t* dst = stage + (q % G::NS) * G::SW + 16 * ch;
    const int gr = gr0 + q;
    // gc is a multiple of 16 (c0 of 1,024 and Hs of 16): a chunk is wholly
    // left of the row or starts inside it
    const int gc = c0 - G::Hs + 16 * ch;
    if (gr < 0 || gr >= src_rows || gc < 0 || gc >= row_bytes) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint8_t* a = s + (long long)gr * row_bytes + gc;
    if (((uintptr_t)a & 15) == 0) {
      cp_async16(dst, a, min(16, row_bytes - gc));
    } else {
      unsigned b[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (gc + k < row_bytes)
          b[k >> 2] |= (unsigned)__ldg(a + k) << (8 * (k & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(b[0], b[1], b[2], b[3]);
    }
  }
}

// Take one input row (window u, block row q) into the K partial rows, the
// partial sums of output rows q - K + 1 .. q, and store output row
// q - K + 1 at dst when it is whole; then shift the partial rows down one.
// Input row q feeds output row q - K + 1 + t with tap row K - 1 - t.
// kEdge: a halo row (one of the first K - 1, or past the tile's rows),
// which feeds only the outputs inside the tile; the other rows take no
// test.
template <int K, bool kEdge>
__device__ __forceinline__ void take_row(unsigned (&acc)[K][kStrip],
                                         const unsigned (&u)[Geo<K>::W],
                                         int q, int nrows, const Taps& taps,
                                         uint8_t* dst, int row_bytes, int c) {
  using G = Geo<K>;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    if (kEdge && (q + t < K - 1 || q + t >= nrows + K - 1)) continue;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const unsigned w = (unsigned)taps.w[(K - 1 - t) * K + j];
#pragma unroll
      for (int v = 0; v < kStrip; ++v)
        acc[t][v] += w * byte_at(u, G::H - 3 * G::p + v + 3 * j);
    }
  }
  if (!kEdge || q >= K - 1) {
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int v = 0; v < kStrip; ++v) {
      // clamp(S >> 16, 0, 255) in one instruction (VIMNMX.RELU)
      const unsigned y =
          (unsigned)__vimin_s32_relu((int)acc[0][v] >> 16, 255);
      if (v < 4)
        lo |= y << (8 * v);
      else
        hi |= y << (8 * (v - 4));
    }
    if (c + kStrip <= row_bytes && ((uintptr_t)dst & 7) == 0) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
    } else {
#pragma unroll
      for (int v = 0; v < kStrip; ++v)
        if (c + v < row_bytes)
          dst[v] = (uint8_t)((v < 4 ? lo : hi) >> (8 * (v & 3)));
    }
  }
#pragma unroll
  for (int t = 0; t + 1 < K; ++t)
#pragma unroll
    for (int v = 0; v < kStrip; ++v) acc[t][v] = acc[t + 1][v];
#pragma unroll
  for (int v = 0; v < kStrip; ++v) acc[K - 1][v] = 0;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    conv_kernel(const uint8_t* __restrict__ src, long long src_stride,
                int src_rows, int row_off, uint8_t* __restrict__ out,
                long long out_stride, int rows, int row_bytes, int tile_rows,
                const Taps taps) {
  using G = Geo<K>;
  __shared__ __align__(16) uint8_t stage[G::NS * G::SW];
  const int c0 = blockIdx.x * kTileBytes;
  const int r0 = blockIdx.y * tile_rows;
  const int nrows = min(tile_rows, rows - r0);
  const uint8_t* s = src + (long long)blockIdx.z * src_stride;
  uint8_t* o = out + (long long)blockIdx.z * out_stride
               + (long long)r0 * row_bytes;
  const int gr0 = r0 + row_off;
  const int c = c0 + kStrip * threadIdx.x;
  const bool live = c < row_bytes;
  // this thread's window of a staged row: bytes [c - H, c + kStrip + H)
  const uint8_t* win = stage + G::Hs - G::H + kStrip * threadIdx.x;

  unsigned acc[K][kStrip];
#pragma unroll
  for (int t = 0; t < K; ++t)
#pragma unroll
    for (int v = 0; v < kStrip; ++v) acc[t][v] = 0;

  const int nbands = (nrows + kBand - 1) / kBand;
  stage_rows<K>(stage, s, 0, min(kBand, nrows) + K - 1, gr0, src_rows, c0,
                row_bytes);
  cp_async_commit();
  int q = 0, slot = 0;  // the next input row to take, and its ring slot
#pragma unroll 1
  for (int b = 0; b < nbands; ++b) {
    const int qend = min((b + 1) * kBand, nrows) + K - 1;
    if (b + 1 < nbands) {
      // the next band's rows load while this band is summed
      stage_rows<K>(stage, s, qend, min((b + 2) * kBand, nrows) + K - 1,
                    gr0, src_rows, c0, row_bytes);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
#pragma unroll 1
      for (; q < qend; ++q) {
        unsigned u[G::W];
        const uint2* wp = reinterpret_cast<const uint2*>(win + slot * G::SW);
#pragma unroll
        for (int m = 0; m < G::W / 2; ++m) {
          const uint2 x = wp[m];
          u[2 * m] = x.x, u[2 * m + 1] = x.y;
        }
        uint8_t* dst = o + (long long)(q - K + 1) * row_bytes + c;
        if (q < K - 1 || q >= nrows)
          take_row<K, true>(acc, u, q, nrows, taps, dst, row_bytes, c);
        else
          take_row<K, false>(acc, u, q, nrows, taps, dst, row_bytes, c);
        slot = slot + 1 == G::NS ? 0 : slot + 1;
      }
    }
    q = qend;
    // the band's slots are refilled by the copies issued next
    __syncthreads();
  }
}

template <int K>
cudaError_t launch(const uint8_t* src, long long src_stride, int src_rows,
                   int row_off, uint8_t* out, long long out_stride, int rows,
                   int row_bytes, int tile_rows, const Taps& taps,
                   int streams, cudaStream_t stream) {
  const dim3 grid((row_bytes + kTileBytes - 1) / kTileBytes,
                  (rows + tile_rows - 1) / tile_rows, streams);
  conv_kernel<K><<<grid, kThreads, 0, stream>>>(
      src, src_stride, src_rows, row_off, out, out_stride, rows, row_bytes,
      tile_rows, taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K8 on `stream`: for each of `streams` streams b, the rows x
// row_bytes output at out + b * out_stride from the src_rows x row_bytes
// input at src + b * src_stride, input row r + i + row_off for output row r
// and tap row i (row_off = -(k / 2) for a whole frame, 0 for a shard whose
// halo rows are in place), each block making tile_rows output rows
// (ops/convolve.py conv_plan). taps holds k * k int32 Q16 taps, row-major;
// they are copied into the launch's parameters. One kernel launch. Returns
// the cudaError_t of the launch (0 on success).
int cvs_convolve_q16(int device, const uint8_t* src, long long src_stride,
                     int src_rows, int row_off, uint8_t* out,
                     long long out_stride, int rows, int row_bytes,
                     int tile_rows, const int* taps, int k, int streams,
                     cudaStream_t stream) {
  if (k < 1 || k > kMaxK || rows <= 0 || row_bytes <= 0 || src_rows <= 0
      || tile_rows <= 0 || streams <= 0 || streams > 65535
      || (rows + tile_rows - 1) / tile_rows > 65535)
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
                          out_stride, rows, row_bytes, tile_rows, t,      \
                          streams, stream);
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

int cvs_conv_strip_bytes(void) { return kStrip; }

int cvs_conv_band_rows(void) { return kBand; }

int cvs_conv_max_k(void) { return kMaxK; }

}  // extern "C"
