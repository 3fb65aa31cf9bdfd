// K10 on Hopper: the HOST backend's device step (--compaction host), the
// thresholded diff with negative feedback and the LSB-first change bitmask
// in one pass.
//
// Replaces no TPU kernel. The JAX package computes the step outside Pallas,
// as XLA ops (cudavideostream_tpu/ops/diff.py:30 diff_mask and :74
// pack_bitmask, cudavideostream_tpu/models/pipeline.py:251-269). Its first
// port ran the same chain as torch ops (an int16 difference, abs, the
// compare, a where, then a cat, shifts and a sum for the bits) and copied
// the new previous frame back into the state: 0.1917 ms a step inside a
// CUDA graph at 1080p on an H100, 33x over the bound below.
//
// What it computes, for each byte i of the frame, where the current frame
// reads the overlay region for i < rlen:
//   df = int(cur[i]) - int(prev[i]);
//   m  = |df| > t, t the int threshold or map[i], compared as ints;
//   bit i % 8 of bits[i / 8] = m (LSB first; the last byte's missing bits
//        are zero);
//   prev[i] = m ? cur : prev under negative feedback, cur without it, IN
//        PLACE (the counterpart of the JAX pipeline's donated prev);
//   delta[i] = (cur[i] - prev[i]) & 255 for every byte, when delta is not
//        null (the noise-filter HOST path fetches the dense delta; the
//        fast path writes none, as the JAX jit drops it).
//
// Design. A thread owns whole bit bytes: a chunk of 128 frame bytes gives
// 16 bit bytes, one 16-byte store, so there are no atomics and no scratch.
// Where the chunk is whole, lies on one side of the region's end and every
// address is 16-byte aligned, it reads eight 16-byte vectors of cur (or the
// region), prev and the map, and works four bytes a word with the SIMD
// video instructions (__vabsdiffu4, __vcmpgtu4, __vsub4); elsewhere (the
// ragged last chunk, the chunk that straddles the region's end, an
// unaligned view) it goes byte by byte. Chunks are taken in a grid-stride
// loop. prev is read with plain loads, never through the read-only cache:
// the kernel writes it.
//
// Bound at 1080p (n = 6,220,800 B): read cur and prev, write prev and the
// n/8 bits, 19,440,000 B, 0.00580 ms at 3.35 TB/s (the map's n more with a
// map, the delta's n more with the delta).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;          // frame bytes a thread takes at a time
constexpr int kBitBytes = kChunk / 8;  // 16: one 16-byte store
constexpr int kBlocksPerSm = 8;      // the launch plan's cap (ops/diff.py)

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// bit 7 of each byte of m (0x00 or 0xff), as 4 bits, byte 0 lowest
__device__ __forceinline__ unsigned pack4(unsigned m) {
  return ((m & 0x01010101u) * 0x10204080u) >> 28;
}

__global__ void __launch_bounds__(kThreads)
    diff_pack_kernel(const uint8_t* __restrict__ cur,
                     const uint8_t* __restrict__ region, long long rlen,
                     uint8_t* prev, const uint8_t* __restrict__ map,
                     unsigned thr, int negfeed, long long n,
                     uint8_t* __restrict__ bits,
                     uint8_t* __restrict__ delta) {
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long nbits = (n + 7) / 8;
  const long long stride = (long long)gridDim.x * kThreads;
  const unsigned thr4 = thr * 0x01010101u;
  for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
       c < chunks; c += stride) {
    const long long i0 = c * kChunk;
    const bool in_region = i0 + kChunk <= rlen;
    const uint8_t* src = in_region ? region + i0 : cur + i0;
    const bool fast = i0 + kChunk <= n && (in_region || i0 >= rlen)
                      && aligned16(src) && aligned16(prev + i0)
                      && (!map || aligned16(map + i0))
                      && (!delta || aligned16(delta + i0))
                      && aligned16(bits + c * kBitBytes);
    unsigned bw[4] = {0, 0, 0, 0};
    if (fast) {
#pragma unroll
      for (int q = 0; q < kChunk / 16; ++q) {
        const uint4 cv = __ldg(reinterpret_cast<const uint4*>(src) + q);
        uint4* pp = reinterpret_cast<uint4*>(prev + i0) + q;
        const uint4 pv = *pp;
        const uint4 tv =
            map ? __ldg(reinterpret_cast<const uint4*>(map + i0) + q)
                : make_uint4(thr4, thr4, thr4, thr4);
        const unsigned cw[4] = {cv.x, cv.y, cv.z, cv.w};
        const unsigned pw[4] = {pv.x, pv.y, pv.z, pv.w};
        const unsigned tw[4] = {tv.x, tv.y, tv.z, tv.w};
        unsigned nw[4], dw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned m = __vcmpgtu4(__vabsdiffu4(cw[k], pw[k]), tw[k]);
          nw[k] = negfeed ? (cw[k] & m) | (pw[k] & ~m) : cw[k];
          dw[k] = __vsub4(cw[k], pw[k]);
          // chunk byte 16 q + 4 k + e is bit (16 q + 4 k + e) % 32 of
          // bits word q / 2
          bw[q >> 1] |= pack4(m) << (16 * (q & 1) + 4 * k);
        }
        *pp = make_uint4(nw[0], nw[1], nw[2], nw[3]);
        if (delta)
          reinterpret_cast<uint4*>(delta + i0)[q] =
              make_uint4(dw[0], dw[1], dw[2], dw[3]);
      }
      reinterpret_cast<uint4*>(bits)[c] = make_uint4(bw[0], bw[1], bw[2],
                                                     bw[3]);
    } else {
      // byte by byte; bits word v holds chunk bytes 32 v .. 32 v + 31
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        unsigned acc = 0;
        for (int m = 0; m < 32 && i0 + 32 * v + m < n; ++m) {
          const long long i = i0 + 32 * v + m;
          const int cb = i < rlen ? __ldg(region + i) : __ldg(cur + i);
          const int pb = prev[i];
          const int t = map ? (int)__ldg(map + i) : (int)thr;
          const bool ch = abs(cb - pb) > t;
          prev[i] = (uint8_t)(ch || !negfeed ? cb : pb);
          if (delta) delta[i] = (uint8_t)(cb - pb);
          acc |= (unsigned)ch << m;
        }
        bw[v] = acc;
      }
#pragma unroll
      for (int j = 0; j < kBitBytes; ++j)
        if (c * kBitBytes + j < nbits)
          bits[c * kBitBytes + j] = (uint8_t)(bw[j >> 2] >> (8 * (j & 3)));
    }
  }
}

}  // namespace

extern "C" {

// Launch K10 on `stream` over the n bytes of the frame: the bits into
// bits[0..(n + 7) / 8), prev updated in place, and the wrapped delta into
// delta[0..n) unless delta is null. The current frame reads region[i] for
// i < rlen (rlen 0: no region); the threshold is thr, or map[i] when map is
// not null. One kernel launch of `grid` blocks (ops/diff.py
// diff_pack_plan). Returns the cudaError_t of the launch.
int cvs_diff_pack(int device, const uint8_t* cur, const uint8_t* region,
                  long long rlen, uint8_t* prev, const uint8_t* map, int thr,
                  int negative_feedback, long long n, int grid, uint8_t* bits,
                  uint8_t* delta, cudaStream_t stream) {
  if (n <= 0 || grid <= 0 || rlen < 0 || rlen > n || (rlen && !region)
      || thr < 0 || thr > 255)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  diff_pack_kernel<<<grid, kThreads, 0, stream>>>(
      cur, region, rlen, prev, map, (unsigned)thr, negative_feedback != 0, n,
      bits, delta);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_dp_threads(void) { return kThreads; }

int cvs_dp_chunk(void) { return kChunk; }

int cvs_dp_blocks_per_sm(void) { return kBlocksPerSm; }

}  // extern "C"
