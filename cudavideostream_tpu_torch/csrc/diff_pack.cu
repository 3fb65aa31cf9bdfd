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
// Design: warp tiles. A warp takes a tile of kTile = 512 kVecs frame bytes;
// lane l takes the 16 bytes at 512 q + 16 l for q < kVecs, so every 16-byte
// load of cur (or the region), prev and the map, and every store of prev
// and the delta, is 512 contiguous bytes for the warp. A lane's 16 bytes
// give the 16 bits of bits bytes 64 q + 2 l and + 1 of the tile: one
// 2-byte store, 64 contiguous bytes for the warp. The arithmetic goes four
// bytes a word (__vabsdiffu4, __vcmpgtu4, __vsub4). A vector that is not
// whole (the frame's ragged end), straddles the region's end, or whose
// address is not 16-byte aligned (a view) goes byte by byte in its lane,
// zero past the frame's end, so the padding bits come out zero; each
// frame byte and bits byte is still written once, by one lane.
//
// The grid (ops/diff.py diff_pack_plan): kBlocksPerSm blocks an SM, one
// wave. Warp w of block b takes tiles w * grid + b, then every grid *
// kWarps further, so tile t falls to block t mod grid: with block b on SM
// b mod SMs, every SM takes the same number of tiles, +-1. A warp issues
// all of a tile's loads before its stores, and loads the next tile only
// when it has stored this one: issuing the next tile's loads first
// measured no faster and held a second tile in registers. Two vectors a
// lane and two blocks an SM were the fastest of the designs tried (2-4
// vectors, 1-4 blocks, with and without the next tile's loads first, one
// tile a warp; PERF.md).
// prev is read with plain loads, never through the read-only cache: the
// kernel writes it. The first design gave a thread 128 contiguous
// bytes: 190 blocks on 132 SMs at 1080p, and every warp access touched 32
// lines at a 128-byte stride.
//
// Bound at 1080p (n = 6,220,800 B): read cur and prev, write prev and the
// n/8 bits, 19,440,000 B, 0.00580 ms at 3.35 TB/s (the map's n more with a
// map, the delta's n more with the delta).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 2;             // a lane's 16-byte vectors of a tile
constexpr int kTile = 512 * kVecs;   // frame bytes of a warp's tile
constexpr int kBlocksPerSm = 2;      // the launch plan's (ops/diff.py)

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// bit 7 of each byte of m (0x00 or 0xff), as 4 bits, byte 0 lowest
__device__ __forceinline__ unsigned pack4(unsigned m) {
  return ((m & 0x01010101u) * 0x10204080u) >> 28;
}

// The 16 bytes at p: one vector load where all 16 lie inside (valid >= 16)
// and p is 16-byte aligned, else the first `valid` bytes one by one, zero
// past them. Ro: through the read-only cache (never for prev).
template <bool Ro>
__device__ __forceinline__ uint4 load16(const uint8_t* p, long long valid) {
  if (valid >= 16 && aligned16(p))
    return Ro ? __ldg(reinterpret_cast<const uint4*>(p))
              : *reinterpret_cast<const uint4*>(p);
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < valid)
      w[e >> 2] |= (unsigned)(Ro ? __ldg(p + e) : p[e]) << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the first `valid` of the 16 bytes of v to p (one vector store where it
// can)
__device__ __forceinline__ void store16(uint8_t* p, uint4 v,
                                        long long valid) {
  if (valid >= 16 && aligned16(p)) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < valid) p[e] = (uint8_t)(w[e >> 2] >> (8 * (e & 3)));
}

// the overlaid frame's bytes [i0, i0 + 16): the region below rlen, cur
// above it, byte by byte where the vector straddles rlen
__device__ __forceinline__ uint4 load_src(const uint8_t* cur,
                                          const uint8_t* region,
                                          long long rlen, long long i0,
                                          long long valid) {
  if (i0 >= rlen) return load16<true>(cur + i0, valid);
  if (i0 + 16 <= rlen) return load16<true>(region + i0, valid);
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < valid)
      w[e >> 2] |= (unsigned)(i0 + e < rlen ? __ldg(region + i0 + e)
                                            : __ldg(cur + i0 + e))
                   << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct Tile {
  uint4 c[kVecs], p[kVecs], t[kVecs];
};

template <bool Map>
__device__ __forceinline__ void load_tile(const uint8_t* cur,
                                          const uint8_t* region,
                                          long long rlen, const uint8_t* prev,
                                          const uint8_t* map, long long n,
                                          long long i, Tile& T) {
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    const long long i0 = i + 512 * q;
    T.c[q] = load_src(cur, region, rlen, i0, n - i0);
    T.p[q] = load16<false>(prev + i0, n - i0);
    if (Map) T.t[q] = load16<true>(map + i0, n - i0);
  }
}

// the tile's new prev, delta and bits from its loaded bytes; i is the
// lane's first byte
template <bool Map>
__device__ __forceinline__ void store_tile(const Tile& T, unsigned thr4,
                                           bool negfeed, long long n,
                                           long long i, uint8_t* prev,
                                           uint8_t* bits, uint8_t* delta) {
  const bool bits2 = ((uintptr_t)bits & 1) == 0;
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    const long long i0 = i + 512 * q;
    const long long valid = n - i0;
    if (valid <= 0) continue;
    const unsigned cw[4] = {T.c[q].x, T.c[q].y, T.c[q].z, T.c[q].w};
    const unsigned pw[4] = {T.p[q].x, T.p[q].y, T.p[q].z, T.p[q].w};
    const unsigned tw[4] = {Map ? T.t[q].x : thr4, Map ? T.t[q].y : thr4,
                            Map ? T.t[q].z : thr4, Map ? T.t[q].w : thr4};
    unsigned nw[4], dw[4], m16 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned m = __vcmpgtu4(__vabsdiffu4(cw[k], pw[k]), tw[k]);
      nw[k] = negfeed ? (cw[k] & m) | (pw[k] & ~m) : cw[k];
      dw[k] = __vsub4(cw[k], pw[k]);
      m16 |= pack4(m) << (4 * k);  // byte 4 k + e is bit 4 k + e
    }
    store16(prev + i0, make_uint4(nw[0], nw[1], nw[2], nw[3]), valid);
    if (delta)
      store16(delta + i0, make_uint4(dw[0], dw[1], dw[2], dw[3]), valid);
    // i0 % 16 == 0: bits bytes i0 / 8 and i0 / 8 + 1, the second only
    // where the frame reaches past i0 + 8; zero bytes past n gave zero bits
    uint8_t* b = bits + (i0 >> 3);
    if (valid >= 16 && bits2) {
      *reinterpret_cast<uint16_t*>(b) = (uint16_t)m16;
    } else {
      b[0] = (uint8_t)m16;
      if (valid > 8) b[1] = (uint8_t)(m16 >> 8);
    }
  }
}

template <bool Map>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    diff_pack_kernel(const uint8_t* __restrict__ cur,
                     const uint8_t* __restrict__ region, long long rlen,
                     uint8_t* prev, const uint8_t* __restrict__ map,
                     unsigned thr, int negfeed, long long n,
                     uint8_t* __restrict__ bits,
                     uint8_t* __restrict__ delta) {
  const long long tiles = (n + kTile - 1) / kTile;
  const long long warps = (long long)gridDim.x * kWarps;
  long long t = (long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  if (t >= tiles) return;  // the whole warp
  const long long lane16 = 16 * (threadIdx.x & 31);
  const unsigned thr4 = thr * 0x01010101u;
  for (; t < tiles; t += warps) {
    Tile a;
    load_tile<Map>(cur, region, rlen, prev, map, n, t * kTile + lane16, a);
    store_tile<Map>(a, thr4, negfeed != 0, n, t * kTile + lane16, prev,
                    bits, delta);
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
  if (map)
    diff_pack_kernel<true><<<grid, kThreads, 0, stream>>>(
        cur, region, rlen, prev, map, (unsigned)thr, negative_feedback != 0,
        n, bits, delta);
  else
    diff_pack_kernel<false><<<grid, kThreads, 0, stream>>>(
        cur, region, rlen, prev, nullptr, (unsigned)thr,
        negative_feedback != 0, n, bits, delta);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_dp_threads(void) { return kThreads; }

int cvs_dp_vecs(void) { return kVecs; }

int cvs_dp_blocks_per_sm(void) { return kBlocksPerSm; }

}  // extern "C"
