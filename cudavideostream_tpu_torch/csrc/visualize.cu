// K11-K13 on Hopper: the motion heatmap (--visualizer 1), the red modes (2
// and 3) and grayscale (4), one pass over the frame each.
//
// Replace no TPU kernel. The JAX package computes these outside Pallas, as
// XLA ops (cudavideostream_tpu/ops/filters.py:379 heatmap with the LUT,
// :424 red_black and :435 red_overlap on the mask of ops/diff.py:30
// diff_mask, :110 grayscale_average and :121 grayscale_weighted). Their
// first port ran the same chains as torch ops: int32 copies of the frame,
// sums, a LUT gather, a whole diff_mask for the red modes, each a pass over
// the 1080p frame, 20-33x over the bounds below inside a CUDA graph on an
// H100. And every visualizer step first built an overlaid copy of the whole
// frame with torch.cat. These kernels read the overlay strip in place of
// the frame's prefix and make each aux frame in one launch.
//
// What each computes per pixel (three bytes B, G, R of the overlaid frame
// c and of the previous frame p; the overlaid frame is region[j] for the
// stream's byte j < rlen and cur elsewhere):
//   K11 heat:        d = |cB-pB| + |cG-pG| + |cR-pR| (0..765), out = LUT[d],
//                    the 766-entry BGR table of reference_cpu.heatmap_lut
//                    (its wrap past d = 510 included);
//   K12 red black:   changed = any byte |c - p| > t (t the int or the
//                    per-byte map, compared as ints); out = (0, 0, 255) if
//                    changed else (0, 0, 0);
//   K12 red overlap: out = p with R = 255 where changed;
//   K13 gray:        g = (B + G + R) / 3, or (114 B + 587 G + 299 R) / 1000
//                    in int32; out = (g, g, g).
//
// B streams of sn bytes at a stride are one launch: stream b reads its
// strip at region + b * rlen and K12 the map at its own byte index j = i
// mod sn (the map is one stream's). Pixels never straddle streams (sn % 3
// == 0).
//
// Design of K11 and K12: warp tiles. A warp takes a tile of kTile = 1,536
// bytes (512 pixels, so a tile starts on a pixel); lane l takes the 16
// bytes at 512 k + 16 l (k < 3) of the overlaid frame, of prev and of the
// map (at the stream's byte j = i mod sn), so every load and every 16-byte
// store is 512 contiguous bytes for the warp. A vector that is not whole,
// straddles a strip's end or a stream boundary, or is not 16-byte aligned
// loads (and stores) byte by byte in its lane, zero past the frame. The
// grid (ops/filters.py tile_plan) is one wave of kRedBlocksPerSm (K12) or
// kHeatBlocksPerSm (K11) blocks an SM; warp w of block b takes tiles w *
// grid + b, then every grid * 8 further, so every SM takes the same number
// of tiles, +-1.
//
// K12 (red_kernel) keeps its tile in registers. It compares its bytes four
// a word (__vabsdiffu4, __vcmpgtu4) into 16 mask bits. A pixel's R byte is
// its third: the pixel changed where any of the R byte's bit and the two
// before it is set, and the two before byte 0 or 1 are the last two of the
// vector before (lane l - 1, or lane 31 of vector k - 1 for lane 0), taken
// by a shuffle. The R bytes of a vector depend on its phase (16 l + 512 k)
// mod 3 = (l + 2 k) mod 3: one of three 16-bit masks. The output is built
// in the lane's registers (zero, or the lane's own prev bytes, with 255 at
// the changed R bytes) and stored as one vector; a warp issues its next
// tile's loads before it computes and stores the current one.
//
// K11 (heat_kernel) needs a pixel's three byte values, which lie in one or
// two lanes at a phase that differs across the warp; picking them out of
// registers would diverge three ways or index registers at run time (a
// stack frame). So the warp stages its tile through its own 1,536 bytes of
// shared memory: each lane writes each byte's |c - p| (__vabsdiffu4 on its
// own words: the heatmap needs only their sum) where it lies in the tile,
// then (__syncwarp) reads the tile's pixels 16 l .. 16 l + 15, its bytes 48
// l .. 48 l + 47, as three 16-byte shared loads (8 lanes a phase start at
// words 12 l mod 32: 8 distinct groups of 4 banks, no conflict), computes
// them and writes the 48 output bytes back over its own 48 bytes, then
// (__syncwarp) stores the vectors at 512 k + 16 l as it loaded them. Once
// a tile is staged its registers are free: the next tile's loads go out
// then, into the same registers, and overlap the pass through shared
// memory and the stores. Four blocks an SM (one tile a warp at 1080p) beat
// two: the pass through shared memory and the LUT gathers want the warps.
// The LUT comes by value in the launch's parameters (766 words, b | g << 8
// | r << 16: 3,064 B), so no table is ever uploaded (nothing to upload
// inside a CUDA graph capture); each block copies it into shared memory,
// because an indexed read of the parameter bank with divergent indices
// serializes, after its warps have issued their first tile's loads, so the
// copy overlaps them.
//
// K13 (vis_kernel<Op>) keeps runs of 16 pixels a thread (48 bytes: three
// 16-byte loads where the address is 16-byte aligned, byte loads where it
// is not, or where the run straddles the end of a stream's overlay strip
// or a stream boundary) in a grid-stride loop; block 0 takes the ragged
// tail of fewer than 16 pixels, a pixel a thread (ops/filters.py
// vis_plan). On K11's warp tiles (its loads staged or not, 2 or 4 blocks
// an SM) it tied this design or lost by up to 2% at the event in turns,
// where most of its time is the launch floor (PERF.md).
//
// Bounds at 1080p (n = 6,220,800 B), bytes at 3.35 TB/s: K11 and K12 read
// c and p and write the output, 3n = 18,662,400 B, 0.00557 ms (the map's n
// more where there is one); K13 reads c and writes the output, 2n =
// 12,441,600 B, 0.00371 ms.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLutSize = 766;       // d = 0..765
constexpr int kWarps = kThreads / 32;
constexpr int kTileVecs = 3;                // a lane's vectors of a tile
constexpr int kTile = 512 * kTileVecs;      // 1,536 bytes: 512 pixels
constexpr int kRedBlocksPerSm = 2;          // K12's plan (ops/filters.py)
constexpr int kHeatBlocksPerSm = 4;         // K11's
constexpr int kPix = 16;             // pixels a K13 thread takes at a time
constexpr int kRun = 3 * kPix;       // their 48 bytes
constexpr int kRunBlocksPerSm = 8;   // K13's plan's cap (ops/filters.py)

enum Op { kHeat = 0, kRedBlack = 1, kRedOverlap = 2, kGrayAvg = 3,
          kGrayWeighted = 4 };

struct Lut {
  unsigned v[kLutSize];
};

// The overlaid frame: stream b's byte j is region[b * rlen + j] for
// j < rlen, else cur[b * sn + j].
struct Src {
  const uint8_t* cur;
  const uint8_t* region;
  long long rlen;
  long long sn;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// The 16 bytes at p: one vector load where all 16 lie inside (valid >= 16)
// and p is 16-byte aligned, else the first `valid` bytes one by one, zero
// past them
__device__ __forceinline__ uint4 load16(const uint8_t* p, long long valid) {
  if (valid >= 16 && aligned16(p))
    return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < valid) w[e >> 2] |= (unsigned)__ldg(p + e) << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The first `valid` bytes of v at p (nothing where valid <= 0): one vector
// store where all 16 lie inside and p is 16-byte aligned, else byte by byte
__device__ __forceinline__ void store16(uint8_t* p, const uint4 v,
                                        long long valid) {
  if (valid >= 16 && aligned16(p)) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < valid) p[b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
}

struct Tile {
  uint4 c[kTileVecs], p[kTileVecs], t[kTileVecs];
};

// The lane's vectors of the tile whose lane byte is i (the tile starts in
// stream s0): the overlaid frame, prev (where Prev) and, with a map, the
// map's bytes at the stream's byte j. A vector inside one stream takes one
// load of each; one that straddles a stream boundary, the strip's end or
// the frame's end takes its bytes one by one.
template <bool Prev, bool Map>
__device__ __forceinline__ void tile_load(const Src s,
                                          const uint8_t* __restrict__ prev,
                                          const uint8_t* __restrict__ map,
                                          long long n, long long i,
                                          long long s0, Tile& T) {
#pragma unroll
  for (int k = 0; k < kTileVecs; ++k) {
    const long long i0 = i + 512 * k;
    const long long valid = n - i0;
    long long b = s0, j0 = i0 - s0 * s.sn;  // stream and byte in it
    if (j0 >= s.sn) {
      const long long q = j0 / s.sn;
      b += q;
      j0 -= q * s.sn;
    }
    if (Prev) T.p[k] = load16(prev + i0, valid);
    if (valid >= 16 && j0 + 16 <= s.sn
        && (j0 >= s.rlen || j0 + 16 <= s.rlen)) {
      T.c[k] = load16(j0 >= s.rlen ? s.cur + i0 : s.region + b * s.rlen + j0,
                      16);
      if (Map) T.t[k] = load16(map + j0, 16);
      continue;
    }
    unsigned c[4] = {0, 0, 0, 0}, t[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (e < valid) {
        long long bb = b, j = j0 + e;
        while (j >= s.sn) j -= s.sn, ++bb;  // streams of 3 B at the least
        c[e >> 2] |= (unsigned)(j < s.rlen
                                    ? __ldg(s.region + bb * s.rlen + j)
                                    : __ldg(s.cur + i0 + e))
                     << (8 * (e & 3));
        if (Map) t[e >> 2] |= (unsigned)__ldg(map + j) << (8 * (e & 3));
      }
    }
    T.c[k] = make_uint4(c[0], c[1], c[2], c[3]);
    if (Map) T.t[k] = make_uint4(t[0], t[1], t[2], t[3]);
  }
}

// ---- K11 and K13 ----------------------------------------------------------

__device__ __forceinline__ unsigned byte_of(const unsigned (&w)[12], int m) {
  return (w[m >> 2] >> (8 * (m & 3))) & 255u;
}

// one pixel: x its three bytes (K11: |c - p| of each, K13: c); o the
// output's
template <int Op>
__device__ __forceinline__ void pixel(const unsigned (&x)[3],
                                      const unsigned* lut,
                                      unsigned (&o)[3]) {
  if (Op == kHeat) {
    const unsigned v = lut[x[0] + x[1] + x[2]];
    o[0] = v & 255u, o[1] = (v >> 8) & 255u, o[2] = (v >> 16) & 255u;
  } else {
    const unsigned g = Op == kGrayAvg
                           ? (x[0] + x[1] + x[2]) / 3u
                           : (114u * x[0] + 587u * x[1] + 299u * x[2]) / 1000u;
    o[0] = g, o[1] = g, o[2] = g;
  }
}

// The 16 pixels of x (48 bytes, 12 words) into o
template <int Op>
__device__ __forceinline__ void pixels16(const unsigned (&x)[12],
                                         const unsigned* lut,
                                         unsigned (&o)[12]) {
#pragma unroll
  for (int k = 0; k < 12; ++k) o[k] = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    unsigned px[3], po[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) px[e] = byte_of(x, 3 * q + e);
    pixel<Op>(px, lut, po);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int m = 3 * q + e;
      o[m >> 2] |= po[e] << (8 * (m & 3));
    }
  }
}

// The three 16-byte words at w (shared memory) and back
__device__ __forceinline__ void lds48(const uint4* w, unsigned (&x)[12]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 u = w[k];
    x[4 * k] = u.x, x[4 * k + 1] = u.y, x[4 * k + 2] = u.z,
    x[4 * k + 3] = u.w;
  }
}

__device__ __forceinline__ void sts48(uint4* w, const unsigned (&x)[12]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    w[k] = make_uint4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
}

__global__ void __launch_bounds__(kThreads, kHeatBlocksPerSm)
    heat_kernel(const Src s, const uint8_t* __restrict__ prev, long long n,
                uint8_t* __restrict__ out, const __grid_constant__ Lut lut) {
  __shared__ uint4 s_tile[kWarps][32 * kTileVecs];
  __shared__ unsigned s_lut[kLutSize];
  const long long tiles = (n + kTile - 1) / kTile;
  const long long warps = (long long)gridDim.x * kWarps;
  const int lane = threadIdx.x & 31;
  uint4* x = s_tile[threadIdx.x >> 5];  // the warp's tile
  long long t = (long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  Tile T;
  // the first tile's loads go out before the LUT's copy
  if (t < tiles)
    tile_load<true, false>(s, prev, nullptr, n, t * kTile + 16 * lane,
                           t * kTile < s.sn ? 0 : t * kTile / s.sn, T);
  for (int k = threadIdx.x; k < kLutSize; k += kThreads) s_lut[k] = lut.v[k];
  __syncthreads();
  if (t >= tiles) return;  // the whole warp
  for (;;) {
    const long long tb = t * kTile;
    // stage |c - p|, a byte's own, so prev needs no tile of its own
#pragma unroll
    for (int k = 0; k < kTileVecs; ++k) {
      const uint4 c = T.c[k], p = T.p[k];
      x[32 * k + lane] =
          make_uint4(__vabsdiffu4(c.x, p.x), __vabsdiffu4(c.y, p.y),
                     __vabsdiffu4(c.z, p.z), __vabsdiffu4(c.w, p.w));
    }
    __syncwarp();
    // the tile is staged: the next one's loads go out now
    const long long next = t + warps, nb = next * kTile;
    if (next < tiles)
      tile_load<true, false>(s, prev, nullptr, n, nb + 16 * lane,
                             nb < s.sn ? 0 : nb / s.sn, T);
    unsigned d[12], o[12];
    lds48(x + 3 * lane, d);
    pixels16<kHeat>(d, s_lut, o);
    sts48(x + 3 * lane, o);  // over the lane's own 48 bytes
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kTileVecs; ++k) {
      const long long i0 = tb + 512 * k + 16 * lane;
      store16(out + i0, x[32 * k + lane], n - i0);
    }
    if (next >= tiles) break;
    t = next;
  }
}

__device__ __forceinline__ void load48(const uint8_t* p, unsigned (&w)[12]) {
  if (aligned16(p)) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 u = __ldg(v + k);
      w[4 * k] = u.x, w[4 * k + 1] = u.y, w[4 * k + 2] = u.z,
      w[4 * k + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) w[k] = 0;
#pragma unroll
    for (int m = 0; m < kRun; ++m)
      w[m >> 2] |= (unsigned)__ldg(p + m) << (8 * (m & 3));
  }
}

__device__ __forceinline__ void store48(uint8_t* p, const unsigned (&w)[12]) {
  if (aligned16(p)) {
    uint4* v = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  } else {
#pragma unroll
    for (int m = 0; m < kRun; ++m) p[m] = (uint8_t)byte_of(w, m);
  }
}

// j = i mod sn without a division for the first stream
__device__ __forceinline__ long long in_stream(long long i, long long sn) {
  return i < sn ? i : i % sn;
}

__device__ __forceinline__ unsigned src_byte(const Src s, long long i) {
  const long long j = in_stream(i, s.sn);
  return j < s.rlen ? __ldg(s.region + (i - j) / s.sn * s.rlen + j)
                    : __ldg(s.cur + i);
}

// the overlaid bytes [i0, i0 + 48)
__device__ __forceinline__ void load_src(const Src s, long long i0,
                                         unsigned (&w)[12]) {
  const long long j0 = in_stream(i0, s.sn);
  if (j0 + kRun <= s.sn) {  // inside one stream
    if (j0 >= s.rlen) {
      load48(s.cur + i0, w);
      return;
    }
    if (j0 + kRun <= s.rlen) {
      load48(s.region + (i0 - j0) / s.sn * s.rlen + j0, w);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) w[k] = 0;
#pragma unroll
  for (int m = 0; m < kRun; ++m)
    w[m >> 2] |= src_byte(s, i0 + m) << (8 * (m & 3));
}

// K13: runs of 16 pixels a thread in a grid-stride loop; block 0 takes the
// ragged tail of fewer than 16 pixels, a pixel a thread
template <int Op>
__global__ void __launch_bounds__(kThreads)
    vis_kernel(const Src s, long long npx, uint8_t* __restrict__ out) {
  const long long runs = npx / kPix;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < runs; r += stride) {
    unsigned c[12], o[12];
    load_src(s, kRun * r, c);
    pixels16<Op>(c, nullptr, o);
    store48(out + kRun * r, o);
  }
  const long long tp = runs * kPix + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < kPix && tp < npx) {
    unsigned c[3], o[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) c[e] = src_byte(s, 3 * tp + e);
    pixel<Op>(c, nullptr, o);
#pragma unroll
    for (int e = 0; e < 3; ++e) out[3 * tp + e] = (uint8_t)o[e];
  }
}

// ---- K12 ----------------------------------------------------------------

// bit 7 of each byte of m (0x00 or 0xff), as 4 bits, byte 0 lowest
__device__ __forceinline__ unsigned pack4(unsigned m) {
  return ((m & 0x01010101u) * 0x10204080u) >> 28;
}

// 4 bits to 4 bytes, 0xff where the bit is set, bit 0 to byte 0
__device__ __forceinline__ unsigned spread4(unsigned b) {
  return ((b * 0x00204081u) & 0x01010101u) * 0xffu;
}

// The R bytes of a 16-byte vector whose first byte lies at phase r (its
// frame index mod 3; pixels start at multiples of 3): bit j is set where
// (r + j) % 3 == 2
__device__ __forceinline__ unsigned r_bytes(int r) {
  return r == 0 ? 0x4924u : r == 1 ? 0x2492u : 0x9249u;
}

// The tile's output from its loaded bytes, lane byte i, lane `lane`; every
// lane of the warp takes part (shuffles)
template <bool Overlap, bool Map>
__device__ __forceinline__ void red_store(const Tile& T, unsigned thr4,
                                          long long n, long long i, int lane,
                                          uint8_t* __restrict__ out) {
  unsigned m[kTileVecs];  // bit j: byte j changed
#pragma unroll
  for (int k = 0; k < kTileVecs; ++k) {
    const unsigned cw[4] = {T.c[k].x, T.c[k].y, T.c[k].z, T.c[k].w};
    const unsigned pw[4] = {T.p[k].x, T.p[k].y, T.p[k].z, T.p[k].w};
    const unsigned tw[4] = {Map ? T.t[k].x : thr4, Map ? T.t[k].y : thr4,
                            Map ? T.t[k].z : thr4, Map ? T.t[k].w : thr4};
    m[k] = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      m[k] |= pack4(__vcmpgtu4(__vabsdiffu4(cw[q], pw[q]), tw[q])) << (4 * q);
  }
  unsigned up[kTileVecs], last[kTileVecs];
#pragma unroll
  for (int k = 0; k < kTileVecs; ++k) {
    up[k] = __shfl_up_sync(0xffffffffu, m[k], 1);
    last[k] = __shfl_sync(0xffffffffu, m[k], 31);
  }
#pragma unroll
  for (int k = 0; k < kTileVecs; ++k) {
    const long long i0 = i + 512 * k;
    // the vector before: lane - 1's, or lane 31's of vector k - 1; none
    // before the tile's first byte, which starts a pixel
    const unsigned before = lane ? up[k] : k ? last[k - 1] : 0u;
    // bit j + 2: byte j; bits 0-1: the vector before's bytes 14-15
    const unsigned e = (m[k] << 2) | (before >> 14);
    // bit j: any of bytes j - 2, j - 1, j, the pixel of an R byte j
    const unsigned red = (e | e >> 1 | e >> 2) & r_bytes((lane + 2 * k) % 3);
    const unsigned pw[4] = {T.p[k].x, T.p[k].y, T.p[k].z, T.p[k].w};
    unsigned o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned r = spread4((red >> (4 * q)) & 15u);
      o[q] = Overlap ? pw[q] | r : r;
    }
    store16(out + i0, make_uint4(o[0], o[1], o[2], o[3]), n - i0);
  }
}

template <bool Overlap, bool Map>
__global__ void __launch_bounds__(kThreads, kRedBlocksPerSm)
    red_kernel(const Src s, const uint8_t* __restrict__ prev,
               const uint8_t* __restrict__ map, unsigned thr, long long n,
               uint8_t* __restrict__ out) {
  const long long tiles = (n + kTile - 1) / kTile;
  const long long warps = (long long)gridDim.x * kWarps;
  long long t = (long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  if (t >= tiles) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const unsigned thr4 = thr * 0x01010101u;
  long long tb = t * kTile;
  Tile a;
  tile_load<true, Map>(s, prev, map, n, tb + 16 * lane,
                       tb < s.sn ? 0 : tb / s.sn, a);
  for (;;) {
    // the next tile's loads go out before this one's stores
    const long long next = t + warps, nb = next * kTile;
    Tile b;
    if (next < tiles)
      tile_load<true, Map>(s, prev, map, n, nb + 16 * lane,
                           nb < s.sn ? 0 : nb / s.sn, b);
    red_store<Overlap, Map>(a, thr4, n, tb + 16 * lane, lane, out);
    if (next >= tiles) break;
    a = b;
    t = next;
    tb = nb;
  }
}

}  // namespace

extern "C" {

// Launch one of K11-K13 on `stream` over npx pixels (3 * npx bytes, B =
// 3 * npx / sn streams of sn bytes each): op 0 the heatmap (lut: 766 host
// words, b | g << 8 | r << 16, copied into the launch's parameters), 1 red
// black, 2 red overlap (thr, or the map of sn bytes when map is not null),
// 3 grayscale average, 4 grayscale weighted; into out[0..3 npx). The
// overlaid frame reads region[b * rlen + j] for stream b's byte j < rlen
// (rlen 0: no region). prev is read by ops 0-2. One kernel launch of `grid`
// blocks (ops/filters.py: tile_plan for ops 0-2, vis_plan for 3-4).
// Returns the cudaError_t of the launch.
int cvs_visualize(int device, int op, const uint8_t* cur,
                  const uint8_t* region, long long rlen, long long sn,
                  const uint8_t* prev, const uint8_t* map, int thr,
                  const unsigned* lut, long long npx, int grid, uint8_t* out,
                  cudaStream_t stream) {
  if (npx <= 0 || grid <= 0 || sn <= 0 || sn % 3 || (3 * npx) % sn
      || rlen < 0 || rlen > sn || (rlen && !region) || thr < 0 || thr > 255
      || op < kHeat || op > kGrayWeighted || (op <= kRedOverlap && !prev)
      || (op == kHeat && !lut))
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Src s{cur, region, rlen, sn};
  const unsigned t = (unsigned)thr;
  const long long n = 3 * npx;
  switch (op) {
    case kHeat: {
      Lut l;
      memcpy(l.v, lut, sizeof l.v);
      heat_kernel<<<grid, kThreads, 0, stream>>>(s, prev, n, out, l);
      break;
    }
    case kRedBlack:
      if (map)
        red_kernel<false, true><<<grid, kThreads, 0, stream>>>(
            s, prev, map, t, n, out);
      else
        red_kernel<false, false><<<grid, kThreads, 0, stream>>>(
            s, prev, nullptr, t, n, out);
      break;
    case kRedOverlap:
      if (map)
        red_kernel<true, true><<<grid, kThreads, 0, stream>>>(
            s, prev, map, t, n, out);
      else
        red_kernel<true, false><<<grid, kThreads, 0, stream>>>(
            s, prev, nullptr, t, n, out);
      break;
    case kGrayAvg:
      vis_kernel<kGrayAvg><<<grid, kThreads, 0, stream>>>(s, npx, out);
      break;
    default:
      vis_kernel<kGrayWeighted><<<grid, kThreads, 0, stream>>>(s, npx, out);
      break;
  }
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_vis_threads(void) { return kThreads; }

int cvs_vis_lut_size(void) { return kLutSize; }

int cvs_tile_vecs(void) { return kTileVecs; }

int cvs_red_blocks_per_sm(void) { return kRedBlocksPerSm; }

int cvs_heat_blocks_per_sm(void) { return kHeatBlocksPerSm; }

int cvs_vis_pixels(void) { return kPix; }

int cvs_vis_blocks_per_sm(void) { return kRunBlocksPerSm; }

}  // extern "C"
