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
// Design. A thread takes runs of 16 pixels (48 bytes: three 16-byte loads
// where the address is 16-byte aligned, byte loads where it is not, or
// where the run straddles the end of a stream's overlay strip or a stream
// boundary) in a grid-stride loop; block 0 takes the ragged tail of fewer
// than 16 pixels, a pixel a thread. B streams of sn bytes at a stride are
// one launch: stream b reads its strip at region + b * rlen and the map at
// its own byte index j = i mod sn (the map is one stream's). Pixels never
// straddle streams (sn % 3 == 0). The heatmap's LUT comes by value in the
// launch's parameters (766 words, b | g << 8 | r << 16: 3,064 B), so no
// table is ever uploaded (nothing to upload inside a CUDA graph capture);
// each block copies it into shared memory before it gathers, because an
// indexed read of the parameter bank with divergent indices serializes.
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
constexpr int kPix = 16;            // pixels a thread takes at a time
constexpr int kRun = 3 * kPix;      // their 48 bytes
constexpr int kLutSize = 766;       // d = 0..765
constexpr int kBlocksPerSm = 8;     // the launch plan's cap (ops/filters.py)

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

__device__ __forceinline__ unsigned byte_of(const unsigned (&w)[12], int m) {
  return (w[m >> 2] >> (8 * (m & 3))) & 255u;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
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

// the map's bytes for frame bytes [i0, i0 + 48): byte j of its stream
__device__ __forceinline__ void load_map(const uint8_t* map, long long sn,
                                         long long i0, unsigned (&w)[12]) {
  const long long j0 = in_stream(i0, sn);
  if (j0 + kRun <= sn) {
    load48(map + j0, w);
    return;
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) w[k] = 0;
#pragma unroll
  for (int m = 0; m < kRun; ++m)
    w[m >> 2] |= (unsigned)__ldg(map + in_stream(i0 + m, sn))
                 << (8 * (m & 3));
}

// one pixel: c, p, t its three bytes of the overlaid frame, the previous
// frame and the threshold; o the output's
template <int Op>
__device__ __forceinline__ void pixel(const unsigned (&c)[3],
                                      const unsigned (&p)[3],
                                      const unsigned (&t)[3],
                                      const unsigned* lut,
                                      unsigned (&o)[3]) {
  if (Op == kHeat) {
    const int d = abs((int)c[0] - (int)p[0]) + abs((int)c[1] - (int)p[1])
                  + abs((int)c[2] - (int)p[2]);
    const unsigned v = lut[d];
    o[0] = v & 255u, o[1] = (v >> 8) & 255u, o[2] = (v >> 16) & 255u;
  } else if (Op == kRedBlack || Op == kRedOverlap) {
    bool ch = false;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      ch = ch || abs((int)c[k] - (int)p[k]) > (int)t[k];
    if (Op == kRedBlack) {
      o[0] = 0, o[1] = 0, o[2] = ch ? 255u : 0u;
    } else {
      o[0] = p[0], o[1] = p[1], o[2] = ch ? 255u : p[2];
    }
  } else {
    const unsigned g = Op == kGrayAvg
                           ? (c[0] + c[1] + c[2]) / 3u
                           : (114u * c[0] + 587u * c[1] + 299u * c[2]) / 1000u;
    o[0] = g, o[1] = g, o[2] = g;
  }
}

template <int Op>
__host__ __device__ constexpr bool reads_prev() {
  return Op == kHeat || Op == kRedBlack || Op == kRedOverlap;
}

template <int Op, bool Map>
__device__ __forceinline__ void body(const Src s,
                                     const uint8_t* __restrict__ prev,
                                     const uint8_t* __restrict__ map,
                                     unsigned thr, long long npx,
                                     uint8_t* __restrict__ out,
                                     const unsigned* lut) {
  const long long runs = npx / kPix;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < runs; r += stride) {
    const long long i0 = kRun * r;
    unsigned cw[12], pw[12], tw[12], ow[12];
    load_src(s, i0, cw);
    if (reads_prev<Op>()) load48(prev + i0, pw);
    if (Map) load_map(map, s.sn, i0, tw);
#pragma unroll
    for (int k = 0; k < 12; ++k) ow[k] = 0;
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      unsigned c[3], p[3] = {0, 0, 0}, t[3] = {thr, thr, thr}, o[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        c[e] = byte_of(cw, 3 * q + e);
        if (reads_prev<Op>()) p[e] = byte_of(pw, 3 * q + e);
        if (Map) t[e] = byte_of(tw, 3 * q + e);
      }
      pixel<Op>(c, p, t, lut, o);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int m = 3 * q + e;
        ow[m >> 2] |= o[e] << (8 * (m & 3));
      }
    }
    store48(out + i0, ow);
  }
  // the ragged tail of fewer than 16 pixels: block 0, a pixel a thread
  const long long tp = runs * kPix + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < kPix && tp < npx) {
    unsigned c[3], p[3] = {0, 0, 0}, t[3] = {thr, thr, thr}, o[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const long long i = 3 * tp + e;
      c[e] = src_byte(s, i);
      if (reads_prev<Op>()) p[e] = __ldg(prev + i);
      if (Map) t[e] = __ldg(map + in_stream(i, s.sn));
    }
    pixel<Op>(c, p, t, lut, o);
#pragma unroll
    for (int e = 0; e < 3; ++e) out[3 * tp + e] = (uint8_t)o[e];
  }
}

__global__ void __launch_bounds__(kThreads)
    heat_kernel(const Src s, const uint8_t* __restrict__ prev, long long npx,
                uint8_t* __restrict__ out, const __grid_constant__ Lut lut) {
  __shared__ unsigned s_lut[kLutSize];
  for (int k = threadIdx.x; k < kLutSize; k += kThreads) s_lut[k] = lut.v[k];
  __syncthreads();
  body<kHeat, false>(s, prev, nullptr, 0u, npx, out, s_lut);
}

template <int Op, bool Map>
__global__ void __launch_bounds__(kThreads)
    vis_kernel(const Src s, const uint8_t* __restrict__ prev,
               const uint8_t* __restrict__ map, unsigned thr, long long npx,
               uint8_t* __restrict__ out) {
  body<Op, Map>(s, prev, map, thr, npx, out, nullptr);
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
// blocks (ops/filters.py vis_plan). Returns the cudaError_t of the launch.
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
  switch (op) {
    case kHeat: {
      Lut l;
      memcpy(l.v, lut, sizeof l.v);
      heat_kernel<<<grid, kThreads, 0, stream>>>(s, prev, npx, out, l);
      break;
    }
    case kRedBlack:
      if (map)
        vis_kernel<kRedBlack, true><<<grid, kThreads, 0, stream>>>(
            s, prev, map, t, npx, out);
      else
        vis_kernel<kRedBlack, false><<<grid, kThreads, 0, stream>>>(
            s, prev, nullptr, t, npx, out);
      break;
    case kRedOverlap:
      if (map)
        vis_kernel<kRedOverlap, true><<<grid, kThreads, 0, stream>>>(
            s, prev, map, t, npx, out);
      else
        vis_kernel<kRedOverlap, false><<<grid, kThreads, 0, stream>>>(
            s, prev, nullptr, t, npx, out);
      break;
    case kGrayAvg:
      vis_kernel<kGrayAvg, false><<<grid, kThreads, 0, stream>>>(
          s, nullptr, nullptr, 0u, npx, out);
      break;
    default:
      vis_kernel<kGrayWeighted, false><<<grid, kThreads, 0, stream>>>(
          s, nullptr, nullptr, 0u, npx, out);
      break;
  }
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_vis_threads(void) { return kThreads; }

int cvs_vis_pixels(void) { return kPix; }

int cvs_vis_lut_size(void) { return kLutSize; }

int cvs_vis_blocks_per_sm(void) { return kBlocksPerSm; }

}  // extern "C"
