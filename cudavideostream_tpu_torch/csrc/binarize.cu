// K9 on Hopper: the binarize visualizer (--visualizer 5) in two launches.
//
// Replaces no TPU kernel. The JAX package computes the chain outside
// Pallas but for its histogram (cudavideostream_tpu/ops/filters.py:293
// binarize_pipeline(fused=True): gray, the histogram, which on hardware is
// the Pallas kernel K4, the top-2 scan, the threshold and the 255/0
// replication). Its first port ran that chain as torch ops around K4
// (csrc/histogram.cu): about 45 eager launches a frame, 0.1320 ms a step
// inside a CUDA graph on an H100, 36x over the bound below. These two
// launches replace it on every served path.
//
// What it computes: the bytes of reference_cpu.binarize_pipeline,
//   gray  = (114 * B + 587 * G + 299 * R) // 1000 per pixel;
//   hist  = the exact 256-bin histogram of gray;
//   (imax, isec) = the CPU top-2 scan (server.cpp:108-120,
//           reference_cpu.top2_scan): the last two indices i with
//           hist[i] >= max(hist[:i]), an empty max being -1, isec = -1 when
//           there is one such index;
//   t     = trunc((imax + isec) / 2) clamped to [50, 200] (a sum of -1
//           truncates to 0);
//   out   = gray > t ? 255 : 0, written to all three bytes of the pixel.
//
// Launch 1, binarize_gray_kernel: one read of the BGR frame, 16 pixels (48
// bytes, three 16-byte loads where the frame is 16-byte aligned) a thread,
// the overlay strip read in place of the frame's first rlen bytes, so no
// overlaid copy is made (the one run that straddles the strip's end goes a
// pixel a thread, by threads 16-31 of block 0, as the ragged tail goes by
// threads 0-15);
// it writes the 16 gray bytes (one 16-byte store) and counts them in the
// warp's own 256 shared-memory bins. This is K4's design
// (csrc/histogram.cu): at most one block of 1,024 threads an SM, the loads
// before the zeroing of the bins, each block's sums added to a
// per-(device, stream) scratch of 257 words with one global atomic a bin,
// and the last block to finish (a done count with release-acquire order)
// swaps the sums out into the histogram and leaves the scratch zero, so
// nothing is zeroed in front of the kernel and a CUDA graph can replay it.
//
// Launch 2, binarize_apply_kernel: every block reads the 256-word
// histogram (1 KB, from L2) and runs the top-2 scan itself in its first
// warp, 8 bins a lane: the lanes' running maxima by a warp scan, each
// lane's last two qualifying indices, and two warp maxima. Its threads
// load their first 16 gray bytes before the scan, then write 255/0 three
// times a pixel (three 16-byte stores where the output is aligned).
//
// Bound at 1080p: 6,220,800 B read and 6,220,800 B written (the frame
// once, the result once; the gray bytes and the histogram between the two
// launches are intermediates), 0.00371 ms at 3.35 TB/s. The two launches
// move 2 x 2,073,600 gray bytes more, and each pays a launch and a
// grid-wide drain: the chain's floor is about two empty launches.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHistThreads = 1024;
constexpr int kWarps = kHistThreads / 32;
constexpr int kBins = 256;
constexpr int kParts = kHistThreads / kBins;  // threads summing one bin
constexpr int kScratchWords = kBins + 1;      // the sums, the done count
constexpr int kApplyThreads = 256;
constexpr int kPix = 16;  // pixels a thread takes at a time
static_assert(kWarps % kParts == 0, "each thread sums whole warps");

__device__ __forceinline__ unsigned byte_of(const unsigned (&w)[12], int m) {
  return (w[m >> 2] >> (8 * (m & 3))) & 255u;
}

// 16 pixels' 48 bytes at px into w (aligned: three 16-byte loads)
__device__ __forceinline__ void load_pixels(const uint8_t* px, bool aligned,
                                            unsigned (&w)[12]) {
  if (aligned) {
    const uint4* v = reinterpret_cast<const uint4*>(px);
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
    for (int m = 0; m < 48; ++m)
      w[m >> 2] |= (unsigned)__ldg(px + m) << (8 * (m & 3));
  }
}

// the 48 bytes of run i of the overlaid frame, a run that lies wholly
// before the region's end (read from region) or after it (from frame)
__device__ __forceinline__ void load_run(const uint8_t* frame, bool aligned,
                                         const uint8_t* region,
                                         long long rlen, long long i,
                                         unsigned (&w)[12]) {
  const long long j0 = 48 * i;
  const uint8_t* p = j0 >= rlen ? frame + j0 : region + j0;
  load_pixels(p, j0 >= rlen ? aligned : ((uintptr_t)p & 15) == 0, w);
}

__device__ __forceinline__ unsigned src_byte(const uint8_t* frame,
                                             const uint8_t* region,
                                             long long rlen, long long j) {
  return __ldg(j < rlen ? region + j : frame + j);
}

__device__ __forceinline__ unsigned gray_of(unsigned b, unsigned g,
                                            unsigned r) {
  return (114u * b + 587u * g + 299u * r) / 1000u;
}

__global__ void __launch_bounds__(kHistThreads)
    binarize_gray_kernel(const uint8_t* __restrict__ frame, long long npx,
                         int aligned, const uint8_t* __restrict__ region,
                         long long rlen, uint8_t* __restrict__ gray,
                         unsigned* __restrict__ scratch,
                         int* __restrict__ out) {
  __shared__ unsigned sub[kWarps][kBins];  // 32 KB: one histogram a warp
  __shared__ int s_last;
  const long long chunks = npx / kPix;  // whole runs of 16 pixels
  const long long stride = (long long)gridDim.x * kHistThreads;
  // the run that straddles the region's end, if any, goes pixel by pixel
  const long long straddle = rlen % 48 && rlen / 48 < chunks ? rlen / 48
                                                             : -1;
  long long i = (long long)blockIdx.x * kHistThreads + threadIdx.x;
  if (i == straddle) i += stride;
  // the loads first: this thread's first 16 pixels, and in block 0 one
  // pixel a thread of the ragged tail of fewer than 16 (threads 0-15) and
  // of the straddling run (threads 16-31)
  unsigned w[12];
  const bool first = i < chunks;
  if (first) load_run(frame, aligned, region, rlen, i, w);
  long long tp = -1;
  if (blockIdx.x == 0) {
    if (threadIdx.x < kPix) {
      if (chunks * kPix + threadIdx.x < npx) tp = chunks * kPix + threadIdx.x;
    } else if (threadIdx.x < 2 * kPix && straddle >= 0) {
      tp = straddle * kPix + threadIdx.x - kPix;
    }
  }
  const bool tail = tp >= 0;
  unsigned tb = 0, tg = 0, tr = 0;
  if (tail) {
    tb = src_byte(frame, region, rlen, 3 * tp);
    tg = src_byte(frame, region, rlen, 3 * tp + 1);
    tr = src_byte(frame, region, rlen, 3 * tp + 2);
  }

  uint4* s4 = reinterpret_cast<uint4*>(&sub[0][0]);
  for (int j = threadIdx.x; j < kWarps * kBins / 4; j += kHistThreads)
    s4[j] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  unsigned* bins = sub[threadIdx.x >> 5];
  for (bool have = first; have;) {
    unsigned g[4] = {0, 0, 0, 0};
    unsigned g0 = 0;
    bool same = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const unsigned v = gray_of(byte_of(w, 3 * k), byte_of(w, 3 * k + 1),
                                 byte_of(w, 3 * k + 2));
      g[k >> 2] |= v << (8 * (k & 3));
      if (k == 0) g0 = v;
      same = same && v == g0;
    }
    reinterpret_cast<uint4*>(gray)[i] = make_uint4(g[0], g[1], g[2], g[3]);
    if (same) {
      atomicAdd(bins + g0, (unsigned)kPix);
    } else {
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        atomicAdd(bins + ((g[k >> 2] >> (8 * (k & 3))) & 255u), 1u);
    }
    i += stride;
    if (i == straddle) i += stride;
    have = i < chunks;
    if (have) load_run(frame, aligned, region, rlen, i, w);
  }
  if (tail) {
    const unsigned v = gray_of(tb, tg, tr);
    gray[tp] = (uint8_t)v;
    atomicAdd(bins + v, 1u);
  }
  __syncthreads();

  // the block's sums, as K4 makes them: kParts threads a bin, each over
  // kWarps / kParts warps, then one thread a bin over the parts
  const int b = threadIdx.x % kBins, part = threadIdx.x / kBins;
  unsigned s = 0;
#pragma unroll
  for (int v = 0; v < kWarps / kParts; ++v)
    s += sub[part * (kWarps / kParts) + v][b];
  __syncthreads();
  sub[part][b] = s;
  __syncthreads();
  if (threadIdx.x < kBins) {
    s = 0;
#pragma unroll
    for (int q = 0; q < kParts; ++q) s += sub[q][b];
    if (s) atomicAdd(scratch + b, s);
  }

  // the last block to finish moves the sums to `out` and leaves the
  // scratch zero for the next launch on this stream
  __syncthreads();
  if (threadIdx.x == 0) {
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

// The threshold of the CPU top-2 scan over hist[0..256), computed by one
// warp (all 32 lanes call it); every lane returns it.
__device__ __forceinline__ int top2_threshold(const int* __restrict__ hist,
                                              int lane) {
  int h[8];
  int lmax = -1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    h[k] = __ldg(hist + 8 * lane + k);
    lmax = max(lmax, h[k]);
  }
  // the running max over the lanes before this one (-1 for lane 0)
  int incl = lmax;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = max(incl, v);
  }
  int run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = -1;
  // this lane's last two indices with hist[i] >= max(hist[:i])
  int l1 = -1, l2 = -1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (h[k] >= run) {
      l2 = l1;
      l1 = 8 * lane + k;
    }
    run = max(run, h[k]);
  }
  int imax = l1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    imax = max(imax, __shfl_xor_sync(0xffffffffu, imax, off));
  int isec = l1 == imax ? l2 : l1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    isec = max(isec, __shfl_xor_sync(0xffffffffu, isec, off));
  const int sum = imax + isec;
  const int t = sum >= 0 ? sum / 2 : 0;
  return t < 50 ? 50 : (t > 200 ? 200 : t);
}

__device__ __forceinline__ void apply16(uint4 gv, unsigned t, uint8_t* o,
                                        bool aligned) {
  const unsigned gw[4] = {gv.x, gv.y, gv.z, gv.w};
  unsigned w[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) w[k] = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const unsigned g = (gw[k >> 2] >> (8 * (k & 3))) & 255u;
    const unsigned v = g > t ? 255u : 0u;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int m = 3 * k + c;
      w[m >> 2] |= v << (8 * (m & 3));
    }
  }
  if (aligned) {
    uint4* v = reinterpret_cast<uint4*>(o);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  } else {
#pragma unroll
    for (int m = 0; m < 48; ++m) o[m] = (uint8_t)(w[m >> 2] >> (8 * (m & 3)));
  }
}

__device__ __forceinline__ uint4 load_gray16(const uint8_t* g, bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const uint4*>(g));
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    w[k >> 2] |= (unsigned)__ldg(g + k) << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// flags: bit 0 the gray bytes are 16-byte aligned, bit 1 the output is
__global__ void __launch_bounds__(kApplyThreads)
    binarize_apply_kernel(const uint8_t* __restrict__ gray, long long npx,
                          const int* __restrict__ hist, int flags,
                          uint8_t* __restrict__ out) {
  __shared__ int s_t;
  const bool gal = flags & 1, oal = flags & 2;
  const long long chunks = npx / kPix;
  const long long stride = (long long)gridDim.x * kApplyThreads;
  long long i = (long long)blockIdx.x * kApplyThreads + threadIdx.x;
  // this thread's first 16 gray bytes load while the first warp scans
  uint4 gv = make_uint4(0, 0, 0, 0);
  if (i < chunks) gv = load_gray16(gray + kPix * i, gal);
  if (threadIdx.x < 32) {
    const int t = top2_threshold(hist, threadIdx.x);
    if (threadIdx.x == 0) s_t = t;
  }
  __syncthreads();
  const unsigned t = (unsigned)s_t;
  while (i < chunks) {
    apply16(gv, t, out + 48 * i, oal);
    i += stride;
    if (i < chunks) gv = load_gray16(gray + kPix * i, gal);
  }
  const long long tp = chunks * kPix + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < kPix && tp < npx) {
    const uint8_t v = gray[tp] > t ? 255 : 0;
    out[3 * tp] = v, out[3 * tp + 1] = v, out[3 * tp + 2] = v;
  }
}

}  // namespace

extern "C" {

// Launch 1 of K9 on `stream`: the gray bytes of the npx pixels of the BGR
// frame, whose first rlen bytes are read from region (rlen 0: no region),
// into gray[0..npx) (16-byte aligned) and their histogram into
// out[0..256), in one launch of `grid` blocks (ops/filters.py
// gray_hist_plan). scratch holds cvs_bin_scratch_words() words, zero
// before the launch and zero after it; launches that may overlap (other
// streams) each need their own. Returns the cudaError_t of the launch.
int cvs_gray_hist(int device, const uint8_t* frame, const uint8_t* region,
                  long long rlen, long long npx, int grid, uint8_t* gray,
                  unsigned* scratch, int* out, cudaStream_t stream) {
  if (((uintptr_t)gray & 15) || npx <= 0 || grid <= 0 || rlen < 0
      || rlen > 3 * npx || (rlen && !region))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  binarize_gray_kernel<<<grid, kHistThreads, 0, stream>>>(
      frame, npx, ((uintptr_t)frame & 15) == 0, region, rlen, gray, scratch,
      out);
  return (int)cudaGetLastError();
}

// Launch 2 of K9 on `stream`: 255/0 by the threshold of hist[0..256) for
// each of the npx gray bytes, three times a pixel into out[0..3 npx), in
// one launch of `grid` blocks (ops/filters.py apply_plan). Returns the
// cudaError_t of the launch.
int cvs_binarize_apply(int device, const uint8_t* gray, long long npx,
                       const int* hist, int grid, uint8_t* out,
                       cudaStream_t stream) {
  if (npx <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int flags = (((uintptr_t)gray & 15) == 0)
                    | ((((uintptr_t)out & 15) == 0) << 1);
  binarize_apply_kernel<<<grid, kApplyThreads, 0, stream>>>(gray, npx, hist,
                                                            flags, out);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_bin_hist_threads(void) { return kHistThreads; }

int cvs_bin_apply_threads(void) { return kApplyThreads; }

int cvs_bin_scratch_words(void) { return kScratchWords; }

int cvs_bin_pixels(void) { return kPix; }

}  // extern "C"
