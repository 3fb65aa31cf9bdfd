// K9 on Hopper: the binarize visualizer (--visualizer 5).
//
// Replaces no TPU kernel. The JAX package computes the chain outside
// Pallas but for its histogram (cudavideostream_tpu/ops/filters.py:293
// binarize_pipeline(fused=True): gray, the histogram, which on hardware is
// the Pallas kernel K4, the top-2 scan, the threshold and the 255/0
// replication). Its first port ran that chain as torch ops around K4
// (csrc/histogram.cu): about 45 eager launches a frame, 0.1320 ms a step
// inside a CUDA graph on an H100, 36x over the bound below. Its first
// kernels made it two launches; the solo and batched paths now take one.
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
// binarize_fused_kernel, one cooperative launch for B streams at a stride
// (the solo frame is B = 1), each with its own histogram and threshold:
// * Each block belongs to one stream (per_stream blocks a stream, from the
//   plan in ops/filters.py binarize_plan); its thread t takes block_runs
//   runs of 16 pixels, run (j * block_runs + k) * 1,024 + t of the stream
//   for its block j. One read of the frame, 48 bytes a run (three 16-byte
//   loads where aligned), the overlay strip read in place of the stream's
//   first rlen bytes (the run that straddles the strip's end goes a pixel
//   a thread, by threads 16-31 of the stream's first block, as the ragged
//   tail of fewer than 16 pixels goes by threads 0-15).
// * The histogram is K4's design (csrc/histogram.cu): the loads before the
//   zeroing of the warps' own 256 shared-memory bins, each block's sums
//   added to its stream's 256 words of a per-(device, stream) scratch with
//   one global atomic a bin.
// * Then a grid barrier: each block adds one to the scratch's arrival
//   word (release) and waits until every block has (acquire). The launch
//   is cooperative (cudaLaunchKernelEx with cudaLaunchAttributeCooperative),
//   so the card either holds every block at once or refuses the launch;
//   the wait gives up with a trap after 2 s rather than hang.
// * Then every block runs the top-2 scan of its stream's sums in its first
//   warp, 8 bins a lane (top2_threshold), and writes 255/0 three times a
//   pixel from the gray values it kept in registers across the barrier:
//   kRegRuns runs a thread. Each thread turns its run into 16 bits, and a
//   warp writes its 32 runs' 1,536 bytes as coalesced 16-byte stores, each
//   lane's chunk looked up from the bits of the 6 pixels it spans
//   (store_warp; a thread's own 48 bytes would make every store of the
//   warp touch 32 sectors half). A thread with more runs (a plan past the
//   register budget) writes their gray bytes to `spill` and reads them
//   back itself after the barrier.
// * The scratch is left zero: each block adds one to the arrival word
//   again once its scan has read the sums (the reply awaited after its
//   stores), and the block that brought it to twice the grid empties the
//   sums and the word, so nothing is zeroed in front of the kernel and a
//   CUDA graph can replay it.
//
// The row-sharded path keeps two launches, because its histogram is the
// sum over the shards of a frame, taken between them
// (parallel/sharded.py): binarize_gray_kernel writes the gray bytes and
// the shard's histogram (the same loads, bins and scratch as above, the
// last block swapping the sums out), binarize_apply_kernel reads the
// summed histogram, scans it in every block and writes 255/0.
//
// Bound at 1080p: 6,220,800 B read and 6,220,800 B written (the frame
// once, the result once; the gray bytes and the histogram are
// intermediates), 0.00371 ms at 3.35 TB/s. The fused kernel moves no
// gray byte through device memory within the register budget and pays
// one launch; the floor of a call is one empty launch and one grid-wide
// barrier.

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
// runs of kPix pixels a thread of the fused kernel keeps in registers
// across its grid barrier: a 1080p frame on 132 SMs takes 1, a batched
// 1080p frame of B = 4 streams 4
constexpr int kRegRuns = 4;
constexpr unsigned long long kBarrierTimeoutNs = 2000000000ull;
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

// the 16 gray bytes of the run whose 48 bytes are w
__device__ __forceinline__ uint4 gray_run(const unsigned (&w)[12]) {
  unsigned g[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    g[k >> 2] |= gray_of(byte_of(w, 3 * k), byte_of(w, 3 * k + 1),
                         byte_of(w, 3 * k + 2))
                 << (8 * (k & 3));
  return make_uint4(g[0], g[1], g[2], g[3]);
}

// count a run's 16 gray bytes in the warp's bins (one add when all equal)
__device__ __forceinline__ void count_run(unsigned* bins, uint4 gv) {
  const unsigned g[4] = {gv.x, gv.y, gv.z, gv.w};
  const unsigned g0 = g[0] & 255u, rep = g0 * 0x01010101u;
  if (g[0] == rep && g[1] == rep && g[2] == rep && g[3] == rep) {
    atomicAdd(bins + g0, (unsigned)kPix);
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k)
      atomicAdd(bins + ((g[k >> 2] >> (8 * (k & 3))) & 255u), 1u);
  }
}

// The pixel of the ragged tail (threads 0-15) or of the run that
// straddles the region's end (threads 16-31) that this thread of a
// stream's first block takes, or -1.
__device__ __forceinline__ long long tail_pixel(long long npx,
                                                long long chunks,
                                                long long straddle) {
  if (threadIdx.x < kPix) {
    const long long tp = chunks * kPix + threadIdx.x;
    return tp < npx ? tp : -1;
  }
  if (threadIdx.x < 2 * kPix && straddle >= 0)
    return straddle * kPix + threadIdx.x - kPix;
  return -1;
}

// the run that straddles the region's end (a whole run), or -1
__device__ __forceinline__ long long straddling_run(long long rlen,
                                                    long long chunks) {
  return rlen % 48 && rlen / 48 < chunks ? rlen / 48 : -1;
}

__device__ __forceinline__ void zero_bins(unsigned (*sub)[kBins]) {
  uint4* s4 = reinterpret_cast<uint4*>(&sub[0][0]);
  for (int j = threadIdx.x; j < kWarps * kBins / 4; j += kHistThreads)
    s4[j] = make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// The block's sums of its warps' bins, as K4 makes them (kParts threads a
// bin, each over kWarps / kParts warps, then one thread a bin over the
// parts), added to sums[0..256) with one global atomic a nonzero bin.
__device__ __forceinline__ void add_block_sums(unsigned (*sub)[kBins],
                                               unsigned* sums) {
  __syncthreads();
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
    if (s) atomicAdd(sums + b, s);
  }
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
  const long long straddle = straddling_run(rlen, chunks);
  long long i = (long long)blockIdx.x * kHistThreads + threadIdx.x;
  if (i == straddle) i += stride;
  // the loads first: this thread's first 16 pixels, and in block 0 one
  // pixel a thread of the ragged tail and of the straddling run
  unsigned w[12];
  const bool first = i < chunks;
  if (first) load_run(frame, aligned, region, rlen, i, w);
  const long long tp =
      blockIdx.x == 0 ? tail_pixel(npx, chunks, straddle) : -1;
  const bool tail = tp >= 0;
  unsigned tb = 0, tg = 0, tr = 0;
  if (tail) {
    tb = src_byte(frame, region, rlen, 3 * tp);
    tg = src_byte(frame, region, rlen, 3 * tp + 1);
    tr = src_byte(frame, region, rlen, 3 * tp + 2);
  }

  zero_bins(sub);
  unsigned* bins = sub[threadIdx.x >> 5];
  for (bool have = first; have;) {
    const uint4 g = gray_run(w);
    reinterpret_cast<uint4*>(gray)[i] = g;
    count_run(bins, g);
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
  add_block_sums(sub, scratch);

  // the last block to finish moves the sums to `out` and leaves the
  // scratch zero for the next launch on this stream
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> done(
        scratch[kBins]);
    s_last = done.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x < kBins)
    out[threadIdx.x] = (int)atomicExch(scratch + threadIdx.x, 0u);
  if (s_last && threadIdx.x == 0) scratch[kBins] = 0;
}

// The threshold of the CPU top-2 scan over hist[0..256), computed by one
// warp (all 32 lanes call it); every lane returns it. The counts are read
// through L2 (ld.global.cg): the fused kernel's were added in its own
// launch, before its grid barrier.
__device__ __forceinline__ int top2_threshold(const int* __restrict__ hist,
                                              int lane) {
  int h[8];
  int lmax = -1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    h[k] = __ldcg(hist + 8 * lane + k);
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

// the run's 16 pixels against the threshold as 16 bits, bit k for pixel k
// (gray > t): a byte compare of 4 pixels at a time, whose 0xff / 0x00
// bytes a multiply gathers into 4 bits
__device__ __forceinline__ unsigned run_bits(uint4 gv, unsigned t) {
  const unsigned tt = t * 0x01010101u;
  const unsigned g[4] = {gv.x, gv.y, gv.z, gv.w};
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned c = __vcmpgtu4(g[q], tt) & 0x80808080u;
    m |= ((c * 0x00204081u) >> 28) << (4 * q);
  }
  return m;
}

// The table of store_warp: entry 64 r + m holds the 16 bytes of a chunk
// that starts r (0..2) bytes into a pixel and spans the 6 pixels whose
// bits are m, 255 for a set bit and 0 for a clear one, three bytes a
// pixel. Threads 0..191 of the block each make one entry.
__device__ __forceinline__ void make_store_table(uint4* lut) {
  if (threadIdx.x >= 3 * 64) return;
  const int r = threadIdx.x / 64, m = threadIdx.x % 64;
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if ((m >> ((r + j) / 3)) & 1) w[j >> 2] |= 0xffu << (8 * (j & 3));
  lut[threadIdx.x] = make_uint4(w[0], w[1], w[2], w[3]);
}

// The 255/0 bytes of a warp's 32 consecutive runs, lane l's run the l-th
// with bits m (run_bits), to o48, the first run's 48 output bytes (16-byte
// aligned): three coalesced 16-byte stores a lane, chunk 32 i + l of the
// warp's 1,536 bytes, each looked up from the bits of the 6 pixels it
// spans (two shuffles: they lie in one run or two).
__device__ __forceinline__ void store_warp(uint8_t* o48, unsigned m,
                                           int lane, const uint4* lut) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int b0 = 16 * (32 * i + lane);
    const int p0 = b0 / 3, r = b0 - 3 * p0;
    const int a = p0 >> 4;
    const unsigned ma = __shfl_sync(0xffffffffu, m, a);
    const unsigned mb = __shfl_sync(0xffffffffu, m, min(a + 1, 31));
    const unsigned m6 = ((ma | (mb << 16)) >> (p0 & 15)) & 63u;
    reinterpret_cast<uint4*>(o48)[32 * i + lane] = lut[64 * r + m6];
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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// streams x npx pixels at a stride of 3 npx bytes (frame and out), stream
// b's region at region + b * rlen; per_stream blocks a stream, each thread
// block_runs runs (ops/filters.py binarize_plan); spill holds 16 bytes a
// run of every stream when block_runs > kRegRuns; scratch holds streams x
// 256 sums and the arrival word, zero before the launch and after it
__global__ void __launch_bounds__(kHistThreads, 1)
    binarize_fused_kernel(const uint8_t* __restrict__ frame, long long npx,
                          int streams, const uint8_t* __restrict__ region,
                          long long rlen, uint8_t* __restrict__ out,
                          uint8_t* __restrict__ spill,
                          unsigned* __restrict__ scratch, int per_stream,
                          int block_runs) {
  __shared__ unsigned sub[kWarps][kBins];  // 32 KB: one histogram a warp
  __shared__ uint4 s_lut[3 * 64];          // store_warp's table
  __shared__ unsigned s_t;
  __shared__ int s_last;
  const int b = blockIdx.x / per_stream;  // this block's stream
  const int j = blockIdx.x % per_stream;  // and its place there
  const long long chunks = npx / kPix;
  const uint8_t* f = frame + 3 * npx * b;
  const uint8_t* rg = rlen ? region + rlen * b : nullptr;
  uint8_t* o = out + 3 * npx * b;
  const bool fal = ((uintptr_t)f & 15) == 0;
  const long long straddle = straddling_run(rlen, chunks);
  // this thread's run k is first + k * kHistThreads
  const long long first =
      (long long)j * block_runs * kHistThreads + threadIdx.x;
  unsigned* sums = scratch + (long long)b * kBins;
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrived(
      scratch[(long long)streams * kBins]);

  // the loads first: run 0, and in a stream's first block one pixel a
  // thread of the ragged tail and of the straddling run
  unsigned w[12];
  if (first < chunks && first != straddle)
    load_run(f, fal, rg, rlen, first, w);
  const long long tp = j == 0 ? tail_pixel(npx, chunks, straddle) : -1;
  const bool tail = tp >= 0;
  unsigned tb = 0, tg = 0, tr = 0;
  if (tail) {
    tb = src_byte(f, rg, rlen, 3 * tp);
    tg = src_byte(f, rg, rlen, 3 * tp + 1);
    tr = src_byte(f, rg, rlen, 3 * tp + 2);
  }

  make_store_table(s_lut);
  zero_bins(sub);
  unsigned* bins = sub[threadIdx.x >> 5];
  uint4 keep[kRegRuns];  // the gray bytes of runs 0..kRegRuns-1
#pragma unroll
  for (int k = 0; k < kRegRuns; ++k) {
    keep[k] = make_uint4(0, 0, 0, 0);
    const long long i = first + (long long)k * kHistThreads;
    if (k < block_runs && i < chunks && i != straddle) {
      if (k > 0) load_run(f, fal, rg, rlen, i, w);
      keep[k] = gray_run(w);
      count_run(bins, keep[k]);
    }
  }
  // past the register budget: the gray bytes wait in spill
  for (int k = kRegRuns; k < block_runs; ++k) {
    const long long i = first + (long long)k * kHistThreads;
    if (i < chunks && i != straddle) {
      load_run(f, fal, rg, rlen, i, w);
      const uint4 g = gray_run(w);
      count_run(bins, g);
      reinterpret_cast<uint4*>(spill)[(long long)b * chunks + i] = g;
    }
  }
  const unsigned tv = gray_of(tb, tg, tr);
  if (tail) atomicAdd(bins + tv, 1u);
  add_block_sums(sub, sums);

  // the grid barrier: every block's sums are in the scratch
  __syncthreads();
  if (threadIdx.x == 0) {
    arrived.fetch_add(1u, cuda::memory_order_release);
    const unsigned long long t0 = global_ns();
    while (arrived.load(cuda::memory_order_acquire) < gridDim.x) {
      __nanosleep(64);
      if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int t = top2_threshold(reinterpret_cast<const int*>(sums),
                                 threadIdx.x);
    if (threadIdx.x == 0) s_t = (unsigned)t;
  }
  __syncthreads();
  // the scan has read the sums: arrive again, the reply awaited only after
  // the stores below
  unsigned second = 0;
  if (threadIdx.x == 0)
    second = arrived.fetch_add(1u, cuda::memory_order_release);

  // 255/0: a warp whose 32 runs are whole stores them coalesced
  // (store_warp); a warp at the stream's end or at the straddling run
  // stores each run's 48 bytes from its thread (apply16)
  const unsigned t = s_t;
  const bool oal = ((uintptr_t)o & 15) == 0;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kRegRuns; ++k) {
    const long long i = first + (long long)k * kHistThreads;
    const bool have = k < block_runs && i < chunks && i != straddle;
    if (oal && __all_sync(0xffffffffu, have)) {
      store_warp(o + 48 * (i - lane), run_bits(keep[k], t), lane, s_lut);
    } else if (have) {
      uint8_t* p = o + 48 * i;
      apply16(keep[k], t, p, ((uintptr_t)p & 15) == 0);
    }
  }
  for (int k = kRegRuns; k < block_runs; ++k) {
    const long long i = first + (long long)k * kHistThreads;
    const bool have = i < chunks && i != straddle;
    uint4 g = make_uint4(0, 0, 0, 0);
    if (have)
      g = __ldcg(reinterpret_cast<const uint4*>(spill)
                 + (long long)b * chunks + i);
    if (oal && __all_sync(0xffffffffu, have)) {
      store_warp(o + 48 * (i - lane), run_bits(g, t), lane, s_lut);
    } else if (have) {
      uint8_t* p = o + 48 * i;
      apply16(g, t, p, ((uintptr_t)p & 15) == 0);
    }
  }
  if (tail) {
    const uint8_t v = tv > t ? 255 : 0;
    o[3 * tp] = v, o[3 * tp + 1] = v, o[3 * tp + 2] = v;
  }

  // the last block to have arrived twice empties the scratch, after every
  // block's scan (their releases, acquired here)
  if (threadIdx.x == 0) {
    s_last = second == 2 * gridDim.x - 1;
    if (s_last)
      cuda::atomic_thread_fence(cuda::memory_order_acquire,
                                cuda::thread_scope_device);
  }
  __syncthreads();
  if (s_last) {
    for (long long q = threadIdx.x; q < (long long)streams * kBins;
         q += kHistThreads)
      scratch[q] = 0;
    if (threadIdx.x == 0) arrived.store(0u, cuda::memory_order_relaxed);
  }
}

}  // namespace

extern "C" {

// The row-sharded path's launch 1 of K9 on `stream`: the gray bytes of
// the npx pixels of the BGR frame, whose first rlen bytes are read from
// region (rlen 0: no region), into gray[0..npx) (16-byte aligned) and
// their histogram into out[0..256), in one launch of `grid` blocks
// (ops/filters.py gray_hist_plan). scratch holds cvs_bin_scratch_words()
// words, zero before the launch and zero after it; launches that may
// overlap (other streams) each need their own. Returns the cudaError_t of
// the launch.
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

// The row-sharded path's launch 2 of K9 on `stream`: 255/0 by the
// threshold of hist[0..256) for each of the npx gray bytes, three times a
// pixel into out[0..3 npx), in one launch of `grid` blocks
// (ops/filters.py apply_plan). Returns the cudaError_t of the launch.
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

// K9 in one launch on `stream`: for each of `streams` streams b of npx
// pixels, the BGR frame at frame + 3 npx b, whose first rlen bytes are
// read from region + rlen b (rlen 0: no region), binarized by its own
// histogram's threshold into out + 3 npx b. A cooperative launch of
// streams x per_stream blocks of cvs_bin_hist_threads() threads, each
// thread block_runs runs of 16 pixels (ops/filters.py binarize_plan);
// spill holds 16 B a whole run of every stream, 16-byte aligned, where
// block_runs > cvs_bin_reg_runs() (else it may be null). scratch holds
// streams x 256 + 1 words, zero before the launch and zero after it;
// launches that may overlap (other streams) each need their own. Returns
// the cudaError_t of the launch: a grid larger than the card holds at once
// is refused (cudaErrorCooperativeLaunchTooLarge).
int cvs_binarize_fused(int device, const uint8_t* frame, long long npx,
                       int streams, const uint8_t* region, long long rlen,
                       uint8_t* out, uint8_t* spill, unsigned* scratch,
                       int per_stream, int block_runs, cudaStream_t stream) {
  if (npx <= 0 || streams <= 0 || per_stream <= 0 || block_runs <= 0
      || rlen < 0 || rlen > 3 * npx || (rlen && !region) || !scratch
      || (long long)streams * per_stream > 0x7fffffffLL
      || (long long)per_stream * block_runs * kHistThreads < npx / kPix
      || (block_runs > kRegRuns && (!spill || ((uintptr_t)spill & 15))))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(streams * per_stream));
  cfg.blockDim = dim3(kHistThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, binarize_fused_kernel, frame, npx, streams,
                         region, rlen, out, spill, scratch, per_stream,
                         block_runs);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The blocks of binarize_fused_kernel an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *n.
int cvs_bin_fused_blocks_per_sm(int device, int* n) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, binarize_fused_kernel, kHistThreads, 0);
}

int cvs_bin_reg_runs(void) { return kRegRuns; }

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_bin_hist_threads(void) { return kHistThreads; }

int cvs_bin_apply_threads(void) { return kApplyThreads; }

int cvs_bin_scratch_words(void) { return kScratchWords; }

int cvs_bin_pixels(void) { return kPix; }

}  // extern "C"
