// K6 on Hopper: the "register" compaction scheme. The fused threshold diff
// + negative feedback + stable (ascending) compaction of K1, at whole-tile
// units, with ranks from warp ballots and a carried offset; a third
// derivation of K1's bytes, independent of logcompact.cu (nothing of it or
// of lookback.cuh is included) and of segment_compact.cu.
//
// Replaces the TPU kernel cudavideostream_tpu/ops/pallas_compact.py:_kernel
// (launched by run_register, pallas_compact.py:188; reached through
// fused_diff_compact(scheme="register"), logcompact.py:668-679). As there,
// it is a correctness cross-check, reached by no serving path.
//
// What it computes: as K5 (csrc/segment_compact.cu), with the scalar
// threshold only and no overlay region (the JAX package refuses both for
// this scheme, logcompact.py:671-675): tile t of unit_bytes (the JAX tile
// geometry at sub_rows = 0, 98 tiles of 63,488 B at 1080p) holds its
// shipped entries, ascending, at xs_t[t * unit_bytes + slot] / vals_t,
// zeros from its count to unit_bytes, the count in counts[t], and
// new_prev is written into prev in place.
//
// The TPU walks a tile's rows in order on one core, the offset carried in
// a register. Here one tile is one thread-block cluster of kCluster CTAs
// on neighbouring SMs (98 x 4 = 392 CTAs of 256 threads at 1080p, with
// the registers capped so that four fit an SM: every cluster of the frame
// in one wave, every SM busy with several warps), and the carried offset
// crosses CTAs through distributed shared memory:
//   * CTA r of the cluster takes band r of the tile, the 16-byte vectors
//     [r * V / kCluster, (r + 1) * V / kCluster) of its V (V is a multiple
//     of 64, so the bands are equal and none is empty: the 1,024-byte
//     unit gives each CTA 16 or 8 vectors);
//   * each thread loads kVec vectors of cur and prev with 16-byte loads,
//     finds its shipped bytes with byte-SIMD compares and ranks them by
//     warp ballots (the prefix of the lanes' counts, bit by bit) and a
//     scan of the warps' totals; the entries are staged in shared memory
//     (a 16-bit offset and the byte: 3 B an entry, 48 KB for the 16,384
//     bytes of a round);
//   * each CTA publishes its count in its shared memory; after a cluster
//     barrier each reads the counts of the CTAs ranked before it
//     (cluster.map_shared_rank): its exclusive offset excl_r, and the
//     tile's count. Nothing goes to global memory, no second launch;
//   * each CTA writes its entries at excl_r and its own band of the
//     tile's zero tail, [count + start_r - excl_r, count + end_r - incl_r)
//     for its byte band [start_r, end_r) and incl_r = excl_r + its count:
//     the bands tile [count, unit_bytes), and each CTA writes exactly as
//     many slots as it has bytes; 16-byte streaming stores for the tail;
//   * new_prev goes back in place with 16-byte stores: each thread owns
//     its bytes from load to store. CTA 0 writes counts[t]. A second
//     cluster barrier, split in arrive and wait, keeps every CTA's shared
//     memory alive until the others have read its count.
// A band longer than one round (units past 512 rows, frames over ~131
// MB) is walked twice: once to count, and once more after the exchange
// to rank, stage and write each round at its running offset.
//
// Bound. Device-memory bytes as K5's at the scalar threshold: cur and
// prev read, new_prev, xs_t (4 B a slot), vals_t and counts written:
// 49,771,912 B at 1080p, 14.86 us at 3.35 TB/s, most of it the zero
// tail of xs_t. On an H100 80GB HBM3 at 700 W a 1080p call takes 0.0254
// ms between CUDA events (tools/time_k1_flat.py register), 58% of the
// bound; clusters of 8 CTAs, and uncapped registers (92 clusters at once,
// fewer than a frame's 98), were slower there.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;  // CTAs of a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16 / kCluster;  // vectors a thread takes per round
constexpr int kRoundVecs = kThreads * kVec;
constexpr int kRoundBytes = kRoundVecs * 16;
constexpr int kGroupBytes = 1024;  // the JAX tiles: multiples of 8 rows
constexpr int kStageBytes = 3 * kRoundBytes;  // uint16 offset + uint8 val
constexpr unsigned kAll = 0xffffffffu;
// CTAs an SM holds: the registers are capped to fit them (64 a thread),
// so that one wave holds every cluster of a 1080p frame (98 of 4 CTAs)
constexpr int kCtasPerSm = 4;
static_assert(kVec * kWarps <= 32, "one warp scans a round's warp totals");
static_assert(kRoundBytes <= 65536, "a staged offset fits 16 bits");
static_assert((kGroupBytes / 16) % kCluster == 0, "bands of whole vectors");

// bits 0..3: the top bit of each byte of s (a byte-SIMD compare result)
__device__ __forceinline__ unsigned bits4(unsigned s) {
  return ((s & 0x80808080u) >> 7) * 0x00204081u >> 21 & 15u;
}

struct Args {
  const uint8_t* cur;
  uint8_t* prev;
  long long n;
  unsigned thr4;  // the threshold in each byte
  int negfeed;
  int aligned;  // cur and prev 16-byte aligned: vector loads and stores
  int unit_bytes;
  int* counts;
  int* xs_t;
  uint8_t* vals_t;
};

__device__ __forceinline__ uint4 load16(const uint8_t* p, long long i,
                                        long long n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + i));
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (i + j < n) w[j >> 2] |= (unsigned)p[i + j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(uint8_t* p, long long i, long long n,
                                        bool vec, uint4 v) {
  if (vec) {
    *reinterpret_cast<uint4*>(p + i) = v;
    return;
  }
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (i + j < n) p[i + j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
}

// Zeros over out[lo, hi) (out 16-byte aligned): 16-byte streaming stores
// between a ragged head and tail, the CTA's threads striding the words.
template <typename T>
__device__ __forceinline__ void zero_range(T* out, long long lo,
                                           long long hi) {
  constexpr int kPer = 16 / sizeof(T);
  if (lo >= hi) return;
  const long long a = min(hi, (lo + kPer - 1) / kPer * kPer);
  const long long b = max(a, hi / kPer * kPer);
  for (long long o = lo + threadIdx.x; o < a; o += kThreads) out[o] = 0;
  uint4* w = reinterpret_cast<uint4*>(out);
  for (long long j = a / kPer + threadIdx.x; j < b / kPer; j += kThreads)
    __stcs(&w[j], make_uint4(0, 0, 0, 0));
  for (long long o = b + threadIdx.x; o < hi; o += kThreads) out[o] = 0;
}

// Round [v0, v1) of the CTA's band, whose first vector is frame vector
// g0: load, find and rank the shipped bytes, and with `stage` write
// new_prev in place and stage the entries at their rank in the round
// (without it, the round is only counted: the first walk of a band of
// several rounds). Returns the round's count. Nothing of the round
// outlives it in registers: what the write-out needs is staged.
__device__ __forceinline__ int rank_round(const Args& a, long long g0,
                                          int v0, int v1, bool stage,
                                          int* s_tot, uint16_t* s_off,
                                          uint8_t* s_val) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;  // lanemask_lt
  uint4 c[kVec], p[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {  // every load in flight first
    const int v = v0 + k * kThreads + threadIdx.x;
    const long long i = (g0 + v - v0) * 16;
    c[k] = p[k] = make_uint4(0, 0, 0, 0);
    if (v < v1 && i < a.n) {
      const bool vec = a.aligned && i + 16 <= a.n;
      c[k] = load16(a.cur, i, a.n, vec);
      p[k] = load16(a.prev, i, a.n, vec);
    }
  }
  uint4 diff[kVec];  // the wrapped differences
  unsigned mask[kVec];  // bit j: byte j ships
  int pre[kVec];  // the lane's exclusive rank in its warp
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int v = v0 + k * kThreads + threadIdx.x;
    const long long i = (g0 + v - v0) * 16;
    const unsigned cw[4] = {c[k].x, c[k].y, c[k].z, c[k].w};
    const unsigned pw[4] = {p[k].x, p[k].y, p[k].z, p[k].w};
    unsigned nw[4], dw[4], m = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned ship = __vcmpgtu4(__vabsdiffu4(cw[q], pw[q]), a.thr4);
      m |= bits4(ship) << (4 * q);
      nw[q] = a.negfeed ? (cw[q] & ship) | (pw[q] & ~ship) : cw[q];
      dw[q] = __vsub4(cw[q], pw[q]);
    }
    if (stage && v < v1 && i < a.n)  // new_prev: its bytes, in place
      store16(a.prev, i, a.n, a.aligned && i + 16 <= a.n,
              make_uint4(nw[0], nw[1], nw[2], nw[3]));
    diff[k] = make_uint4(dw[0], dw[1], dw[2], dw[3]);
    mask[k] = m;
    // the warp's exclusive prefix of the lanes' counts (0..16), bit by
    // bit from ballots, and its total
    const int cnt = __popc(m);
    int lane_pre = 0, tot = 0;
#pragma unroll
    for (int bit = 0; bit < 5; ++bit) {
      const unsigned b = __ballot_sync(kAll, (cnt >> bit) & 1);
      lane_pre += __popc(b & below) << bit;
      tot += __popc(b) << bit;
    }
    pre[k] = lane_pre;
    if (lane == 0) s_tot[k * kWarps + warp] = tot;
  }
  __syncthreads();
  // the warps' totals in vector order (k, then warp): an exclusive scan
  // by warp 0, the round's count last
  if (warp == 0) {
    const int x = lane < kVec * kWarps ? s_tot[lane] : 0;
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane < kVec * kWarps) s_tot[32 + lane] = incl - x;
    if (lane == 31) s_tot[64] = incl;
  }
  __syncthreads();
  if (stage) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      unsigned m = mask[k];
      int slot = s_tot[32 + k * kWarps + warp] + pre[k];
      const int off = (k * kThreads + threadIdx.x) * 16;
      const uint4 d = diff[k];
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const unsigned w = j < 8 ? (j < 4 ? d.x : d.y) : (j < 12 ? d.z : d.w);
        s_off[slot] = (uint16_t)(off + j);
        s_val[slot] = (uint8_t)(w >> (8 * (j & 3)));
        ++slot;
      }
    }
  }
  const int count = s_tot[64];
  __syncthreads();  // the staging, before any thread reads it
  return count;
}

// The staged round, whose first vector is frame vector g0, at slots
// [at, at + count) of the tile; the staging is free again on return.
__device__ __forceinline__ void write_round(long long g0, int count,
                                           long long at, int* xs,
                                           uint8_t* vals,
                                           const uint16_t* s_off,
                                           const uint8_t* s_val) {
  const int base = (int)(g0 * 16);
  for (int s = threadIdx.x; s < count; s += kThreads) {
    xs[at + s] = base + s_off[s];
    vals[at + s] = s_val[s];
  }
  __syncthreads();
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    register_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t s_stage[];
  __shared__ int s_tot[65];  // warp totals, their scan, the round count
  __shared__ int s_count;    // this CTA's count, read by the cluster
  __shared__ int s_excl, s_total;
  uint16_t* s_off = reinterpret_cast<uint16_t*>(s_stage);
  uint8_t* s_val = s_stage + 2 * kRoundBytes;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long tile = blockIdx.x / kCluster;
  const int vecs = a.unit_bytes / 16;
  const int band0 = rank * (vecs / kCluster), band1 = band0 + vecs / kCluster;
  const long long first = tile * vecs + band0;  // the band's frame vector
  const int rounds = (band1 - band0 + kRoundVecs - 1) / kRoundVecs;
  int* xs = a.xs_t + tile * a.unit_bytes;
  uint8_t* vals = a.vals_t + tile * a.unit_bytes;

  int mine = 0;
  for (int q = 0; q < rounds; ++q) {
    const int v0 = q * kRoundVecs;
    mine += rank_round(a, first + v0, v0,
                       min(band1 - band0, v0 + kRoundVecs), rounds == 1,
                       s_tot, s_off, s_val);
  }

  // the carried offset across the cluster
  if (threadIdx.x == 0) s_count = mine;
  cluster.sync();
  if (threadIdx.x == 0) {
    int excl = 0, total = 0;
    for (int q = 0; q < kCluster; ++q) {
      const int c = *cluster.map_shared_rank(&s_count, q);
      excl += q < rank ? c : 0;
      total += c;
    }
    s_excl = excl;
    s_total = total;
  }
  __syncthreads();
  cluster_arrive();  // done with the other CTAs' shared memory
  const int excl = s_excl, total = s_total;

  if (rounds == 1) {
    write_round(first, mine, excl, xs, vals, s_off, s_val);
  } else {
    long long at = excl;
    for (int q = 0; q < rounds; ++q) {
      const int v0 = q * kRoundVecs, v1 = min(band1 - band0, v0 + kRoundVecs);
      const int c = rank_round(a, first + v0, v0, v1, true, s_tot, s_off,
                               s_val);
      write_round(first + v0, c, at, xs, vals, s_off, s_val);
      at += c;
    }
  }
  // this CTA's band of the tile's zero tail
  const long long lo = (long long)total + band0 * 16 - excl;
  const long long hi = (long long)total + band1 * 16 - (excl + mine);
  zero_range(xs, lo, hi);
  zero_range(vals, lo, hi);
  if (rank == 0 && threadIdx.x == 0) a.counts[tile] = total;
  cluster_wait();
}

cudaLaunchConfig_t launch_config(int n_units, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_units * kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kStageBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Launch K6 on `stream`: one cluster of kCluster CTAs per tile of
// unit_bytes (a multiple of 1,024: the JAX tiles are multiples of 8 rows
// of 128) over n_units tiles covering the n-byte frame. counts holds
// n_units int32; xs_t and vals_t hold n_units * unit_bytes entries.
// Returns the cudaError_t of the launch (0 on success); a cluster launch
// the card refuses (shared memory, cluster size) returns its error.
int cvs_register_compact(int device, const uint8_t* cur, uint8_t* prev,
                         long long n, int thr, int negfeed, int unit_bytes,
                         int n_units, int* counts, int* xs_t,
                         uint8_t* vals_t, cudaStream_t stream) {
  if (unit_bytes <= 0 || unit_bytes % kGroupBytes || n_units <= 0
      || (long long)unit_bytes * n_units < n || thr < 0 || thr > 255)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(register_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kStageBytes);
  if (e != cudaSuccess) return (int)e;
  const Args a = {cur, prev, n, (unsigned)thr * 0x01010101u, negfeed,
                  (((uintptr_t)cur | (uintptr_t)prev) & 15) == 0,
                  unit_bytes, counts, xs_t, vals_t};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(n_units, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, register_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch's shape on `device`: CTAs per cluster, threads per CTA,
// dynamic shared memory per CTA, and the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 means no cluster fits).
int cvs_register_plan(int device, int* cluster, int* threads, int* smem,
                      int* active_clusters) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(register_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kStageBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, 0, &attr);
  *cluster = kCluster;
  *threads = kThreads;
  *smem = kStageBytes;
  return (int)cudaOccupancyMaxActiveClusters(active_clusters, register_kernel,
                                             &cfg);
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
