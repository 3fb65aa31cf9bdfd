// K5 on Hopper: the "segment" compaction scheme. The fused threshold diff
// + negative feedback + stable (ascending) compaction of K1, at whole-tile
// units, derived independently of K1 and K6 (this file includes nothing of
// logcompact.cu, lookback.cuh or register_compact.cu) so that the three
// cross-check each other byte for byte.
//
// Replaces the TPU kernel cudavideostream_tpu/ops/logcompact.py:_kernel
// (the segment scheme, fused_diff_compact(scheme="segment"), dispatched at
// logcompact.py:707-712).
//
// What it computes, for every byte i of an n-byte frame padded to
// n_units * unit_bytes bytes (the JAX tile geometry at sub_rows = 0: 98
// tiles of 63,488 B at 1080p), with c = i < region_len ? region[i] : cur[i]
// and p = prev[i]:
//   * byte i ships iff |c - p| > thr, or > thr_map[i] with a per-byte map;
//     padding bytes (i >= n) never ship;
//   * tile t holds its shipped entries, ascending, at xs_t[t * unit_bytes
//     + slot] (the global index i) and vals_t[...] ((c - p) & 255), zeros
//     from its count to unit_bytes, and the count in counts[t] (int32);
//   * new_prev = shipped ? c : p under negative feedback, else c, written
//     into prev IN PLACE.
//
// The TPU scheme merges sibling segments level by level, W = 1, 2, 4, ...:
// the right sibling's compacted prefix slides left by W - c_L over the
// left sibling's holes. Its closed form is what is computed here: an
// entry's slot is its rank within its 16-byte leaf plus, over every
// ancestor segment where it sits in the right half, the count of the left
// half. The tree is cut across the card:
//   * one thread-block cluster of kCluster CTAs per tile (cudaLaunchKernelEx,
//     392 CTAs of 256 threads at 1080p, four an SM, so every SM works);
//     the tile's leaves go in rounds of kCluster chunks, chunk (q, r) to
//     CTA r: leaves [(q C + r) L / (C Q), (q C + r + 1) L / (C Q)) of the
//     tile's L, Q the fewest rounds whose chunks fit one CTA's kRoundLeaves
//     (one round up to frames of ~131 MB);
//   * warp w owns the chunk's leaves [32 kThreadLeaves w, 32 kThreadLeaves
//     (w + 1)), a subtree: its lane l takes leaf 32 j + l of that block
//     for j < kThreadLeaves, so each of the warp's 16-byte loads takes 32
//     consecutive leaves. A thread loads its leaves once (cur, prev, the
//     region or the map), computes their ship masks and deltas, and writes
//     new_prev at once (it read those bytes; no other thread touches them).
//     The masks and the delta bytes stay in its registers: nothing is read
//     twice;
//   * the tree's bottom levels, inside each group of 32 leaves, are walked
//     with warp shuffles: at each level a lane in the right half adds the
//     count of the left half; the next log2(kThreadLeaves) levels join the
//     warp's groups in registers, and the levels above the warps' nodes
//     come from one warp, stored in shared memory (heap order, warp w's
//     node at kWarps + w), whose path each warp walks once;
//   * the top log2(kCluster) levels, the counts of the CTAs before this
//     one, come through distributed shared memory: each CTA publishes its
//     root, and after a cluster barrier reads the others' (map_shared_rank)
//     and walks that small tree the same way;
//   * the entries are staged in slot order in shared memory (a 16-bit
//     offset in the chunk and the byte: 3 B a slot), shifted to the
//     output's 16-slot grid, and written with 16-byte stores (xs in 4-slot
//     vectors, vals in 16-slot vectors, only a run's ragged ends bytewise);
//   * each CTA writes one kCluster-th of the tile's zero tail [count,
//     unit_bytes) with 16-byte streaming stores; CTA 0 writes counts[t].
//     A last cluster barrier keeps every CTA's shared memory alive until
//     the others have read its counts.
//
// BATCHED (n_streams > 1; the TPU kernel's stream_tiles mode,
// logcompact.py:539,545,629, reached through
// fused_diff_compact_batched(scheme="segment")): B frames of n bytes at
// stride n, units_per_stream tiles each, one launch of B x
// units_per_stream clusters. Cluster b works on stream b /
// units_per_stream at its local tile, reads the stream's bytes only (its
// bytes past n never ship), emits stream-local indices (the TPU's i_s *
// n_flat rebase) into the output tile b and its count into counts[b]; the
// map is shared, the region is per stream (strip s at region + s *
// region_len). At n % 16 != 0 a stream's bytes are not 16-byte aligned:
// each leaf's loads and stores fall back to bytes, bounded both by n and
// by the leaf's 16 bytes. No scratch: nothing outlives a launch.
//
// Bound. Device-memory bytes: cur and prev read once (2n; the region
// stands in for the first region_len bytes of cur), new_prev (n), xs_t
// (4 n_pad) and vals_t (n_pad) written, counts (4 per tile): at 1080p
// 49,771,912 B, 14.86 us at 3.35 TB/s; 55,992,712 B, 16.71 us, with a map.
// Three fourths of it is the zero tail of xs_t and vals_t at the densities
// the cross-check runs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;  // CTAs of a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLeafBytes = 16;
constexpr int kThreadLeaves = 16 / kCluster;  // a thread's, per round
constexpr int kRoundLeaves = kThreads * kThreadLeaves;
constexpr int kRoundBytes = kRoundLeaves * kLeafBytes;
// a round's entries, shifted by up to 15 slots onto the output's grid
constexpr int kStageSlots = kRoundBytes + 16;
constexpr int kStageBytes = 3 * kStageSlots;  // uint16 offset + uint8 val
constexpr int kGroupBytes = 1024;  // the JAX tiles: multiples of 8 rows
// CTAs an SM holds (registers capped to fit): every cluster of a 1080p
// frame in one wave
constexpr int kCtasPerSm = 4;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kRoundBytes <= 65536, "a staged offset fits 16 bits");
static_assert(kStageSlots % 16 == 0, "the byte staging is 16-byte aligned");
static_assert((kThreadLeaves & (kThreadLeaves - 1)) == 0, "a subtree");
static_assert((kWarps & (kWarps - 1)) == 0 && kWarps <= 32, "a subtree");
static_assert((kGroupBytes / kLeafBytes) % kCluster == 0, "whole chunks");

struct Args {
  const uint8_t* cur;
  uint8_t* prev;
  const uint8_t* region;
  long long region_len;  // per stream
  long long n;           // per stream
  unsigned thr4;         // the scalar threshold in each byte
  const uint8_t* thr_map;
  int negfeed;
  int unit_bytes;
  int units_per_stream;
  int* counts;
  int* xs_t;
  uint8_t* vals_t;
};

union Leaf {
  uint4 v;
  unsigned w[4];
  uint8_t b[16];
};

// Bytes [i0, i0 + 16) of src, zero at or past lim: one 16-byte load where
// the leaf is whole and aligned, else bytes bounded by lim AND by the
// leaf's width (a batched stream's bytes end at n, mid-leaf). prev is
// read with plain loads (this kernel writes it); the rest through the
// read-only path.
template <bool kReadOnly>
__device__ __forceinline__ Leaf fetch_leaf(const uint8_t* src, long long i0,
                                           long long lim) {
  Leaf r;
  if (i0 + kLeafBytes <= lim && (((uintptr_t)(src + i0)) & 15) == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(src + i0);
    r.v = kReadOnly ? __ldg(p) : *p;
  } else {
#pragma unroll
    for (int k = 0; k < kLeafBytes; ++k)
      r.b[k] = i0 + k < lim ? src[i0 + k] : 0;
  }
  return r;
}

// bit k set iff byte k of a byte-SIMD compare result (0xff or 0) is set:
// the bytes' low bits gathered into bits 24..27 by one multiply
__device__ __forceinline__ unsigned gather4(unsigned s) {
  return ((s & 0x01010101u) * 0x01020408u) >> 24;
}

// byte k (0..15, a runtime value) of a leaf held in registers
__device__ __forceinline__ uint8_t leaf_byte(const Leaf& d, int k) {
  const unsigned w = (k & 8) ? ((k & 4) ? d.w[3] : d.w[2])
                             : ((k & 4) ? d.w[1] : d.w[0]);
  return (uint8_t)(w >> (8 * (k & 3)));
}

// The leaf at stream byte i0 (< n): loads it once (the region where it
// covers the leaf), writes its new_prev in place, and returns its ship
// mask (bit k = byte i0 + k) with its wrapped deltas in d.
__device__ __forceinline__ unsigned leaf_pass(const Args& a,
                                              const uint8_t* cur,
                                              uint8_t* prev,
                                              const uint8_t* region,
                                              long long i0, Leaf& d) {
  const Leaf p = fetch_leaf<false>(prev, i0, a.n);
  Leaf c;
  if (i0 + kLeafBytes <= a.region_len) {
    c = fetch_leaf<true>(region, i0, a.region_len);
  } else {
    c = fetch_leaf<true>(cur, i0, a.n);
    if (i0 < a.region_len) {  // the one leaf the region's end cuts
      const Leaf r = fetch_leaf<true>(region, i0, a.region_len);
#pragma unroll
      for (int k = 0; k < kLeafBytes; ++k)
        if (i0 + k < a.region_len) c.b[k] = r.b[k];
    }
  }
  Leaf t;
  if (a.thr_map != nullptr) {
    t = fetch_leaf<true>(a.thr_map, i0, a.n);  // 0 past n: never ships
  } else {
    t.v = make_uint4(a.thr4, a.thr4, a.thr4, a.thr4);
  }
  unsigned m = 0;
  Leaf np;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned ship =
        __vcmpgtu4(__vabsdiffu4(c.w[q], p.w[q]), t.w[q]);  // 0 past n
    m |= gather4(ship) << (4 * q);
    d.w[q] = __vsub4(c.w[q], p.w[q]);
    np.w[q] = a.negfeed ? (c.w[q] & ship) | (p.w[q] & ~ship) : c.w[q];
  }
  if (i0 + kLeafBytes <= a.n && (((uintptr_t)(prev + i0)) & 15) == 0) {
    *reinterpret_cast<uint4*>(prev + i0) = np.v;
  } else {
#pragma unroll
    for (int k = 0; k < kLeafBytes; ++k)
      if (i0 + k < a.n) prev[i0 + k] = np.b[k];
  }
  return m;
}

__device__ __forceinline__ void arrive_cluster() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void wait_cluster() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    segment_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  uint16_t* s_off = reinterpret_cast<uint16_t*>(s_dyn);
  uint8_t* s_val = s_dyn + 2 * kStageSlots;
  // tree[k]: the count of segment k of this CTA's chunk, the root at 1,
  // node k's halves at 2k and 2k + 1, warp w's leaves under kWarps + w
  __shared__ int tree[2 * kWarps];
  __shared__ int s_root[2];  // this CTA's chunk count, by round parity
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x / kCluster;
  // this cluster's stream, whose bytes it reads at stream-local offsets
  const long long stream = tile / a.units_per_stream;
  const uint8_t* cur = a.cur + stream * a.n;
  uint8_t* prev = a.prev + stream * a.n;
  const uint8_t* region = a.region_len ? a.region + stream * a.region_len
                                       : nullptr;
  const long long tile0 =  // the tile's first byte in its stream
      (tile % a.units_per_stream) * (long long)a.unit_bytes;
  int* xs = a.xs_t + tile * a.unit_bytes;
  uint8_t* vals = a.vals_t + tile * a.unit_bytes;
  const int leaves = a.unit_bytes / kLeafBytes;
  const int rounds = (leaves + kCluster * kRoundLeaves - 1)
                     / (kCluster * kRoundLeaves);

  int base = 0;  // the tile's entries of the rounds before this one
  for (int q = 0; q < rounds; ++q) {
    const int l0 = (int)((long long)(q * kCluster + rank) * leaves
                         / (kCluster * rounds));
    const int l1 = (int)((long long)(q * kCluster + rank + 1) * leaves
                         / (kCluster * rounds));
    const long long c0 = tile0 + (long long)l0 * kLeafBytes;  // chunk start

    // 1. the thread's leaves, read once: leaf j * 32 + lane of its warp's
    //    block of 32 kThreadLeaves leaves (a warp loads 32 consecutive)
    Leaf d[kThreadLeaves];
    unsigned m[kThreadLeaves];
    int cnt[kThreadLeaves];
    const int wl0 = warp * 32 * kThreadLeaves;
#pragma unroll
    for (int j = 0; j < kThreadLeaves; ++j) {
      const int l = wl0 + j * 32 + lane;  // leaf in the chunk
      const long long i0 = c0 + (long long)l * kLeafBytes;
      m[j] = 0;
      d[j].v = make_uint4(0, 0, 0, 0);
      if (l < l1 - l0 && i0 < a.n)
        m[j] = leaf_pass(a, cur, prev, region, i0, d[j]);
      cnt[j] = __popc(m[j]);
    }

    // 2. the warp's subtree: each group of 32 leaves walked by shuffles
    //    (at each level the left sibling's count, where the path turns
    //    right), then the levels that join the warp's groups
    int pre[kThreadLeaves], tot[kThreadLeaves];
#pragma unroll
    for (int j = 0; j < kThreadLeaves; ++j) {
      int x = cnt[j], p = 0;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int o = __shfl_xor_sync(kAll, x, s);
        if (lane & s) p += o;
        x += o;
      }
      pre[j] = p;
      tot[j] = x;
    }
    int v = 0;
#pragma unroll
    for (int w = 1; w < kThreadLeaves; w <<= 1) {
#pragma unroll
      for (int j = 0; j < kThreadLeaves; ++j) {
        if ((j / w) & 1) {
#pragma unroll
          for (int k = (j / w - 1) * w; k < (j / w) * w; ++k) pre[j] += tot[k];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kThreadLeaves; ++j) v += tot[j];

    // 3. up-sweep: the warps' nodes to the root by warp 0
    const int node = kWarps + warp;
    if (lane == 0) tree[node] = v;
    __syncthreads();
    if (warp == 0) {
      int x = lane < kWarps ? tree[kWarps + lane] : 0;
#pragma unroll
      for (int s = 1; s < kWarps; s <<= 1) {
        x += __shfl_xor_sync(kAll, x, s);
        if (lane < kWarps && (lane & (2 * s - 1)) == 0)
          tree[(kWarps + lane) / (2 * s)] = x;
      }
      if (lane == 0) s_root[q & 1] = x;  // published to the cluster
    }
    __syncthreads();
    arrive_cluster();

    // 4. the walk: left halves on the path from the warp's node to the root
    int slot = 0;
    for (int k = node; k > 1; k >>= 1)
      if (k & 1) slot += tree[k - 1];
    wait_cluster();

    // 5. the top of the path: the cluster's tree over its CTAs' counts,
    //    read from their shared memory; every warp walks it for `rank`
    int c = lane < kCluster
                ? *cluster.map_shared_rank(&s_root[q & 1], lane)
                : 0;
    int excl = 0;
#pragma unroll
    for (int s = 1; s < kCluster; s <<= 1) {
      const int left = __shfl_sync(kAll, c, max(0, (rank / s - 1) * s));
      if ((rank / s) & 1) excl += left;
      c += __shfl_xor_sync(kAll, c, s);
    }
    const int total = __shfl_sync(kAll, c, 0);  // the round's entries
    const int mine = s_root[q & 1];
    const int at = base + excl;  // this chunk's first slot in the tile
    const int shift = at & 15;

    // 6. stage the entries in slot order, on the output's 16-slot grid
#pragma unroll
    for (int j = 0; j < kThreadLeaves; ++j) {
      unsigned bits = m[j];
      int s = shift + slot + pre[j];
      const int off = (wl0 + j * 32 + lane) * kLeafBytes;
      while (bits) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        s_off[s] = (uint16_t)(off + k);
        s_val[s] = leaf_byte(d[j], k);
        ++s;
      }
    }
    __syncthreads();

    // 7. slots [at, at + mine) of the tile: 16-byte stores, the ragged
    //    ends of the run bytewise
    const int end = at + mine, g0 = at & ~15;  // g0: staging index 0
    const int ibase = (int)c0;
    for (int x = (at >> 2) + threadIdx.x; x < (end + 3) >> 2;
         x += kThreads) {
      const int lo = max(4 * x, at), hi = min(4 * x + 4, end);
      if (hi - lo == 4) {
        const uint2 o = *reinterpret_cast<const uint2*>(s_off + 4 * x - g0);
        *reinterpret_cast<int4*>(xs + 4 * x) =
            make_int4(ibase + (int)(o.x & 0xffffu), ibase + (int)(o.x >> 16),
                      ibase + (int)(o.y & 0xffffu), ibase + (int)(o.y >> 16));
      } else {
        for (int s = lo; s < hi; ++s) xs[s] = ibase + s_off[s - g0];
      }
    }
    for (int x = (at >> 4) + threadIdx.x; x < (end + 15) >> 4;
         x += kThreads) {
      const int lo = max(16 * x, at), hi = min(16 * x + 16, end);
      if (hi - lo == 16) {
        *reinterpret_cast<uint4*>(vals + 16 * x) =
            *reinterpret_cast<const uint4*>(s_val + 16 * x - g0);
      } else {
        for (int s = lo; s < hi; ++s) vals[s] = s_val[s - g0];
      }
    }
    base += total;
    // the next round's first barrier orders its tree and staging writes
    // after every thread's reads of this round's
  }

  // 8. this CTA's kCluster-th of the zero tail [base, unit_bytes)
  const long long free_slots = a.unit_bytes - base;
  const int lo = base + (int)(free_slots * rank / kCluster);
  const int hi = base + (int)(free_slots * (rank + 1) / kCluster);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int x = (lo >> 2) + threadIdx.x; x < (hi + 3) >> 2; x += kThreads) {
    if (4 * x >= lo && 4 * x + 4 <= hi) {
      __stcs(reinterpret_cast<uint4*>(xs + 4 * x), zero);
    } else {
      for (int s = max(4 * x, lo); s < min(4 * x + 4, hi); ++s) xs[s] = 0;
    }
  }
  for (int x = (lo >> 4) + threadIdx.x; x < (hi + 15) >> 4; x += kThreads) {
    if (16 * x >= lo && 16 * x + 16 <= hi) {
      __stcs(reinterpret_cast<uint4*>(vals + 16 * x), zero);
    } else {
      for (int s = max(16 * x, lo); s < min(16 * x + 16, hi); ++s) vals[s] = 0;
    }
  }
  if (rank == 0 && threadIdx.x == 0) a.counts[tile] = base;
  // the others may still read s_root: stay until every CTA has
  arrive_cluster();
  wait_cluster();
}

cudaLaunchConfig_t launch_config(long long n_units, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_units * kCluster), 1, 1);
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

cudaError_t prepare(int device) {
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(segment_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kStageBytes);
}

}  // namespace

extern "C" {

// Launch K5 on `stream`: one cluster of kCluster CTAs per tile of
// unit_bytes (a multiple of 1,024: the JAX tiles are multiples of 8 rows
// of 128), units_per_stream tiles covering each of the n_streams n-byte
// frames (1 for the solo scheme; see BATCHED above). counts holds
// n_streams * units_per_stream int32; xs_t and vals_t hold that many tiles
// of unit_bytes entries. region (n_streams strips of region_len bytes,
// each standing in for the first bytes of its stream's cur) and thr_map
// (n bytes, shared, which replaces thr) may be null; every byte pointer is
// 16-byte aligned. Returns the cudaError_t of the launch (0 on success); a
// cluster launch the card refuses returns its error.
int cvs_segment_compact(int device, const uint8_t* cur, uint8_t* prev,
                        const uint8_t* region, long long region_len,
                        long long n, int thr, const uint8_t* thr_map,
                        int negfeed, int unit_bytes, int units_per_stream,
                        int n_streams, int* counts, int* xs_t,
                        uint8_t* vals_t, cudaStream_t stream) {
  const long long n_units = (long long)units_per_stream * n_streams;
  if (unit_bytes <= 0 || unit_bytes % kGroupBytes || units_per_stream <= 0
      || n_streams <= 0 || n_units * kCluster > 0x7fffffffLL
      || (long long)unit_bytes * units_per_stream < n || region_len > n
      || thr < 0 || thr > 255)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(device);
  if (e != cudaSuccess) return (int)e;
  const Args a = {cur, prev, region, region_len, n,
                  (unsigned)thr * 0x01010101u, thr_map, negfeed, unit_bytes,
                  units_per_stream, counts, xs_t, vals_t};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(n_units, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, segment_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch's shape on `device`: CTAs per cluster, threads per CTA,
// dynamic shared memory per CTA, and the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 means no cluster fits).
int cvs_segment_plan(int device, int* cluster, int* threads, int* smem,
                     int* active_clusters) {
  cudaError_t e = prepare(device);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, 0, &attr);
  *cluster = kCluster;
  *threads = kThreads;
  *smem = kStageBytes;
  return (int)cudaOccupancyMaxActiveClusters(active_clusters, segment_kernel,
                                             &cfg);
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
