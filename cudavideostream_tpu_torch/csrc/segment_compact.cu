// K5 on Hopper: the "segment" compaction scheme. The fused threshold diff
// + negative feedback + stable (ascending) compaction of K1, at whole-tile
// units, derived independently of K1 (this file shares no code with
// logcompact.cu) so that the two cross-check each other byte for byte.
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
// left sibling's holes, ~136 roll + select passes per tile. Its closed
// form is what a block can compute directly: an entry's final slot is its
// rank within its leaf plus, over every ancestor segment where it sits in
// the right half, the count of the left half. So, one block per tile:
//   1. each thread owns 16-byte groups (the leaves: 3,968 per tile at
//      1080p, padded to 4,096), and writes each leaf's count, the __popc
//      of its 16-bit ship mask, into a segment-count tree in shared memory
//      (heap order, leaves at P + l: 32 KB of int32 at P = 4,096);
//   2. an up-sweep fills the internal nodes, one level per barrier;
//   3. each thread recomputes its leaves' masks, walks each leaf's path to
//      the root adding the left sibling's count wherever the path turns
//      right, writes its entries straight to their slots, and writes
//      new_prev for its bytes (the same thread read them in step 1: no
//      other thread touches them, so the in-place update is safe);
//   4. the block zero-fills [count, unit_bytes) and writes counts[t].
// A tile of more than 64 KB (frames past ~131 MB) is walked in 64 KB
// chunks, each chunk's slots offset by the counts of the chunks before it.
//
// BATCHED (n_streams > 1; the TPU kernel's stream_tiles mode,
// logcompact.py:539,545,629, reached through
// fused_diff_compact_batched(scheme="segment")): B frames of n bytes at
// stride n, units_per_stream tiles each, one launch of B x units_per_stream
// blocks. Block b works on stream b / units_per_stream at its local tile,
// reads the stream's bytes only (its bytes past n never ship), emits
// stream-local indices (the TPU's i_s * n_flat rebase) into the output
// tile b, and its count into counts[b]; the map is shared, the region is
// per stream (strip s at region + s * region_len). At n % 16 != 0 the
// streams' bytes are not 16-byte aligned, and the vector loads and stores
// fall back to bytes. Its bound is B times the solo bound.
//
// Bound. Device-memory bytes: cur and prev read once (2n; the region
// stands in for the first region_len bytes of cur), new_prev (n), xs_t
// (4 n_pad) and vals_t (n_pad) written, counts (4 per tile): at 1080p
// 49,771,912 B, 14.86 us at 3.35 TB/s; 55,992,712 B, 16.71 us, with a map.
// This simple design rereads cur and prev in step 3 (from the 50 MB L2 at
// this size), writes entries with scattered 4-byte stores, and runs 98
// blocks on 132 SMs: it is a cross-check first, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLeafBytes = 16;
constexpr int kMaxLeaves = 4096;  // leaves of one chunk: a power of two
constexpr int kChunkBytes = kMaxLeaves * kLeafBytes;  // 65,536

union Leaf {
  uint4 v;
  uint8_t b[16];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Bytes [i0, i0 + 16) of src, zero at or past lim.
__device__ __forceinline__ Leaf fetch_leaf(const uint8_t* __restrict__ src,
                                           long long i0, long long lim) {
  Leaf r;
  if (i0 + kLeafBytes <= lim && aligned16(src + i0)) {
    r.v = __ldg(reinterpret_cast<const uint4*>(src + i0));
  } else {
#pragma unroll
    for (int k = 0; k < kLeafBytes; ++k)
      r.b[k] = i0 + k < lim ? src[i0 + k] : 0;
  }
  return r;
}

// The ship mask of the leaf at i0 (bit k = byte i0 + k), with its current
// bytes (the region where it covers them) in c and its previous bytes in
// p. prev is read through plain loads: this kernel writes it.
__device__ __forceinline__ unsigned leaf_mask(
    const uint8_t* __restrict__ cur, const uint8_t* prev,
    const uint8_t* __restrict__ region, long long region_len, long long n,
    int thr, const uint8_t* __restrict__ thr_map, long long i0, Leaf& c,
    Leaf& p) {
  c.v = make_uint4(0, 0, 0, 0);
  p.v = c.v;
  if (i0 >= n) return 0;
  if (i0 + kLeafBytes <= n && aligned16(prev + i0)) {
    p.v = *reinterpret_cast<const uint4*>(prev + i0);
  } else {
#pragma unroll
    for (int k = 0; k < kLeafBytes; ++k)
      if (i0 + k < n) p.b[k] = prev[i0 + k];
  }
  c = fetch_leaf(cur, i0, n);
  if (i0 < region_len) {
    const Leaf r = fetch_leaf(region, i0, region_len);
#pragma unroll
    for (int k = 0; k < kLeafBytes; ++k)
      if (i0 + k < region_len) c.b[k] = r.b[k];
  }
  Leaf t;
  if (thr_map != nullptr) t = fetch_leaf(thr_map, i0, n);
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < kLeafBytes; ++k) {
    const int d = abs(int(c.b[k]) - int(p.b[k]));
    if (d > (thr_map != nullptr ? int(t.b[k]) : thr)) m |= 1u << k;
  }
  return m;  // c == p == 0 past n: padding never ships
}

__global__ void __launch_bounds__(kThreads)
segment_kernel(const uint8_t* __restrict__ cur, uint8_t* prev,
               const uint8_t* __restrict__ region, long long region_len,
               long long n, int thr, const uint8_t* __restrict__ thr_map,
               int negfeed, int unit_bytes, int units_per_stream,
               int* __restrict__ counts, int* __restrict__ xs_t,
               uint8_t* __restrict__ vals_t) {
  // tree[k] = the count of segment k: the root at 1, node k's halves at
  // 2k and 2k + 1, leaf l at P + l
  __shared__ int tree[2 * kMaxLeaves];
  // this block's stream, whose bytes it reads at stream-local offsets
  const long long stream = blockIdx.x / units_per_stream;
  cur += stream * n;
  prev += stream * n;
  if (region_len) region += stream * region_len;
  const long long tile0 =  // the tile's first byte in its stream
      (long long)(blockIdx.x % units_per_stream) * unit_bytes;
  int* xs = xs_t + (long long)blockIdx.x * unit_bytes;
  uint8_t* vals = vals_t + (long long)blockIdx.x * unit_bytes;
  int before = 0;  // entries of this tile's earlier chunks
  for (int c0 = 0; c0 < unit_bytes; c0 += kChunkBytes) {
    const int chunk = min(kChunkBytes, unit_bytes - c0);
    const int leaves = chunk / kLeafBytes;
    int P = 1;
    while (P < leaves) P <<= 1;

    // 1. the leaves' counts (0 for the padding leaves past `leaves`)
    for (int l = threadIdx.x; l < P; l += kThreads) {
      int cnt = 0;
      if (l < leaves) {
        Leaf c, p;
        cnt = __popc(leaf_mask(cur, prev, region, region_len, n, thr,
                               thr_map, tile0 + c0 + l * kLeafBytes, c, p));
      }
      tree[P + l] = cnt;
    }
    __syncthreads();

    // 2. up-sweep: the segments of width 2W from those of width W
    for (int w = P >> 1; w >= 1; w >>= 1) {
      for (int k = w + threadIdx.x; k < 2 * w; k += kThreads)
        tree[k] = tree[2 * k] + tree[2 * k + 1];
      __syncthreads();
    }

    // 3. slots, entries and new_prev (leaf l is owned by thread l % 512
    //    in steps 1 and 3 alike)
    for (int l = threadIdx.x; l < leaves; l += kThreads) {
      const long long i0 = tile0 + c0 + l * kLeafBytes;
      Leaf c, p;
      const unsigned m = leaf_mask(cur, prev, region, region_len, n, thr,
                                   thr_map, i0, c, p);
      if (m != 0) {
        // the right half of a segment slides left past the left half's
        // holes: its entries land after the left half's count
        int slot = before;
        for (int node = P + l; node > 1; node >>= 1)
          if (node & 1) slot += tree[node - 1];
#pragma unroll
        for (int k = 0; k < kLeafBytes; ++k) {
          if ((m >> k) & 1u) {
            xs[slot] = (int)(i0 + k);
            vals[slot] = (uint8_t)(c.b[k] - p.b[k]);  // (c - p) mod 256
            ++slot;
          }
        }
      }
      if (i0 < n) {
        Leaf np;
#pragma unroll
        for (int k = 0; k < kLeafBytes; ++k)
          np.b[k] = (!negfeed || ((m >> k) & 1u)) ? c.b[k] : p.b[k];
        if (i0 + kLeafBytes <= n && aligned16(prev + i0)) {
          *reinterpret_cast<uint4*>(prev + i0) = np.v;
        } else {
#pragma unroll
          for (int k = 0; k < kLeafBytes; ++k)
            if (i0 + k < n) prev[i0 + k] = np.b[k];
        }
      }
    }
    before += tree[1];
    __syncthreads();  // every read of the tree precedes the next chunk's
  }

  // 4. the zero tail and the count
  for (int q = before + threadIdx.x; q < unit_bytes; q += kThreads) {
    xs[q] = 0;
    vals[q] = 0;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = before;
}

}  // namespace

extern "C" {

// Launch K5 on `stream`: one block per tile of unit_bytes (a multiple of
// 128), units_per_stream tiles covering each of the n_streams n-byte
// frames (1 for the solo scheme; see BATCHED above). counts holds
// n_streams * units_per_stream int32; xs_t and vals_t hold that many tiles
// of unit_bytes entries. region (n_streams strips of region_len bytes,
// each standing in for the first bytes of its stream's cur) and thr_map
// (n bytes, shared, which replaces thr) may be null; every byte pointer is
// 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
int cvs_segment_compact(int device, const uint8_t* cur, uint8_t* prev,
                        const uint8_t* region, long long region_len,
                        long long n, int thr, const uint8_t* thr_map,
                        int negfeed, int unit_bytes, int units_per_stream,
                        int n_streams, int* counts, int* xs_t,
                        uint8_t* vals_t, cudaStream_t stream) {
  const long long grid = (long long)units_per_stream * n_streams;
  if (unit_bytes <= 0 || unit_bytes % 128 || units_per_stream <= 0
      || n_streams <= 0 || grid > 0x7fffffffLL
      || (long long)unit_bytes * units_per_stream < n || region_len > n)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  segment_kernel<<<(int)grid, kThreads, 0, stream>>>(
      cur, prev, region, region_len, n, thr, thr_map, negfeed, unit_bytes,
      units_per_stream, counts, xs_t, vals_t);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
