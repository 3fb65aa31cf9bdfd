// K1 on Hopper: fused threshold diff + negative feedback + stable
// (ascending) stream compaction, in three emissions: flat, tiled
// (per-unit blocks), and tiled without index blocks (bitmask-only).
//
// Replaces the TPU kernel cudavideostream_tpu/ops/logcompact.py:_kernel_v2
// (dispatched by _run_kernel, called from fused_diff_compact): with
// emit="flat" together with the XLA tile merge _merge_tiles_impl that
// follows it, with emit="tiled" (sub_rows, logcompact.py:329-345 and
// :891-970), and with emit="mask" (emit_xs=False, emit_bits=True,
// logcompact.py:302-303, :508-513 and :839-849, at the mask geometry
// _tile_geometry_mask). The tiled emission can also write the packed bits
// beside the index blocks: the JAX pipeline packs those in an XLA pass
// after the kernel (pipeline.py:208-227, the --bitmask emission).
//
// What both compute, for every byte i of an n-byte frame, with
// c = i < region_len ? region[i] : cur[i] and p = prev[i]:
//   * byte i ships iff |c - p| > thr, computed in int (never in uint8);
//   * the value shipped is (c - p) & 255, with the index i;
//   * new_prev = shipped ? c : p under negative feedback, else c. It is
//     written into prev IN PLACE (the counterpart of the JAX buffer
//     donation); each byte of prev is read and written by the same thread
//     of the last kernel only, after every earlier read of it.
//
// FLAT emission (cvs_fused_diff_compact, flat_lookback_kernel):
//   * xs[k] / vals[k] hold the k-th shipped index / value, ascending;
//     pos (the count) goes to *pos_out;
//   * xs and vals are zero from pos to cap (the length of both buffers);
//     a frame that ships more than cap bytes writes only the first cap
//     entries, and the caller sees pos > cap.
// Bound. On an H100 the function is bound by device-memory bytes: it
// reads prev and cur (2n; the region stands in for the first region_len
// bytes of cur, which are never loaded) and writes new_prev (n), xs
// (4 * cap) and vals (cap), all full length because of the zero fill:
// about 8n at cap = n, 49.8 MB at 1080p (n = 6,220,800), or about 15 us
// at 3.35 TB/s. The zero tail [pos, cap) is most of it (about 28 MB at
// 10% shipped).
// Design. The TPU kernel's tile geometry, MXU prefix sums and shift passes
// exist for Mosaic; flat output is a global stable compaction and does not
// depend on them. A two-pass design (count, then compact) pays a second
// launch, reads every input byte twice, and sums every block's count in
// every block. This one is ONE launch that reads each input byte once,
// with decoupled look-back (csrc/lookback.cuh): a persistent grid
// (occupancy x SMs, cvs_flat_blocks: 3 blocks an SM under an 80-register
// cap) takes tiles of kFlatTile = 8,192 bytes in ascending order from a
// ticket. Per tile, each thread holds 2 groups of 16 bytes of cur (or the
// region), prev (and the map), loaded during the previous tile; it
// computes its groups' ship masks with byte-SIMD compares, stores new_prev
// at once (the only read of those prev bytes came just before, by the
// same thread: no look-back or tail loop reads prev), ranks its groups in
// the tile (one block scan of packed counts), publishes the tile's count,
// issues the next tile's loads, and stages (tile-local index as uint16,
// value) in 24 KB of dynamic shared memory. Warp 0 then looks back for the
// tile's offset, and the tile's entries go out coalesced at offset + rank,
// with the tile's band of the zero tail in 16-byte stores. The look-back
// chain, not the bytes, is what bounds it at 1080p, where the grid holds
// nearly every tile at once: every tile's offset waits on its slowest
// predecessor's loads, which is why the count goes out before anything
// else. No atomics decide where an entry goes: the order is ascending by
// construction.
//
// TILED emission (cvs_fused_diff_compact_tiled): the frame, padded to
// n_pad bytes (padding reads as cur == prev and never ships), is cut into
// n_pad / unit_bytes units, at the JAX package's geometry (the caller
// passes unit_bytes: 128 at the product default sub_rows = 1). Unit u
// holds its shipped entries, ascending, at xs_t[u * unit_bytes + rank]
// (global indices) and vals_t[...], zeros in the rest of its block, and
// its count in counts[u], narrowed to counts_bytes = 1, 2 or 4 bytes.
// pos = the sum of all counts. The order inside a unit is the byte order,
// so no pass ever looks across units, and no atomics decide where an
// entry goes.
// Design, units that divide the 4096-byte tile (unit_bytes <= 4096, a
// power of two: every sub_rows <= 32): ONE kernel a call,
// tiled_unit_kernel, one block per tile, one pass. Each thread issues its
// 16-byte loads first (nothing is zeroed in front of them) and masks its
// 16 bytes; a block scan (warp shuffle scan, then the 8 warp totals)
// gives every thread its exclusive prefix, and its rank in its unit is
// that prefix minus the prefix at the unit's first thread (8 threads per
// unit at 128-byte units). Entries are staged in shared memory at
// unit_start + rank, and the tile's 4096 slots of xs_t and vals_t are
// written out whole with 16-byte stores, each word cut to its unit's
// count and zero past it: the zero tail costs no extra pass and the
// staging is never zeroed. The unit's first thread writes its count.
// pos is folded into the same launch: thread 0 adds the block's total to
// its stream's word of a scratch that survives the launch, and the last
// block of each stream writes that stream's pos (add_stream_total). A
// second kernel for pos (one block summing the tile totals after the
// tiles) would pay a launch and its gap, which at a row shard's size
// (382 tiles) cost as much as the tiles themselves.
// Units larger than a tile (sub_rows = 0: 63,488-byte units at 1080p)
// take the flat two-pass design scoped to the unit:
// tiled_chunk_count_kernel counts each 4096-byte chunk of each unit;
// tiled_chunk_compact_kernel sums the counts of the chunks before it in
// its unit (its offset) and of the whole unit (the count), ranks, stages
// and writes its entries at offset + rank, zero-fills its own chunk's
// slots past the unit's count, and folds its chunk's total into pos the
// same way. No served path takes this one.
// Bound. Reads cur and prev (2n) and writes new_prev (n), xs_t (4 n_pad),
// vals_t (n_pad), counts (one to four bytes per unit) and pos: at 1080p
// and sub_rows = 1, 49,820,132 B, or 14.87 us at 3.35 TB/s. The
// one-pass design reads each byte once; the chunked design for whole-tile
// units rereads cur and prev, as the flat kernel does.
//
// PACKED BITS (both tiled entry points, `bits` not null): bit k of
// bits[j] is the ship mask of byte 8j + k, LSB-first over the n_pad bytes
// (the ops/diff.py pack_bitmask layout); padding bytes are 0. The TPU
// packs them with two MXU matmuls per tile (_pack_bits_block); here each
// thread already holds its 16-byte group's ship mask m (bit k = byte
// i0 + k), which IS that layout: one little-endian uint16 store at
// bits + i0 / 8, coalesced across the warp.
// BITMASK-ONLY (emit_xs = 0): the index blocks and their 16 KB of shared
// staging go away (a template parameter removes them). At 1080p
// (n_pad = 6,225,920 at the mask geometry, sub_rows = 1) it reads 2n and
// writes new_prev (n), vals_t (n_pad), bits (n_pad / 8), counts (n_pad /
// 128) and pos: 25,715,204 B, or 7.68 us at 3.35 TB/s, half the tiled
// emission's bytes.
//
// BATCHED (both tiled entry points, n_streams > 1; the TPU kernel's
// stream_tiles super-frame mode, logcompact.py:359-365 and :509, reached
// through fused_diff_compact_batched, :996-1117): B independent frames of n
// bytes each, stream b at cur + b * n and prev + b * n (stride n, no
// padding between streams), one launch over B x the solo grid. Every block
// works on one stream only, with the solo code at stream-local offsets:
// its bytes past n read as 0 (never ship), so stream b + 1's first bytes
// never reach stream b's padded tail. Stream b's units and blocks start at
// unit b * n_pad / unit_bytes and byte b * n_pad of the outputs; emitted
// indices are stream-local (the solo frame's global index: the TPU's
// i_s * n_flat rebase); the map, when given, is shared and read at the
// stream-local byte; the overlay region is per stream (B strips of
// region_len bytes, strip b at region + b * region_len); pos_out holds one
// int per stream, from one scratch word per stream (add_stream_total).
// Offsets are long long: B * n_pad passes 2^31 at B ~ 346 at 1080p. At
// n % 16 != 0 a stream's bytes are not 16-byte aligned; load16 and store_new_prev then take their byte
// loops. The stream arithmetic and those address checks are compiled into
// the batched instances only (template kBatched): the solo emissions keep
// their own code, whose buffers are always aligned. The bound is B times
// the solo tiled bound: 199,280,528 B at 1080p, B = 4, sub_rows = 1, or
// 59.49 us at 3.35 TB/s.
//
// THRESHOLD MAP (every entry point, thr_map not null; the TPU kernel's
// thr_is_map, logcompact.py:368 and :927-935): byte i ships iff
// |c - p| > thr_map[i], the map read at the byte's own index also where
// the region stands in for cur. It is one more 16-byte vector load in
// group_mask, the one place the tiled emissions' ship test lives, and in
// flat_load / flat_group, the flat kernel's, whose instance with the map
// (kMap) is apart so that the one without it holds no map registers; a
// null map keeps the scalar compare. Bytes past n read as c == p == 0 and
// never ship, whatever the map would hold there. The bound grows by n
// bytes read: K1 flat with a map moves 55,987,204 B at 1080p, 16.71 us at
// 3.35 TB/s.
//
// INDEX OFFSET (the flat and solo tiled entry points, index_offset; the TPU
// kernel's has_offset, logcompact.py:353 and :509): a host-known int added
// to every valid emitted index, so that a kernel launched on one row shard
// of a frame (the sharded pipeline, shard s at s * Ln) writes GLOBAL frame
// indices. It is added where an entry is staged, so the zero fill past
// each unit's count stays 0 (K2 and K3 test validity by vals != 0), and it
// costs one integer add per shipped byte: no load, no store, no branch.
// The entry points refuse index_offset < 0 and index_offset + n_pad past
// INT_MAX (indices stay int32); the batched launches take none, as the
// TPU's fused_diff_compact_batched takes none. The bytes are those of the
// launch without it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

namespace lb = cvs_lookback;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerThread = 16;
constexpr int kTileBytes = kThreads * kBytesPerThread;  // 4096
constexpr unsigned kFull = 0xffffffffu;

using Vec16 = lb::Vec16;

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Bytes [i0, i0 + 16) of src; bytes at or past lim read as 0. kCheck: src
// may be misaligned (a batched stream), so the vector load checks the
// address first.
template <bool kCheck>
__device__ __forceinline__ Vec16 load16(const uint8_t* __restrict__ src,
                                        long long i0, long long lim) {
  Vec16 r;
  if (i0 + 16 <= lim && (!kCheck || aligned16(src + i0))) {
    r.v = *reinterpret_cast<const uint4*>(src + i0);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) r.b[k] = (i0 + k < lim) ? src[i0 + k] : 0;
  }
  return r;
}

// Bytes [i0, i0 + 16) of the frame the diff sees (i0 < n): the overlay
// region over cur's first region_len bytes; bytes past n read as 0.
// kCheck as for load16.
template <bool kCheck>
__device__ __forceinline__ Vec16 load_cur16(const uint8_t* __restrict__ cur,
                                            const uint8_t* __restrict__ region,
                                            long long region_len, long long n,
                                            long long i0) {
  if (i0 + 16 <= region_len) return load16<kCheck>(region, i0, region_len);
  if (i0 >= region_len) return load16<kCheck>(cur, i0, n);
  Vec16 c;  // the group straddles the end of the overlay region
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    long long i = i0 + k;
    c.b[k] = i < region_len ? region[i] : (i < n ? cur[i] : 0);
  }
  return c;
}

// The 16-bit ship mask of the group of 16 bytes at i0 (bit k = byte
// i0 + k), with the current bytes (region-substituted) in c and the
// previous bytes in p. Bytes past n never ship. The threshold is thr, or
// with a per-byte map (thr_map not null) thr_map[i], read at the byte's
// own index also where the region stands in for cur. kCheck as for load16.
template <bool kCheck>
__device__ __forceinline__ unsigned group_mask(
    const uint8_t* __restrict__ cur, const uint8_t* prev,
    const uint8_t* __restrict__ region, long long region_len, long long n,
    int thr, const uint8_t* __restrict__ thr_map, long long i0, Vec16& c,
    Vec16& p) {
  if (i0 >= n) {
    c.v = make_uint4(0, 0, 0, 0);
    p.v = c.v;
    return 0;
  }
  p = load16<kCheck>(prev, i0, n);
  c = load_cur16<kCheck>(cur, region, region_len, n, i0);
  Vec16 t;
  if (thr_map != nullptr) t = load16<false>(thr_map, i0, n);  // shared
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    int d = int(c.b[k]) - int(p.b[k]);
    if ((d < 0 ? -d : d) > (thr_map != nullptr ? int(t.b[k]) : thr))
      m |= 1u << k;
  }
  return m;  // c == p == 0 past n, so those bytes never ship
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;
}

// Exclusive prefix of v over the block's threads; the block's total goes
// to total. Writes s_warp (kWarps ints) and ends with its barrier after
// the write: the caller must pass another barrier before s_warp is
// written again.
__device__ __forceinline__ int block_excl_scan(int v, int* s_warp,
                                               int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int wpre = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    int x = s_warp[w];
    if (w < warp) wpre += x;
    total += x;
  }
  return wpre + incl - v;
}

// new_prev for the 16 bytes at i0, in place: the calling thread read
// these bytes of prev, and no other thread of its kernel reads them.
// kCheck as for load16.
template <bool kCheck>
__device__ __forceinline__ void store_new_prev(uint8_t* prev, long long i0,
                                               long long n, unsigned m,
                                               const Vec16& c,
                                               const Vec16& p, int negfeed) {
  if (i0 >= n) return;
  Vec16 np;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    np.b[k] = (!negfeed || ((m >> k) & 1u)) ? c.b[k] : p.b[k];
  if (i0 + 16 <= n && (!kCheck || aligned16(prev + i0))) {
    *reinterpret_cast<uint4*>(prev + i0) = np.v;
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (i0 + k < n) prev[i0 + k] = np.b[k];
  }
}

// The count c of unit u, into counts narrowed to counts_bytes bytes.
__device__ __forceinline__ void store_count(void* counts, int counts_bytes,
                                            long long u, int c) {
  if (counts_bytes == 1)
    static_cast<uint8_t*>(counts)[u] = (uint8_t)c;
  else if (counts_bytes == 2)
    static_cast<int16_t*>(counts)[u] = (int16_t)c;
  else
    static_cast<int*>(counts)[u] = c;
}

// The group's ship mask m as bits [i0, i0 + 16) of the LSB-first bitmask
// (the caller keeps i0 < n_pad; bits is 2-byte aligned).
__device__ __forceinline__ void store_bits(uint8_t* bits, long long i0,
                                           unsigned m) {
  *reinterpret_cast<uint16_t*>(bits + i0 / 8) = (uint16_t)m;
}

// ---- flat emission: one pass with decoupled look-back -----------------

// 16-byte groups per thread per tile, and the blocks an SM must hold
// (the register cap)
constexpr int kFlatVecs = 2;
constexpr int kFlatMinBlocks = 3;
constexpr int kFlatTile = kTileBytes * kFlatVecs;  // 8,192 bytes
// staging per slot: the tile-local index (uint16) and the value
constexpr size_t kFlatSmem = 3 * (size_t)kFlatTile;
static_assert(kFlatTile <= 65536, "tile-local indices are uint16");

// The loads of the thread's groups of the tile at base, all issued before
// any is used: c (region-substituted cur), p (prev) and, with kMap, the
// map. Groups at or past n read as zeros (they never ship).
template <bool kMap>
__device__ __forceinline__ void flat_load(
    const uint8_t* __restrict__ cur, const uint8_t* prev,
    const uint8_t* __restrict__ region, long long region_len, long long n,
    const uint8_t* __restrict__ thr_map, long long base,
    Vec16 (&c)[kFlatVecs], Vec16 (&p)[kFlatVecs], Vec16 (&tm)[kFlatVecs]) {
#pragma unroll
  for (int q = 0; q < kFlatVecs; ++q) {
    const long long i0 = base + q * kTileBytes + threadIdx.x * kBytesPerThread;
    if (i0 >= n) {
      c[q].v = p[q].v = tm[q].v = make_uint4(0, 0, 0, 0);
      continue;
    }
    p[q] = load16<false>(prev, i0, n);
    c[q] = load_cur16<false>(cur, region, region_len, n, i0);
    if (kMap) tm[q] = load16<false>(thr_map, i0, n);
  }
}

// One group, four bytes at a time with byte-SIMD: returns the ship mask
// (bit k = byte k: |c - p| > the threshold, unsigned bytes, so never a
// uint8 wrap), writes new_prev into prev at i0 in place, and leaves the
// shipped values (c - p) & 255 in c.
template <bool kMap>
__device__ __forceinline__ unsigned flat_group(uint8_t* prev, long long i0,
                                               long long n, unsigned thr4,
                                               const Vec16& tm, int negfeed,
                                               Vec16& c, const Vec16& p) {
  const unsigned cw[4] = {c.v.x, c.v.y, c.v.z, c.v.w};
  const unsigned pw[4] = {p.v.x, p.v.y, p.v.z, p.v.w};
  const unsigned tw[4] = {tm.v.x, tm.v.y, tm.v.z, tm.v.w};
  unsigned m = 0, np[4], d[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned ship = __vcmpgtu4(__vabsdiffu4(cw[j], pw[j]),
                                     kMap ? tw[j] : thr4);  // 0xff: ships
    m |= (((ship & 0x80808080u) * 0x00204081u) >> 28) << (4 * j);
    np[j] = negfeed ? (cw[j] & ship) | (pw[j] & ~ship) : cw[j];
    d[j] = __vsub4(cw[j], pw[j]);
  }
  if (i0 < n) {
    Vec16 w;
    w.v = make_uint4(np[0], np[1], np[2], np[3]);
    if (i0 + 16 <= n) {
      *reinterpret_cast<uint4*>(prev + i0) = w.v;
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (i0 + k < n) prev[i0 + k] = w.b[k];
    }
  }
  c.v = make_uint4(d[0], d[1], d[2], d[3]);
  return m;  // c == p == 0 past n, so those bytes never ship
}

// The thread's groups of the tile at base, once loaded: ship masks, their
// counts, new_prev stored, and the shipped values in d (c and p stay
// free for the next tile's loads).
template <bool kMap>
__device__ __forceinline__ void flat_compute(
    uint8_t* prev, long long base, long long n, unsigned thr4, int negfeed,
    const Vec16 (&c)[kFlatVecs], const Vec16 (&p)[kFlatVecs],
    const Vec16 (&tm)[kFlatVecs], Vec16 (&d)[kFlatVecs],
    unsigned (&m)[kFlatVecs], int (&cnt)[kFlatVecs]) {
#pragma unroll
  for (int q = 0; q < kFlatVecs; ++q) {
    d[q] = c[q];
    m[q] = flat_group<kMap>(
        prev, base + q * kTileBytes + threadIdx.x * kBytesPerThread, n, thr4,
        tm[q], negfeed, d[q], p[q]);
    cnt[q] = __popc(m[q]);
  }
}

template <bool kMap>
__global__ void __launch_bounds__(kThreads, kFlatMinBlocks)
flat_lookback_kernel(const uint8_t* __restrict__ cur, uint8_t* prev,
                     const uint8_t* __restrict__ region, long long region_len,
                     long long n, int thr, const uint8_t* __restrict__ thr_map,
                     int negfeed, int index_offset,
                     unsigned long long* scratch, int* __restrict__ xs,
                     uint8_t* __restrict__ vals, long long cap,
                     int* __restrict__ pos_out) {
  constexpr int V = kFlatVecs;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s_vals = smem + 2 * kFlatTile;
  __shared__ unsigned s_warp[(V + 1) / 2 * kWarps];
  __shared__ long long s_off, s_next[2];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const lb::Scratch sc = lb::scratch_at(scratch);
  const long long tiles = (n + kFlatTile - 1) / kFlatTile;
  const unsigned thr4 = (unsigned)thr * 0x01010101u;

  if (t == 0) s_next[0] = atomicAdd(sc.ticket, 1u);
  __syncthreads();
  long long tile = s_next[0];
  Vec16 c[V], p[V], tm[V], d[V];
  unsigned m[V];
  int cnt[V];
  if (tile < tiles)
    flat_load<kMap>(cur, prev, region, region_len, n, thr_map,
                    tile * kFlatTile, c, p, tm);
  // s_next alternates between two words: the one written in this
  // iteration was last read two barriers ago
  for (int it = 1; tile < tiles; it ^= 1) {
    const long long base = tile * kFlatTile;
    flat_compute<kMap>(prev, base, n, thr4, negfeed, c, p, tm, d, m, cnt);
    if (t == 0) s_next[it] = atomicAdd(sc.ticket, 1u);
    int rank[V], total;
    lb::tile_ranks<V>(cnt, s_warp, rank, total);
    if (t == 0) lb::publish_count(sc.status, tile, total);
    // the next tile's loads fly while this one looks back, is staged and
    // goes out
    const long long next = s_next[it];
    if (next < tiles)
      flat_load<kMap>(cur, prev, region, region_len, n, thr_map,
                      next * kFlatTile, c, p, tm);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      int r = rank[q];
      const int local = q * kTileBytes + t * kBytesPerThread;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if ((m[q] >> k) & 1u) {
          s_idx[r] = (uint16_t)(local + k);
          s_vals[r] = d[q].b[k];
          ++r;
        }
      }
    }
    // warp 0 looks back once it has staged: by then the predecessors have
    // mostly published, and it spins little
    if (t < 32) {
      const long long off = lb::tile_offset(sc.status, tile, total);
      if (t == 0) {
        s_off = off;
        if (tile == tiles - 1) *pos_out = (int)(off + total);
      }
    }
    __syncthreads();
    const long long off = s_off;
    const long long room = cap - off;
    const int w = room <= 0 ? 0 : (total < room ? total : (int)room);
    const int idx0 = (int)base + index_offset;
    for (int j = t; j < w; j += kThreads) {
      xs[off + j] = idx0 + s_idx[j];
      vals[off + j] = s_vals[j];
    }
    long long lo, hi;
    lb::tail_band(base, base + kFlatTile < n ? base + kFlatTile : n, off,
                  total, n, cap, lo, hi);
    lb::zero_fill(xs, lo, hi);
    lb::zero_fill(vals, lo, hi);
    // No barrier before the next tile: its s_warp writes come after every
    // read of s_warp (before the barrier above), its staging after its
    // first barrier, which no thread passes before all have finished this
    // write-out, and s_off is read above, before it.
    tile = next;
  }
  lb::release_scratch(sc, tiles, &s_last);
}

// ---- tiled emission ----------------------------------------------------

// pos folded into the launch. Word b of `sums` (b the block's stream)
// packs two counts: above kDoneShift, how many of the stream's blocks
// have added their total; below it, the sum of those totals (a stream's
// pos is below 2^31, so no carry reaches the block count). Each block
// adds (1 << kDoneShift) | total in ONE atomic, as soon as its block scan
// has the total. The block whose atomic returns per_stream - 1 blocks
// before it is the stream's last: it writes pos_out[b] from the atomic's
// own value and zeroes the word for the next launch on this stream.
// Integer sums commute, so pos does not depend on the order in which
// blocks finish; and no fence is needed, since pos comes from the atomic
// alone and nothing else a block writes is read in this launch.
constexpr int kDoneShift = 32;

__device__ __forceinline__ void add_stream_total(unsigned long long* sums,
                                                 long long stream,
                                                 long long per_stream,
                                                 int total,
                                                 int* __restrict__ pos_out) {
  const unsigned long long old = atomicAdd(
      sums + stream, (1ull << kDoneShift) | (unsigned long long)total);
  if ((long long)(old >> kDoneShift) == per_stream - 1) {
    pos_out[stream] = (int)((unsigned)old + (unsigned)total);
    atomicExch(sums + stream, 0ull);
  }
}

// The first k bytes of x, zeros after them (0 <= k <= 16).
__device__ __forceinline__ uint4 keep_bytes(uint4 x, int k) {
  unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = k - 4 * j;
    if (kk <= 0) w[j] = 0;
    else if (kk < 4) w[j] &= (1u << (8 * kk)) - 1;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The first k ints of x, zeros after them (k <= 0: none).
__device__ __forceinline__ int4 keep_ints(int4 x, int k) {
  return make_int4(k > 0 ? x.x : 0, k > 1 ? x.y : 0, k > 2 ? x.z : 0,
                   k > 3 ? x.w : 0);
}

// One block per 4096-byte tile of one stream (tiles_per_stream blocks per
// stream); units of unit_bytes divide the tile. kXs: write the index
// blocks xs_t (false: the bitmask-only emission). kBatched: more than one
// stream (see BATCHED). bits: the packed ship mask, or null. sums: the
// streams' pos words (add_stream_total).
// Nothing stands in front of the loads: the staging is never zeroed.
// Each 16-byte output word keeps its unit's staged entries and writes
// zeros past the unit's count (keep_bytes, keep_ints), so the slots past
// a count are never read from shared memory.
template <bool kXs, bool kBatched>
__global__ void __launch_bounds__(kThreads)
tiled_unit_kernel(const uint8_t* __restrict__ cur, uint8_t* prev,
                  const uint8_t* __restrict__ region, long long region_len,
                  long long n, long long n_pad, int tiles_per_stream,
                  int thr, const uint8_t* __restrict__ thr_map, int negfeed,
                  int index_offset, int unit_bytes, int counts_bytes,
                  unsigned long long* sums, void* __restrict__ counts,
                  int* __restrict__ xs_t, uint8_t* __restrict__ vals_t,
                  uint8_t* __restrict__ bits, int* __restrict__ pos_out) {
  __shared__ __align__(16) int s_xs[kXs ? kTileBytes : 4];
  __shared__ __align__(16) uint8_t s_vals[kTileBytes];
  __shared__ int s_excl[kThreads + 1];
  __shared__ uint8_t s_keep[kXs ? kThreads : 1];
  __shared__ int s_warp[kWarps];
  const int t = threadIdx.x;
  // this block's stream; its inputs and outputs from here on are the
  // stream's own, at stream-local offsets
  long long out0 = 0, tile = blockIdx.x, stream = 0;
  if (kBatched) {
    stream = blockIdx.x / tiles_per_stream;
    tile = blockIdx.x % tiles_per_stream;
    cur += stream * n;
    prev += stream * n;
    if (region_len) region += stream * region_len;
    out0 = stream * n_pad;
    xs_t += out0;
    vals_t += out0;
    if (bits != nullptr) bits += out0 / 8;
  }
  const long long base = tile * kTileBytes;
  const long long i0 = base + t * kBytesPerThread;

  Vec16 c, p;
  const unsigned m = group_mask<kBatched>(cur, prev, region, region_len, n,
                                          thr, thr_map, i0, c, p);
  const int cnt = __popc(m);
  int total;
  const int excl = block_excl_scan(cnt, s_warp, total);
  s_excl[t] = excl;
  if (t == 0) {
    s_excl[kThreads] = total;
    add_stream_total(sums, stream, tiles_per_stream, total, pos_out);
  }
  __syncthreads();

  // rank in the unit: the block prefix minus the prefix at the unit's
  // first thread; the unit's slots start at that thread's first byte
  const int tpu = unit_bytes / kBytesPerThread;
  const int first = t - t % tpu;
  const int slot0 = first * kBytesPerThread;
  const int unit_count = s_excl[first + tpu] - s_excl[first];
  // the entries among this thread's 16 slots of the unit's block
  int keep = unit_count - (t - first) * kBytesPerThread;
  keep = keep < 0 ? 0 : (keep > 16 ? 16 : keep);
  if (kXs) s_keep[t] = (uint8_t)keep;
  int r = slot0 + excl - s_excl[first];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if ((m >> k) & 1u) {
      if (kXs) s_xs[r] = (int)(i0 + k + index_offset);
      s_vals[r] = (uint8_t)(c.b[k] - p.b[k]);  // (c - p) mod 256
      ++r;
    }
  }
  store_new_prev<kBatched>(prev, i0, n, m, c, p, negfeed);
  if (bits != nullptr && i0 < n_pad) store_bits(bits, i0, m);
  if (t == first && base + slot0 < n_pad)
    store_count(counts, counts_bytes, (out0 + base + slot0) / unit_bytes,
                unit_count);
  __syncthreads();

  // the tile's 4096 slots, entries and zero tails alike, in 16-byte words
  if (kXs) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int w = q * kThreads + t;
      if (base + 4 * w < n_pad)
        reinterpret_cast<int4*>(xs_t + base)[w] =
            keep_ints(reinterpret_cast<const int4*>(s_xs)[w],
                      s_keep[w >> 2] - 4 * (w & 3));
    }
  }
  if (i0 < n_pad)
    *reinterpret_cast<uint4*>(vals_t + i0) =
        keep_bytes(reinterpret_cast<const uint4*>(s_vals)[t], keep);
}

// Units larger than a tile: block b is chunk b % chunks_per_unit of unit
// U = b / chunks_per_unit, the unit's bytes [chunk * 4096, chunk * 4096 +
// 4096) cut at unit_bytes. U counts over every stream's units
// (units_per_stream each): the outputs are indexed by U, the inputs by
// the stream U / units_per_stream and its local unit.
template <bool kBatched>
__global__ void __launch_bounds__(kThreads)
tiled_chunk_count_kernel(const uint8_t* __restrict__ cur,
                         const uint8_t* __restrict__ prev,
                         const uint8_t* __restrict__ region,
                         long long region_len, long long n, int thr,
                         const uint8_t* __restrict__ thr_map,
                         int unit_bytes, int chunks_per_unit,
                         int units_per_stream,
                         int* __restrict__ chunk_counts) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long u = blockIdx.x / chunks_per_unit;
  if (kBatched) {
    const long long stream = u / units_per_stream;
    u %= units_per_stream;
    cur += stream * n;
    prev += stream * n;
    if (region_len) region += stream * region_len;
  }
  const int off = (blockIdx.x % chunks_per_unit) * kTileBytes +
                  threadIdx.x * kBytesPerThread;
  int cnt = 0;
  if (off < unit_bytes) {
    Vec16 c, p;
    cnt = __popc(group_mask<kBatched>(cur, prev, region, region_len, n, thr,
                                      thr_map, u * unit_bytes + off, c, p));
  }
  cnt = warp_sum(cnt);
  if (lane == 0) s_warp[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += s_warp[w];
    chunk_counts[blockIdx.x] = tot;
  }
}

template <bool kXs, bool kBatched>
__global__ void __launch_bounds__(kThreads)
tiled_chunk_compact_kernel(const uint8_t* __restrict__ cur, uint8_t* prev,
                           const uint8_t* __restrict__ region,
                           long long region_len, long long n, int thr,
                           const uint8_t* __restrict__ thr_map,
                           int negfeed, int index_offset, int unit_bytes,
                           int chunks_per_unit, int units_per_stream,
                           int counts_bytes,
                           const int* __restrict__ chunk_counts,
                           unsigned long long* sums,
                           void* __restrict__ counts,
                           int* __restrict__ xs_t,
                           uint8_t* __restrict__ vals_t,
                           uint8_t* __restrict__ bits,
                           int* __restrict__ pos_out) {
  __shared__ int s_xs[kXs ? kTileBytes : 1];
  __shared__ uint8_t s_vals[kTileBytes];
  __shared__ int s_warp[kWarps];
  __shared__ int s_red[2][kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long U = blockIdx.x / chunks_per_unit;  // over every stream
  const int chunk = blockIdx.x % chunks_per_unit;
  const long long ubase = U * unit_bytes;  // the unit's output slots
  // the unit's first byte in its stream's frame
  long long ulocal = ubase, stream = 0;
  if (kBatched) {
    stream = U / units_per_stream;
    cur += stream * n;
    prev += stream * n;
    if (region_len) region += stream * region_len;
    ulocal = (U % units_per_stream) * unit_bytes;
  }

  // this chunk's offset in its unit, and the unit's count
  int before = 0, unit_total = 0;
  for (int j = t; j < chunks_per_unit; j += kThreads) {
    const int v = chunk_counts[U * chunks_per_unit + j];
    unit_total += v;
    if (j < chunk) before += v;
  }
  before = warp_sum(before);
  unit_total = warp_sum(unit_total);
  if (lane == 0) {
    s_red[0][warp] = before;
    s_red[1][warp] = unit_total;
  }
  __syncthreads();
  before = 0;
  unit_total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += s_red[0][w];
    unit_total += s_red[1][w];
  }
  if (chunk == 0 && t == 0) store_count(counts, counts_bytes, U, unit_total);

  const int off = chunk * kTileBytes + t * kBytesPerThread;
  const long long i0 = ulocal + off;  // stream-local: the emitted index
  Vec16 c, p;
  unsigned m = 0;
  if (off < unit_bytes)
    m = group_mask<kBatched>(cur, prev, region, region_len, n, thr, thr_map,
                             i0, c, p);
  const int cnt = __popc(m);
  int chunk_total;
  int r = block_excl_scan(cnt, s_warp, chunk_total);
  if (t == 0)
    add_stream_total(sums, stream, (long long)units_per_stream * chunks_per_unit,
                     chunk_total, pos_out);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if ((m >> k) & 1u) {
      if (kXs) s_xs[r] = (int)(i0 + k + index_offset);
      s_vals[r] = (uint8_t)(c.b[k] - p.b[k]);
      ++r;
    }
  }
  if (off < unit_bytes) {
    store_new_prev<kBatched>(prev, i0, n, m, c, p, negfeed);
    if (bits != nullptr) store_bits(bits, ubase + off, m);
  }
  __syncthreads();
  for (int q = t; q < chunk_total; q += kThreads) {
    if (kXs) xs_t[ubase + before + q] = s_xs[q];
    vals_t[ubase + before + q] = s_vals[q];
  }
  // zero fill: this block owns its chunk's slots of the unit's block
  const int c0 = chunk * kTileBytes;
  const int z0 = unit_total > c0 ? unit_total : c0;
  const int z1 = unit_bytes < c0 + kTileBytes ? unit_bytes : c0 + kTileBytes;
  for (int o = z0 + t; o < z1; o += kThreads) {
    if (kXs) xs_t[ubase + o] = 0;
    vals_t[ubase + o] = 0;
  }
}

// The arguments of one tiled launch, as the entry point checked them.
struct TiledArgs {
  const uint8_t* cur;
  uint8_t* prev;
  const uint8_t* region;
  long long region_len, n, n_pad;
  int thr;
  const uint8_t* thr_map;
  int negfeed, index_offset, unit_bytes, counts_bytes;
  unsigned long long* sums;
  int* chunk_counts;
  void* counts;
  int emit_xs;
  int* xs_t;
  uint8_t* vals_t;
  uint8_t* bits;
  int* pos_out;
};

// Units that divide the tile: ONE kernel, tiled_unit_kernel, pos folded
// in (add_stream_total).
template <bool kBatched>
cudaError_t launch_tiled_unit(int grid, int per_stream, const TiledArgs& a,
                              cudaStream_t stream) {
  if (a.emit_xs)
    tiled_unit_kernel<true, kBatched><<<grid, kThreads, 0, stream>>>(
        a.cur, a.prev, a.region, a.region_len, a.n, a.n_pad, per_stream,
        a.thr, a.thr_map, a.negfeed, a.index_offset, a.unit_bytes,
        a.counts_bytes, a.sums, a.counts, a.xs_t, a.vals_t, a.bits,
        a.pos_out);
  else
    tiled_unit_kernel<false, kBatched><<<grid, kThreads, 0, stream>>>(
        a.cur, a.prev, a.region, a.region_len, a.n, a.n_pad, per_stream,
        a.thr, a.thr_map, a.negfeed, a.index_offset, a.unit_bytes,
        a.counts_bytes, a.sums, a.counts, nullptr, a.vals_t, a.bits,
        a.pos_out);
  return cudaGetLastError();
}

// Units larger than a tile: the chunk counts, then the compaction, pos
// folded into the second kernel (add_stream_total).
template <bool kBatched>
cudaError_t launch_tiled_chunks(int grid, const TiledArgs& a,
                                cudaStream_t stream) {
  const int chunks_per_unit = (a.unit_bytes + kTileBytes - 1) / kTileBytes;
  const int units_per_stream = (int)(a.n_pad / a.unit_bytes);
  tiled_chunk_count_kernel<kBatched><<<grid, kThreads, 0, stream>>>(
      a.cur, a.prev, a.region, a.region_len, a.n, a.thr, a.thr_map,
      a.unit_bytes, chunks_per_unit, units_per_stream, a.chunk_counts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.emit_xs)
    tiled_chunk_compact_kernel<true, kBatched><<<grid, kThreads, 0, stream>>>(
        a.cur, a.prev, a.region, a.region_len, a.n, a.thr, a.thr_map,
        a.negfeed, a.index_offset, a.unit_bytes, chunks_per_unit,
        units_per_stream, a.counts_bytes, a.chunk_counts, a.sums, a.counts,
        a.xs_t, a.vals_t, a.bits, a.pos_out);
  else
    tiled_chunk_compact_kernel<false, kBatched><<<grid, kThreads, 0,
                                                  stream>>>(
        a.cur, a.prev, a.region, a.region_len, a.n, a.thr, a.thr_map,
        a.negfeed, a.index_offset, a.unit_bytes, chunks_per_unit,
        units_per_stream, a.counts_bytes, a.chunk_counts, a.sums, a.counts,
        nullptr, a.vals_t, a.bits, a.pos_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The flat kernel's persistent grid on `device` (blocks per SM at its
// shared memory, times the SM count), with the map (has_map) or without;
// sets the attribute that admits its dynamic shared memory there.
int cvs_flat_blocks(int device, int has_map, int* blocks) {
  return (int)(has_map
                   ? lb::persistent_blocks(device, flat_lookback_kernel<true>,
                                           kFlatSmem, blocks)
                   : lb::persistent_blocks(device, flat_lookback_kernel<false>,
                                           kFlatSmem, blocks));
}

int cvs_flat_tile_bytes(void) { return kFlatTile; }

// Launch K1's flat emission on `stream`: ONE kernel, grid blocks (at most
// cvs_flat_blocks' count, after that call on this device). `scratch` holds
// 2 + ceil(n / cvs_flat_tile_bytes()) zeroed 8-byte words that no launch
// on another stream uses (see csrc/lookback.cuh); the launch leaves them
// zero. thr_map, when not null, is the per-byte threshold map (n bytes,
// 16-byte aligned) and replaces thr. index_offset is added to every valid
// index (see INDEX OFFSET). xs and vals hold cap <= n entries and are
// 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
int cvs_fused_diff_compact(int device, const uint8_t* cur, uint8_t* prev,
                           const uint8_t* region, long long region_len,
                           long long n, int thr, const uint8_t* thr_map,
                           int negfeed, int index_offset, int grid,
                           unsigned long long* scratch, int* xs,
                           uint8_t* vals, long long cap, int* pos_out,
                           cudaStream_t stream) {
  if (index_offset < 0 || index_offset + n > 0x7fffffffLL || n < 1
      || grid < 1 || cap < 0 || cap > n || region_len > n
      || ((uintptr_t)xs & 15) || ((uintptr_t)vals & 15))
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (thr_map != nullptr)
    flat_lookback_kernel<true><<<grid, kThreads, kFlatSmem, stream>>>(
        cur, prev, region, region_len, n, thr, thr_map, negfeed,
        index_offset, scratch, xs, vals, cap, pos_out);
  else
    flat_lookback_kernel<false><<<grid, kThreads, kFlatSmem, stream>>>(
        cur, prev, region, region_len, n, thr, thr_map, negfeed,
        index_offset, scratch, xs, vals, cap, pos_out);
  return (int)cudaGetLastError();
}

// The blocks of the tiled emission's one kernel (with index blocks, one
// stream) that one wave on `device` holds: its occupancy times the SM
// count. No launch needs it; it says how many waves a frame's tiles are.
int cvs_tiled_wave(int device, int* blocks) {
  return (int)lb::persistent_blocks(device, tiled_unit_kernel<true, false>,
                                    0, blocks);
}

// Chunk-count ints that a tiled launch needs per stream: none when
// unit_bytes divides the tile (the unit path, one kernel), else one per
// chunk of a unit.
int cvs_tiled_chunks(long long n_pad, int unit_bytes) {
  if (kTileBytes % unit_bytes == 0) return 0;
  const int chunks_per_unit = (unit_bytes + kTileBytes - 1) / kTileBytes;
  return (int)(n_pad / unit_bytes * chunks_per_unit);
}

// Launch K1 with tiled emission on `stream`, over n_streams frames of n
// bytes each (1 for the solo emission; see BATCHED above): ONE kernel when
// unit_bytes divides 4096, the count and the compaction kernels when it
// does not. n_pad is a multiple of unit_bytes, which is a multiple of 16;
// `sums` holds n_streams zeroed 8-byte words that no launch on another
// stream uses (the streams' pos, folded into the launch; it leaves them
// zero); chunk_counts holds n_streams * cvs_tiled_chunks(n_pad,
// unit_bytes) ints (null when that is 0); counts has n_streams * n_pad /
// unit_bytes entries of counts_bytes bytes; vals_t has n_streams * n_pad
// entries, and so has xs_t when emit_xs is nonzero (it may be null
// otherwise); bits, when not null, has n_streams * n_pad / 8 bytes and is
// 2-byte aligned; region holds n_streams strips of region_len bytes;
// thr_map as for cvs_fused_diff_compact; pos_out has n_streams ints;
// index_offset as for cvs_fused_diff_compact, 0 when n_streams > 1.
// Returns the cudaError_t of the launches (0 on success).
int cvs_fused_diff_compact_tiled(int device, const uint8_t* cur,
                                 uint8_t* prev, const uint8_t* region,
                                 long long region_len, long long n,
                                 long long n_pad, int n_streams, int thr,
                                 const uint8_t* thr_map, int negfeed,
                                 int index_offset, int unit_bytes,
                                 int counts_bytes, unsigned long long* sums,
                                 int* chunk_counts, void* counts,
                                 int emit_xs, int* xs_t, uint8_t* vals_t,
                                 uint8_t* bits, int* pos_out,
                                 cudaStream_t stream) {
  if (unit_bytes <= 0 || unit_bytes % kBytesPerThread || n_pad % unit_bytes
      || n_pad < n || n_streams < 1 || region_len > n
      || (counts_bytes != 1 && counts_bytes != 2 && counts_bytes != 4)
      || (emit_xs && xs_t == nullptr) || ((uintptr_t)bits & 1)
      || index_offset < 0 || index_offset + n_pad > 0x7fffffffLL
      || (index_offset && n_streams > 1) || sums == nullptr
      || (cvs_tiled_chunks(n_pad, unit_bytes) && chunk_counts == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const bool unit = kTileBytes % unit_bytes == 0;
  const long long per_stream =
      unit ? (n_pad + kTileBytes - 1) / kTileBytes
           : cvs_tiled_chunks(n_pad, unit_bytes);
  const long long grid = (long long)n_streams * per_stream;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const TiledArgs a{cur, prev, region, region_len, n, n_pad, thr, thr_map,
                    negfeed, n_streams > 1 ? 0 : index_offset, unit_bytes,
                    counts_bytes, sums, chunk_counts, counts, emit_xs, xs_t,
                    vals_t, bits, pos_out};
  if (unit)
    e = n_streams > 1
            ? launch_tiled_unit<true>((int)grid, (int)per_stream, a, stream)
            : launch_tiled_unit<false>((int)grid, (int)per_stream, a, stream);
  else
    e = n_streams > 1 ? launch_tiled_chunks<true>((int)grid, a, stream)
                      : launch_tiled_chunks<false>((int)grid, a, stream);
  return (int)e;
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_tile_bytes(void) { return kTileBytes; }

}  // extern "C"
