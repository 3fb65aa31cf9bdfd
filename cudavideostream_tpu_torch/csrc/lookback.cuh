// One-launch, one-read stable compaction on Hopper: the machinery that K1's
// flat emission (csrc/logcompact.cu) and K2 (csrc/pair_compact.cu) share.
//
// A flat compaction writes entry k of its output at the count of the kept
// entries before it, so every tile of the input needs the sum of the
// counts of all tiles before it. The two-pass design (count every tile,
// then sum the counts and compact) reads its input twice and pays a
// second launch; this one does it in one pass with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016):
//
//   * Tickets. A block takes tiles from an atomic ticket in scratch, so
//     tiles are handed out in ascending order: every predecessor of the
//     tile a block holds is already held by a running block, and a
//     look-back never waits on a block that has not been scheduled. The
//     ticket decides which block works next, never where an entry lands:
//     the output order is the input order by construction.
//   * Status words. A tile publishes its count (an aggregate) as soon as
//     its block scan has it, and once it knows its exclusive prefix, its
//     inclusive prefix: flag and value in one 64-bit store, so a reader
//     never sees one without the other.
//   * Pipeline. A block takes its next ticket with each tile and issues
//     the next tile's loads right after the block scan, so they fly while
//     the tile looks back, is staged and goes out.
//   * Look-back. Once its block has staged the tile, warp 0 reads kLook x
//     32 predecessors' words in one round trip (lane i reads tiles
//     tile-1-i-32k), waits only for the words nearer than the nearest
//     inclusive prefix, sums the aggregates back to it, and publishes its
//     own. Looking back later spins less: a warp that spins on words not
//     yet published loads the L2 for every block.
//   * The zero tail [pos, cap) needs pos, which a single pass learns only
//     at its last tile; waiting for it would put the tail's writes, most
//     of the output bytes, after every tile's. A tile knows more than its
//     offset, though: once it has its inclusive prefix incl_t, at most
//     n - end_t entries can follow it, so every slot from incl_t + (n -
//     end_t) on is past pos, and so is every slot from excl_t + (n -
//     start_t) on by its predecessor's account. Tile t zero-fills the
//     band between the two (tail_band): as many slots as it has entries
//     that do not ship, beside its own entries, at once. The bands of all
//     tiles tile [pos, n) exactly, cut at cap; no block waits for pos.
//   * Scratch survives the launch: word 0 the ticket, word 1 the count of
//     blocks done, word 2 + t the status of tile t. It is zero at every
//     launch: the host zeroes it once when it allocates it, and the last
//     block of every launch, after every block has passed its last read
//     of it, zeroes what the launch used. Launches that can overlap (two
//     streams) must never share it: the host keys it by (device, stream).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cvs_lookback {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLook = 4;  // look-back window: kLook x 32 tiles a round trip
constexpr unsigned kFull = 0xffffffffu;

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 1ull << 63;
constexpr unsigned long long kValue = kAggregate - 1;

union Vec16 {
  uint4 v;
  uint8_t b[16];
  int i[4];
};

struct Scratch {
  unsigned* ticket;
  unsigned* done;
  unsigned long long* status;
};

__device__ __forceinline__ Scratch scratch_at(unsigned long long* s) {
  Scratch r;
  r.ticket = reinterpret_cast<unsigned*>(s);
  r.done = reinterpret_cast<unsigned*>(s + 1);
  r.status = s + 2;
  return r;
}

__device__ __forceinline__ void publish(unsigned long long* w,
                                        unsigned long long flag,
                                        long long v) {
  *reinterpret_cast<volatile unsigned long long*>(w) =
      flag | (unsigned long long)v;
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* w) {
  return *reinterpret_cast<const volatile unsigned long long*>(w);
}

// The sum of v over the warp, in every lane.
__device__ __forceinline__ long long warp_total(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// The 16-bit mask of the nonzero bytes of x (bit k: byte k).
__device__ __forceinline__ unsigned nonzero_bits(const uint4& x) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // 0x80 in each byte of w that is nonzero, gathered to 4 bits
    const unsigned hi = (__vcmpne4(w[j], 0u) & 0x80808080u) * 0x00204081u;
    m |= (hi >> 28) << (4 * j);
  }
  return m;
}

// Ranks in a tile of V groups per thread, group q of thread t holding tile
// positions [q * kThreads * 16 + t * 16, + 16): cnt[q] (at most 16) kept
// entries each, ranked in position order (group major, thread minor).
// rank[q] is the exclusive rank of the thread's group q, total the tile's
// count. Two groups share one 32-bit word of 16-bit fields (a group's
// total is at most 4,096). Writes s_warp ((V + 1) / 2 * kWarps words)
// and ends with its barrier after the writes: the caller passes another
// barrier before s_warp is written again.
template <int V>
__device__ __forceinline__ void tile_ranks(const int (&cnt)[V],
                                           unsigned* s_warp, int (&rank)[V],
                                           int& total) {
  constexpr int P = (V + 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned w[P], incl[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    w[p] = (unsigned)cnt[2 * p] |
           (2 * p + 1 < V ? (unsigned)cnt[2 * p + 1] << 16 : 0u);
    incl[p] = w[p];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl[p], d);
      if (lane >= d) incl[p] += y;
    }
    if (lane == 31) s_warp[p * kWarps + warp] = incl[p];
  }
  __syncthreads();
  int acc = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    unsigned pre = 0, tot = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const unsigned x = s_warp[p * kWarps + j];
      if (j < warp) pre += x;
      tot += x;
    }
    const unsigned excl = pre + incl[p] - w[p];
    rank[2 * p] = acc + (int)(excl & 0xffffu);
    acc += (int)(tot & 0xffffu);
    if (2 * p + 1 < V) {
      rank[2 * p + 1] = acc + (int)(excl >> 16);
      acc += (int)(tot >> 16);
    }
  }
  total = acc;
}

// Thread 0 of the block that holds `tile`, as soon as it knows the tile's
// count agg (before it stages or loads anything else, so that no
// successor's look-back waits on that): publishes it, as the inclusive
// prefix for tile 0.
__device__ __forceinline__ void publish_count(unsigned long long* status,
                                             long long tile, long long agg) {
  publish(status + tile, tile == 0 ? kInclusive : kAggregate, agg);
}

// Warp 0 of the block that holds `tile`, whose count agg it has published:
// looks back for the exclusive prefix, publishes the inclusive prefix and
// returns the exclusive one (in every lane).
__device__ __forceinline__ long long tile_offset(unsigned long long* status,
                                                 long long tile,
                                                 long long agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) return 0;
  long long excl = 0;
  for (long long j0 = tile - 1;; j0 -= 32 * kLook) {
    unsigned long long s[kLook];
    // every load of the window first, so that they share one round trip;
    // tiles before tile 0 read as an inclusive prefix of 0
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      const long long j = j0 - lane - 32 * k;
      s[k] = j >= 0 ? peek(status + j) : kInclusive;
    }
    while (true) {
      // distance k * 32 + lane: the nearest inclusive prefix, and the
      // nearest word not yet published
      int near = 0x7fffffff, gap = 0x7fffffff;
#pragma unroll
      for (int k = kLook - 1; k >= 0; --k) {
        if (s[k] >= kInclusive) near = k * 32 + lane;
        if (s[k] < kAggregate) gap = k * 32 + lane;
      }
      near = (int)__reduce_min_sync(kFull, (unsigned)near);
      gap = (int)__reduce_min_sync(kFull, (unsigned)gap);
      if (gap > near || gap == 0x7fffffff) {
        // every word up to the nearest inclusive prefix is published (or,
        // with none in the window, every word): their sum
        long long v = 0;
#pragma unroll
        for (int k = 0; k < kLook; ++k)
          if (k * 32 + lane <= near) v += (long long)(s[k] & kValue);
        excl += warp_total(v);
        if (near != 0x7fffffff) {
          if (lane == 0) publish(status + tile, kInclusive, excl + agg);
          return excl;
        }
        break;  // the whole window was aggregates: the one before it
      }
      // wait only for the unpublished words nearer than that prefix
#pragma unroll
      for (int k = 0; k < kLook; ++k)
        if (k * 32 + lane < near && s[k] < kAggregate)
          s[k] = peek(status + (j0 - lane - 32 * k));
    }
  }
}

// Tile [start, end) of n entries, with exclusive prefix excl and count
// `count`: its band [lo, hi) of the zero tail, cut at cap (empty when
// lo >= hi). Every slot of it is past pos, since at most n - end entries
// follow the tile's excl + count. tests/test_torch_flat_plan.py reads
// these three statements and checks that the bands cover [pos, cap) once.
__device__ __forceinline__ void tail_band(long long start, long long end,
                                          long long excl, long long count,
                                          long long n, long long cap,
                                          long long& lo, long long& hi) {
  lo = excl + count + (n - end);
  hi = excl + (n - start);
  if (hi > cap) hi = cap;
}

// Zeros over out[lo, hi): 16-byte streaming stores (evict first: nothing
// reads them back) between a ragged head and tail (out 16-byte aligned);
// the block's threads stride the words.
template <typename T>
__device__ __forceinline__ void zero_fill(T* out, long long lo,
                                          long long hi) {
  constexpr int kPer = 16 / sizeof(T);
  if (lo >= hi) return;
  long long a = (lo + kPer - 1) / kPer * kPer, b = hi / kPer * kPer;
  if (a > b) a = b = hi;  // inside one word: all of it in the head
  for (long long o = lo + threadIdx.x; o < a; o += kThreads) out[o] = 0;
  uint4* w = reinterpret_cast<uint4*>(out);
  for (long long j = a / kPer + threadIdx.x; j < b / kPer; j += kThreads)
    __stcs(&w[j], make_uint4(0, 0, 0, 0));
  for (long long o = b + threadIdx.x; o < hi; o += kThreads) out[o] = 0;
}

// The end of a block's use of the scratch, after its last read of it (its
// last ticket and look-back): the last block of the grid to
// get here zeroes the ticket, the count and the `tiles` status words, so
// that the next launch on this stream finds them zero.
__device__ __forceinline__ void release_scratch(const Scratch& sc,
                                                long long tiles,
                                                int* s_last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *s_last = atomicAdd(sc.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (*s_last) {
    __threadfence();
    for (long long j = threadIdx.x; j < tiles; j += kThreads)
      sc.status[j] = 0;
    if (threadIdx.x == 0) {
      *sc.ticket = 0;
      *sc.done = 0;
    }
  }
}

// Persistent grid of `kernel` on `device`: the blocks that fit on one SM
// at kThreads threads and `smem` bytes of dynamic shared memory (the
// attribute that admits more than 48 KB set first), times the SM count.
template <typename K>
cudaError_t persistent_blocks(int device, K kernel, size_t smem,
                              int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace cvs_lookback
