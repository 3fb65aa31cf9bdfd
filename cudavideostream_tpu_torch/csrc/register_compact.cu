// K6 on Hopper: the "register" compaction scheme. The fused threshold diff
// + negative feedback + stable (ascending) compaction of K1, at whole-tile
// units, by a row loop with a carried offset and register staging; a
// third derivation of K1's bytes, independent of logcompact.cu (nothing
// of it is included) and of segment_compact.cu.
//
// Replaces the TPU kernel cudavideostream_tpu/ops/pallas_compact.py:_kernel
// (launched by run_register, pallas_compact.py:188; reached through
// fused_diff_compact(scheme="register"), logcompact.py:668-679). As there,
// it is a correctness cross-check and not a peer of K1 in speed: the TPU
// kernel took 44.97 ms at 1080p on a v5e (pallas_compact.py:4-10), and
// this one walks each tile's 496 rows in order on one warp.
//
// What it computes: as K5 (csrc/segment_compact.cu), with the scalar
// threshold only and no overlay region (the JAX package refuses both for
// this scheme, logcompact.py:671-675): tile t of unit_bytes (the JAX tile
// geometry at sub_rows = 0, 98 tiles of 63,488 B at 1080p) holds its
// shipped entries, ascending, at xs_t[t * unit_bytes + slot] / vals_t,
// zeros from its count to unit_bytes, the count in counts[t], and
// new_prev is written into prev in place.
//
// The TPU design, row by row:
//   * the TPU ranks a 128-lane row with a lane scan and a one-hot
//     reduction; here one warp per tile takes each row as 4 sub-rows of 32
//     bytes, one byte per lane, and ranks a sub-row with __ballot_sync and
//     __popc(ballot & lanemask_lt), the offset carried in a register;
//   * the TPU stages entries in an (8, 128) register block and flushes it
//     at aligned 8-row boundaries; here the entries go to a 1,024-entry
//     staging pair in shared memory, flushed with coalesced stores each
//     time the offset crosses a multiple of 1,024, and once at the end;
//   * the TPU skips an 8-row group that has no change (any_change); here
//     the warp loads the group's 1,024 bytes (32 per lane) and skips it
//     with __any_sync;
//   * the tile's slots past the count are zero-filled.
// Each lane owns its bytes from load to new_prev, so the in-place update
// is safe.
//
// Bound. Device-memory bytes as K5's at the scalar threshold: 49,771,912 B
// at 1080p, 14.86 us at 3.35 TB/s. 98 warps, each loading one byte per
// lane per sub-row, are far from it by design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kGroupBytes = 1024;  // 8 rows of 128: 32 sub-rows of 32
constexpr int kSubRows = kGroupBytes / kLanes;
constexpr int kStage = 1024;  // staging entries per flush
constexpr unsigned kAll = 0xffffffffu;

// The staged entries [0, count) to the tile's slots [at, at + count).
__device__ __forceinline__ void flush(const int* s_xs, const uint8_t* s_vals,
                                      int count, int at, int* xs,
                                      uint8_t* vals, int lane) {
  for (int j = lane; j < count; j += kLanes) {
    xs[at + j] = s_xs[j];
    vals[at + j] = s_vals[j];
  }
}

__global__ void __launch_bounds__(kLanes)
register_kernel(const uint8_t* __restrict__ cur, uint8_t* prev, long long n,
                int thr, int negfeed, int unit_bytes,
                int* __restrict__ counts, int* __restrict__ xs_t,
                uint8_t* __restrict__ vals_t) {
  __shared__ int s_xs[kStage];
  __shared__ uint8_t s_vals[kStage];
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;  // lanemask_lt
  const long long tile0 = (long long)blockIdx.x * unit_bytes;
  int* xs = xs_t + tile0;
  uint8_t* vals = vals_t + tile0;
  int off = 0;  // the tile's entries so far: the carried offset

  for (int g0 = 0; g0 < unit_bytes; g0 += kGroupBytes) {
    // lane `lane` holds byte s * 32 + lane of the group, s = 0..31
    uint8_t c[kSubRows], p[kSubRows];
    unsigned ship = 0;  // bit s: that byte ships
#pragma unroll
    for (int s = 0; s < kSubRows; ++s) {
      const long long i = tile0 + g0 + s * kLanes + lane;
      c[s] = i < n ? cur[i] : 0;
      p[s] = i < n ? prev[i] : 0;
      if (abs(int(c[s]) - int(p[s])) > thr) ship |= 1u << s;
    }
    if (!__any_sync(kAll, ship != 0)) {  // a group with no change
      if (!negfeed) {
#pragma unroll
        for (int s = 0; s < kSubRows; ++s) {
          const long long i = tile0 + g0 + s * kLanes + lane;
          if (i < n) prev[i] = c[s];
        }
      }
      continue;
    }
#pragma unroll
    for (int s = 0; s < kSubRows; ++s) {
      const long long i = tile0 + g0 + s * kLanes + lane;
      const bool mine = (ship >> s) & 1u;
      const unsigned b = __ballot_sync(kAll, mine);
      const int slot = off + __popc(b & below);
      const int end = off + __popc(b);
      const int boundary = (off / kStage + 1) * kStage;
      if (mine && slot < boundary) {
        s_xs[slot - (boundary - kStage)] = (int)i;
        s_vals[slot - (boundary - kStage)] = (uint8_t)(c[s] - p[s]);
      }
      if (end >= boundary) {  // the staging is full: flush, start over
        __syncwarp();
        flush(s_xs, s_vals, kStage, boundary - kStage, xs, vals, lane);
        __syncwarp();
        if (mine && slot >= boundary) {
          s_xs[slot - boundary] = (int)i;
          s_vals[slot - boundary] = (uint8_t)(c[s] - p[s]);
        }
      }
      off = end;
      if (i < n && (mine || !negfeed)) prev[i] = c[s];
    }
  }

  // the staged rest, the zero tail and the count
  __syncwarp();
  const int staged0 = off / kStage * kStage;
  flush(s_xs, s_vals, off - staged0, staged0, xs, vals, lane);
  for (int q = off + lane; q < unit_bytes; q += kLanes) {
    xs[q] = 0;
    vals[q] = 0;
  }
  if (lane == 0) counts[blockIdx.x] = off;
}

}  // namespace

extern "C" {

// Launch K6 on `stream`: one warp per tile of unit_bytes (a multiple of
// 1,024: the JAX tiles are multiples of 8 rows of 128) over n_units tiles
// covering the n-byte frame. counts holds n_units int32; xs_t and vals_t
// hold n_units * unit_bytes entries. Returns the cudaError_t of the launch
// (0 on success).
int cvs_register_compact(int device, const uint8_t* cur, uint8_t* prev,
                         long long n, int thr, int negfeed, int unit_bytes,
                         int n_units, int* counts, int* xs_t,
                         uint8_t* vals_t, cudaStream_t stream) {
  if (unit_bytes <= 0 || unit_bytes % kGroupBytes || n_units <= 0
      || (long long)unit_bytes * n_units < n)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  register_kernel<<<n_units, kLanes, 0, stream>>>(
      cur, prev, n, thr, negfeed, unit_bytes, counts, xs_t, vals_t);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
