// K14 on Hopper: the status-text overlay, each stream's glyph cells copied
// whole over its frame's first rows, one launch for B streams.
//
// Replaces no TPU kernel. The JAX package blits outside Pallas, as XLA ops
// (cudavideostream_tpu/ops/overlay.py:20 overlay_blit: a one-hot matmul
// selects the cells, one static slice update writes the strip). Its first
// port ran four PyTorch ops a frame (the strip's clone, a byte-wise
// index_select of the cells over int64 indices, the copy that reshaping the
// permuted cells forces, the slice assignment) and the batched step a
// torch.cat of the B strips: 12.2 us a 1080p frame on an H100, in a CUDA
// graph, for a strip of 288,000 B (PERF.md).
//
// What it computes: out holds B strips of `strip` = rows * row bytes (row =
// width * 3); byte k = r * row + c of stream b's strip is
//   atlas[ids[b][c / cw3]][r][c % cw3]  where r < cell_h and c < nf * cw3,
//   frame[b * stride + k]               elsewhere,
// nf = n_fit[b] (or nfit for every stream where n_fit is null), at most
// max_chars and the whole cells a row holds (row / cw3), at least 0: the
// first nf characters' cells, background included, side by side at x = j *
// cell_w, as ops/reference_cpu.py overlay_blit draws them. A glyph id is
// clamped into [0, n_glyphs), so no read leaves the atlas.
//
// Design: a lane owns one 16-byte vector of the output, neighbouring lanes
// neighbouring vectors, in a grid-stride loop over a grid of at most one
// wave (ops/overlay.py overlay_plan: kBlocksPerSm blocks of kThreads an SM;
// 141 blocks for one 1080p strip, 563 for four). Indices into the output
// are 32-bit (a 64-bit division is a long instruction sequence), so the
// output is shorter than 4 GB. A vector inside one row of one stream, whose
// addresses are 16-byte aligned, takes one of three paths:
//   - right of the glyphs (or below the cells): one 16-byte load of the
//     frame and one 16-byte store, coalesced (a 1080p row, 5,760 B, and the
//     strip are multiples of 16);
//   - inside the glyphs: no frame read; its 16 bytes picked from the atlas
//     byte by byte (a glyph row is cw3 = 90 B at the default font, not a
//     multiple of 16, so a vector meets one or two cells at any phase: both
//     cells' rows are found first, so the 16 loads go out at once), put
//     together in four words and stored as one vector;
//   - across the glyphs' right edge (one vector a row): the frame's vector
//     and the atlas bytes left of the edge, merged in registers.
// Any other vector (one that straddles a row, a stream or the output's end,
// one whose address is not 16-byte aligned, any vector that meets glyphs
// where a cell's row is narrower than 16 B) goes byte by byte, each byte
// from the atlas or the frame as above. Every output byte is written once,
// by one lane. The first design sent the edge vector byte by byte too: its
// three divisions and two dependent loads a byte made that lane the
// launch's long pole, 13.8 us a 1080p strip by events (PERF.md).
//
// Bound at 1080p, one stream, 18 characters (rows = cell_h = 50): read the
// frame's 207,000 B right of the glyphs and the cells' 81,000 B, write
// 288,000 B: 576,000 B, 0.17 us at 3.35 TB/s. An empty launch takes about
// 5 us timed by events, so the launch, not the bytes, bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // a block's lanes, one vector each
constexpr int kBlocksPerSm = 8;  // the launch plan's cap (ops/overlay.py)
constexpr int kVec = 16;         // bytes of a lane's vector

struct Blit {
  const uint8_t* frame;  // stream b's strip at frame + b * stride
  long long stride;
  const uint8_t* atlas;  // n_glyphs cells of cell_h rows of cw3 bytes
  int n_glyphs, cell_h, cw3;
  const int* ids;        // stream b's glyph ids at ids + b * max_chars
  int max_chars;
  const int* n_fit;      // the characters each stream draws, or null: nfit
  int nfit;
  int cells;             // whole cells a row holds: row / cw3
  long long row;         // bytes a row: width * 3
  long long strip;       // bytes of a stream's output: rows * row
  long long total;       // streams * strip
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// The characters stream b draws
__device__ __forceinline__ long long drawn(const Blit& p, long long b) {
  long long nf = p.n_fit ? __ldg(p.n_fit + b) : p.nfit;
  nf = min(nf, (long long)min(p.max_chars, p.cells));
  return nf < 0 ? 0 : nf;
}

// Row r of the cell of stream b's character j
__device__ __forceinline__ const uint8_t* glyph_row(const Blit& p,
                                                   long long b, long long j,
                                                   long long r) {
  const int g = min(max(__ldg(p.ids + b * p.max_chars + j), 0),
                    p.n_glyphs - 1);
  return p.atlas + ((long long)g * p.cell_h + r) * p.cw3;
}

// Output byte o, from the atlas or the frame
__device__ __forceinline__ uint8_t blit_byte(const Blit& p, unsigned o) {
  using I = unsigned;
  const I b = o / (I)p.strip, k = o - b * (I)p.strip;
  const I r = k / (I)p.row, c = k - r * (I)p.row;
  if (r < (I)p.cell_h && c < (I)(drawn(p, b) * p.cw3)) {
    const I j = c / (I)p.cw3;
    return __ldg(glyph_row(p, b, j, r) + (c - j * (I)p.cw3));
  }
  return __ldg(p.frame + (long long)b * p.stride + k);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    overlay_kernel(const Blit p, uint8_t* __restrict__ out) {
  using I = unsigned;
  const I strip = (I)p.strip, row = (I)p.row, cw3 = (I)p.cw3;
  const I vecs = (I)((p.total + kVec - 1) / kVec);
  for (I v = (I)blockIdx.x * kThreads + threadIdx.x; v < vecs;
       v += (I)gridDim.x * kThreads) {
    const I o0 = v * kVec;
    const I b = o0 / strip, k0 = o0 - b * strip;
    const I r = k0 / row, c0 = k0 - r * row;
    uint8_t* dst = out + o0;
    const uint8_t* src = p.frame + (long long)b * p.stride + k0;
    if (k0 + kVec <= strip && c0 + kVec <= row && aligned16(dst)
        && aligned16(src)) {
      // the vector lies in one row of stream b
      const I edge = r < (I)p.cell_h ? (I)(drawn(p, b) * p.cw3) : 0;
      if (c0 >= edge) {
        *reinterpret_cast<uint4*>(dst) =
            __ldg(reinterpret_cast<const uint4*>(src));
        continue;
      }
      if (cw3 >= kVec) {
        // bytes e < m from the atlas, from at most two cells; the rest
        // (across the edge) from the frame's vector
        const I m = min(edge - c0, (I)kVec);
        const I j = c0 / cw3, off = c0 - j * cw3;
        const uint8_t* g0 = glyph_row(p, b, j, r);
        const uint8_t* g1 = off + m > cw3 ? glyph_row(p, b, j + 1, r) - cw3
                                          : g0;
        uint4 f = make_uint4(0, 0, 0, 0);
        if (m < (I)kVec) f = __ldg(reinterpret_cast<const uint4*>(src));
        unsigned w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if ((I)e < m) {
            const I o = off + e;
            const unsigned byte = __ldg((o < cw3 ? g0 : g1) + o);
            w[e >> 2] = (w[e >> 2] & ~(0xffu << (8 * (e & 3))))
                        | byte << (8 * (e & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        continue;
      }
    }
    const I valid = (I)p.total - o0;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if ((I)e < valid) dst[e] = blit_byte(p, o0 + e);
  }
}

}  // namespace

extern "C" {

// Launch K14 on `stream`: `streams` strips of rows * row bytes into out,
// stream b's from frame + b * stride (stride unused for one stream), its
// glyph ids at ids + b * max_chars (int32, null where max_chars is 0) and
// its characters n_fit[b] (int32 on the device), or nfit for every stream
// where n_fit is null; the atlas n_glyphs cells of cell_h rows of cw3
// bytes; all strips together shorter than 4 GB. One kernel launch of
// `grid` blocks (ops/overlay.py overlay_plan). Returns the cudaError_t of
// the launch.
int cvs_overlay(int device, const uint8_t* frame, long long stride,
                const uint8_t* atlas, int n_glyphs, int cell_h, int cw3,
                const int* ids, int max_chars, const int* n_fit, int nfit,
                long long row, long long rows, int streams, int grid,
                uint8_t* out, cudaStream_t stream) {
  if (!frame || !atlas || !out || n_glyphs <= 0 || cell_h <= 0 || cw3 <= 0
      || max_chars < 0 || (max_chars && !ids) || row <= 0 || rows < cell_h
      || streams <= 0 || grid <= 0 || (streams > 1 && stride < row * rows)
      || row * rows * streams + kVec > 0xffffffffll)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime, whose current device is
  // not the caller's: select the tensors' device explicitly
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Blit p{frame, stride, atlas, n_glyphs, cell_h, cw3, ids, max_chars,
               n_fit, nfit, (int)(row / cw3), row, row * rows,
               row * rows * streams};
  overlay_kernel<<<grid, kThreads, 0, stream>>>(p, out);
  return (int)cudaGetLastError();
}

const char* cvs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int cvs_overlay_threads(void) { return kThreads; }

int cvs_overlay_blocks_per_sm(void) { return kBlocksPerSm; }

int cvs_overlay_vec(void) { return kVec; }

}  // extern "C"
