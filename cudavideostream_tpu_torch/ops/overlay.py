"""Device text overlay: glyph-atlas blit onto the frame before diffing
(the counterpart of the JAX package's ``ops/overlay.py``).

The reference launches one ``kernel2_char`` per character
(``kernels.cu:351-375``, driven from exec_core ``kernels.cu:466-476``),
copying the full glyph cell — background included — into the frame's top
rows at ``x = j * cell_w``. Here the selected cells are gathered with
``index_select`` into one text strip and written with one slice copy.
The JAX package selects cells with a one-hot float matmul because TPU
gathers are slow; on the card an index gather is cheap and exact, where a
float matmul would be one more exactness hazard.
"""

from __future__ import annotations

import torch


def overlay_blit(
    frame: torch.Tensor,
    atlas: torch.Tensor,
    char_ids: torch.Tensor,
    n_chars: int,
    height: int,
    width: int,
) -> torch.Tensor:
    """Blit the first ``n_chars`` glyph cells of ``char_ids``.

    Args:
      frame: flat uint8 frame of ``height * width * 3`` bytes (not
        modified; a blended copy is returned).
      atlas: (n_glyphs, cell_h, cell_w, 3) uint8 atlas on the frame's
        device.
      char_ids: (max_chars,) int64 atlas indices on the frame's device.
      n_chars: host int — characters beyond it leave the frame intact.
    """
    cell_h, cell_w = atlas.shape[1], atlas.shape[2]
    n_fit = min(char_ids.shape[0], width // cell_w, n_chars)
    if n_fit <= 0 or cell_h > height:
        return frame.clone()
    cw3 = cell_w * 3
    # byte-space 2D view (height, width*3): the strip is a plain slice
    img = frame.reshape(height, width * 3).clone()
    cells = atlas.index_select(0, char_ids[:n_fit])  # (n_fit, ch, cw, 3)
    strip = cells.reshape(n_fit, cell_h, cw3).permute(1, 0, 2)
    img[:cell_h, : n_fit * cw3] = strip.reshape(cell_h, n_fit * cw3)
    return img.reshape(-1)
