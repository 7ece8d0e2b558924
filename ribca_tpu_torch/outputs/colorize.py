"""Colorized map rendering via lookup tables.

The reference paints maps cell-by-cell with fancy-indexed pixel lists
(model.py:806-858) — O(cells * pixels) Python. Here every map is one LUT
gather over the instance mask: build a (max_id + 1)-entry table on host,
then ``table[mask]`` renders the full map in a single vectorized op.
Outputs are identical: cell-type RGB map, viridis confidence map (gray for
rejected) and the GUI label map (type int + 1, background 0).
"""

from __future__ import annotations

import numpy as np

from ribca_tpu_torch.outputs.colors import GRAY, viridis_lut


# numpy fancy-indexing allocates an intermediate per gather; above this
# pixel count the one-pass C++ painter is distinctly faster and lighter.
_NATIVE_PAINT_THRESHOLD = 4_000_000

# Above this element count PNG deflate (PIL default level 6) dominates the
# whole colorize stage, so whole-slide maps use level 1: modest file-size
# growth (cell maps are large flat-color regions), pixels identical; only
# the container's compression effort differs.
_FAST_PNG_THRESHOLD = 4_000_000


def save_png(path: str, arr: np.ndarray) -> str:
    """Save an image array as PNG, dropping to deflate level 1 for
    whole-slide-sized maps (pixel-identical output, faster encode)."""
    from PIL import Image

    kw = {"compress_level": 1} if arr.size >= _FAST_PNG_THRESHOLD else {}
    Image.fromarray(arr).save(path, **kw)
    return path


def _lut_paint(mask: np.ndarray, table: np.ndarray) -> np.ndarray:
    if (
        table.ndim == 2 and table.shape[1] == 3
        and mask.size >= _NATIVE_PAINT_THRESHOLD
    ):
        try:
            from ribca_tpu_torch import native

            return native.lut_paint_rgb(mask, table)
        except (RuntimeError, OSError):
            pass
    return table[mask]


def colorize_image(
    mask: np.ndarray,
    cell_ids: np.ndarray,
    type_ids: np.ndarray,
    confidence: np.ndarray,
    colors,
    want_labels: bool = True,
):
    """Render the cell maps of one image.

    Returns dict with keys: cell_type_rgb (H,W,3 u8), confidence_rgb, and
    cell_type_labels (H,W u8, type+1) when ``want_labels``; the integer
    label map exists only for the GUI's napari layers (model.py:845-858).
    Tissue-region maps come with the tissue-region analysis, which the
    port does not have yet.
    """
    n = int(mask.max()) + 1
    rgb_table = np.zeros((n, 3), dtype=np.uint8)
    conf_table = np.zeros((n, 3), dtype=np.uint8)

    palette = np.asarray(colors, dtype=np.uint8)
    rgb_table[cell_ids] = palette[type_ids]
    conf_table[cell_ids] = viridis_lut(confidence, reject_gray=GRAY)

    out = {
        "cell_type_rgb": _lut_paint(mask, rgb_table),
        "confidence_rgb": _lut_paint(mask, conf_table),
    }
    if want_labels:
        label_table = np.zeros(n, dtype=np.uint8)
        label_table[cell_ids] = (np.asarray(type_ids) + 1).astype(np.uint8)
        out["cell_type_labels"] = _lut_paint(mask, label_table)
    return out
