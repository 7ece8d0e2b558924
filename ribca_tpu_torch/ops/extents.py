"""Per-cell mask statistics: bounding boxes, pixel counts, centroids.

The port of ribca_tpu's ``ops/extents.py``. The reference builds
``cell_pos_dict`` {cell_id: ([rows],[cols])} with a Python double loop over
every pixel (preprocess.py:159-211). Downstream consumers never need the raw
pixel lists:

* patch cropping needs (min+max)//2 per axis (utils.py:227,232);
* CSV export needs mean row/col (model.py:785-786);
* colorize paints via a LUT over the mask (outputs/colorize.py).

The C++ scanner (``native/mask_scan.cpp``) computes them in one host pass;
without a compiler a torch scatter-reduce computes the same integers.
``cell_extents`` returns arrays indexed by raw cell id 0..n_ids; slot 0 is
background. ``present_ids`` lists the ids that occur, ascending (the
reference's dict iterates them in that order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class CellExtents:
    """Host-side view of per-cell mask statistics (index = raw cell id)."""

    rmin: np.ndarray
    rmax: np.ndarray
    cmin: np.ndarray
    cmax: np.ndarray
    count: np.ndarray
    mean_row: np.ndarray
    mean_col: np.ndarray

    @property
    def present(self) -> np.ndarray:
        p = self.count > 0
        p[0] = False
        return p

    @property
    def present_ids(self) -> np.ndarray:
        """Cell ids that occur in the mask, ascending (dict-key order of the
        reference's sorted cell_pos_dict)."""
        return np.nonzero(self.present)[0]


def _extents_torch(mask: np.ndarray, n_ids: int):
    """Segment min/max/sum with ``scatter_reduce``; empty slots keep the
    scanner's sentinels (INT32_MAX for minima, 0 for maxima and sums)."""
    ids = torch.from_numpy(np.ascontiguousarray(mask, np.int64)).reshape(-1)
    h, w = mask.shape
    rows = torch.arange(h, dtype=torch.int64).repeat_interleave(w)
    cols = torch.arange(w, dtype=torch.int64).repeat(h)

    def seg(src, reduce, init):
        out = torch.full((n_ids,), init, dtype=torch.int64)
        return out.scatter_reduce(0, ids, src, reduce=reduce,
                                  include_self=True).numpy()

    return (
        seg(rows, "amin", _INT32_MAX).astype(np.int32),
        seg(rows, "amax", 0).astype(np.int32),
        seg(cols, "amin", _INT32_MAX).astype(np.int32),
        seg(cols, "amax", 0).astype(np.int32),
        seg(torch.ones_like(ids), "sum", 0),
        seg(rows, "sum", 0),
        seg(cols, "sum", 0),
    )


def cell_extents(
    mask: np.ndarray,
    n_ids: int | None = None,
    prefer_native: bool = True,
) -> CellExtents:
    """Compute per-cell extents/centroids/counts for an int mask (H, W).

    Uses the C++ single-pass scanner when it builds, else the torch
    scatter-reduce path; both produce identical integers. Centroid sums
    stay integers and divide in f64, so centroids equal np.mean over the
    reference's pixel lists."""
    mask = np.asarray(mask)
    if n_ids is None:
        n_ids = int(mask.max()) + 1

    out = None
    if prefer_native:
        from ribca_tpu_torch import native

        try:
            out = native.mask_scan(mask, n_ids)
        except RuntimeError:
            out = None
    if out is None:
        out = _extents_torch(mask, n_ids)
    rmin, rmax, cmin, cmax, count, rsum, csum = out
    cnt = np.maximum(count, 1).astype(np.float64)
    return CellExtents(
        np.asarray(rmin), np.asarray(rmax), np.asarray(cmin),
        np.asarray(cmax), np.asarray(count),
        np.asarray(rsum, np.float64) / cnt,
        np.asarray(csum, np.float64) / cnt,
    )
