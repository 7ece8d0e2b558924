"""Canonical image-shape buckets.

ribca_tpu rounds every uploaded image up to a shape ladder so that a cohort
of slightly different slides reuses one set of compiled XLA programs. The
port keeps the same ladder and the same pads, so that its normalization
statistics and patch gathers see exactly the arrays ribca_tpu's do (the
parity tests compare the two); in eager PyTorch it also keeps the caching
allocator's block sizes stable across a cohort:

* H and W round up to multiples of ``SHAPE_STEP`` with at least
  ``pad_min`` rows/cols of padding (the Gaussian halo), so cohorts of
  similar-but-unequal slides share one bucket;
* the image pads bottom/right with numpy 'symmetric' — scipy's 'reflect'
  boundary — so the background/blur Gaussians see exactly the pixels the
  unpadded reflect-mode filter would (pad >= kernel radius), keeping the
  prenorm bit-identical in the valid region;
* the mask zero-pads (background), and the true (H, W) travel beside the
  image: normalization statistics mask the pad to NaN
  (ops/normalize.normalize_image_masked) and the patch gather clamps at
  the true extents (ops/patches full_h/full_w). With ``blur=0`` (and
  with ``normalize=False``) results are BITWISE equal to the unpadded
  run; with a nonzero blur kernel the chained conv's accumulation order
  differs across padded widths, so the guarantee weakens to allclose at
  conv-rounding tolerance (~1e-5).
"""

from __future__ import annotations

import numpy as np

SHAPE_STEP = 256
SHAPE_FLOOR = 256


def bucket_dim(n: int, pad_min: int = 0, step: int = SHAPE_STEP,
               floor: int = SHAPE_FLOOR) -> int:
    """Smallest ladder value >= n + pad_min (multiples of ``step``)."""
    need = int(n) + int(pad_min)
    b = max(floor, ((need + step - 1) // step) * step)
    return b


def pad_image_chw(image: np.ndarray, hb: int, wb: int) -> np.ndarray:
    """Pad a (C, H, W) stack bottom/right to (C, hb, wb) with the scipy
    'reflect' boundary (numpy 'symmetric'), in the source dtype.

    Hand-rolled slice copies: a body memcpy plus three reflected edge
    blocks, much cheaper than np.pad's generic machinery on a whole
    slide. Falls back to np.pad for the multi-reflection case (pad wider
    than the image)."""
    c, h, w = image.shape
    ph, pw = hb - h, wb - w
    if ph == 0 and pw == 0:
        return image
    if ph >= h or pw >= w:  # tiny images: np.pad handles wide reflection
        return np.pad(image, ((0, 0), (0, ph), (0, pw)), mode="symmetric")
    out = np.empty((c, hb, wb), image.dtype)
    out[:, :h, :w] = image
    if ph:
        out[:, h:, :w] = image[:, : h - ph - 1 : -1, :]
    if pw:
        out[:, :h, w:] = image[:, :, : w - pw - 1 : -1]
    if ph and pw:
        out[:, h:, w:] = image[:, : h - ph - 1 : -1, : w - pw - 1 : -1]
    return out


def pad_mask_hw(mask: np.ndarray, hb: int, wb: int) -> np.ndarray:
    """Zero-pad a (H, W) instance mask bottom/right (0 = background)."""
    h, w = mask.shape
    if h == hb and w == wb:
        return mask
    return np.pad(mask, ((0, hb - h), (0, wb - w)))
