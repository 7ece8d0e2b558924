"""Per-cell patch extraction on the device.

The port of ribca_tpu's ``ops/patches.py``. It replaces the reference's
per-cell Python loop (preprocess.py:76-151 + utils.py:226-270): crop,
soft-mask, rescale, average intensity and channel selection, for a chunk of
cells at once:

  1. window: centroid = midpoint of the row/col bbox extents
     (utils.py:227-235), clamped to the image, zero-padded bottom/right;
  2. soft mask: mean of {cell mask, dilations disk(1..4), gaussians of the
     dilations} normalized to max 1 (utils.py:255-270), as batched convs;
  3. marker patch = zeroed image * soft mask + per-channel min
     (utils.py:246-247);
  4. per-cell per-channel mean over ALL cell pixels in the window
     (mask_patch > 0, not just the center cell — utils.py:249-253);
  5. nearest resize with anti-aliasing to 40x40 (preprocess.py:106,
     skimage semantics: AA sigma=(f-1)/2 mirror-padded, ndi.zoom
     grid_mode=True order=0);
  6. per-panel channel gather with the blank(-1) insertion quirk
     (preprocess.py:110-121): only the FIRST missing marker becomes a
     blank channel; further -1 indices select the LAST image channel
     (numpy negative indexing) — replicated faithfully.

The full-channel patch is computed once per cell and every panel reuses it
through a cheap gather (the reference re-crops per panel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ribca_tpu_torch.ops.gaussian import gaussian_blur

OUT_SIZE = 40
SMOOTH_EPS = 1e-6


def disk_footprint(radius: int) -> np.ndarray:
    """skimage.morphology.disk-compatible L2 ball footprint."""
    y, x = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    return ((x**2 + y**2) <= radius**2).astype(np.float32)


# -- panel channel gather ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PanelGather:
    gather_idx: tuple[int, ...]  # source channel per output slot
    blank: tuple[bool, ...]      # True where the slot is the -1 blank fill
    missing_positions: tuple[int, ...]  # panel slots whose marker is missing


def build_panel_gather(channel_index, n_channels: int) -> PanelGather:
    """Replicates preprocess.py:110-121 channel selection semantics."""
    ci = [int(v) for v in channel_index]
    missing = tuple(k for k, v in enumerate(ci) if v == -1)
    if -1 in ci:
        first = ci.index(-1)
        gather, blank = [], []
        for k, v in enumerate(ci):
            if k == first:
                gather.append(0)
                blank.append(True)
            else:
                gather.append(v if v != -1 else n_channels - 1)
                blank.append(False)
        return PanelGather(tuple(gather), tuple(blank), missing)
    return PanelGather(tuple(ci), tuple(False for _ in ci), missing)


def apply_panel_gather(patches: torch.Tensor,
                       pg: PanelGather) -> torch.Tensor:
    """(N, C, H, W) full-channel patches -> (N, K, H, W) panel patches."""
    if (
        not any(pg.blank)
        and pg.gather_idx == tuple(range(patches.shape[1]))
    ):
        # identity parse (marker file already in panel order, nothing
        # missing): no copy
        return patches
    idx = torch.as_tensor(pg.gather_idx, device=patches.device)
    sel = patches.index_select(1, idx)
    if any(pg.blank):
        blank = torch.as_tensor(pg.blank, device=patches.device)
        sel = torch.where(blank[None, :, None, None], -1.0, sel)
    return sel


# -- window gather -----------------------------------------------------------


def _gather_windows(img_zero, mask, rmin, rmax, cmin, cmax, patch_size,
                    offset, row_offset, full_h, full_w, band_h):
    """Window gather from inputs padded one window bottom/right, so no
    window start is ever clamped. ``img_zero``/``mask`` may be a row band
    of the full image starting at global row ``row_offset``, in which case
    ``full_h`` is the full image height for the bottom-clamp semantics
    (utils.py:239-240). ``full_w`` is the true image width: canonical-shape
    pad columns beyond it (NaN after masked normalization) read as out of
    image. ``band_h`` is the number of true band rows.

    Returns RAW windows (N, C, P, P), mask windows (N, P, P) and the
    validity mask (N, P, P)."""
    p = patch_size
    ar = torch.arange(p, device=img_zero.device)
    xmin = torch.clamp((rmin + rmax) // 2 - offset, min=0)
    ymin = torch.clamp((cmin + cmax) // 2 - offset, min=0)
    rows = xmin[:, None] + ar                    # global rows (N, P)
    cols = ymin[:, None] + ar                    # (N, P)
    local = rows - row_offset
    r_idx = local[:, :, None]
    c_idx = cols[:, None, :]
    ip = img_zero[:, r_idx, c_idx].permute(1, 0, 2, 3)
    mp = mask[r_idx, c_idx]
    vr = (rows < full_h) & (local >= 0) & (local < band_h)
    vc = cols < full_w
    valid = vr[:, :, None] & vc[:, None, :]
    return ip, mp, valid


# -- soft mask ---------------------------------------------------------------


def _soft_mask(cm: torch.Tensor) -> torch.Tensor:
    """utils.py:255-270 as batched convs. cm: (N, P, P) binary f32. The
    terms add in ribca_tpu's order (f32 sums are order-sensitive)."""
    terms = cm
    count = 1
    x = cm[:, None]  # NCHW with C=1
    for j in range(1, 5):
        k = torch.as_tensor(disk_footprint(j), device=cm.device)[None, None]
        # sums of 0/1 products: exact in any summation order
        dil = (F.conv2d(x, k, padding=j) > 0).to(torch.float32)[:, 0]
        terms = terms + dil
        count += 1
        for i in range(j - 1):
            terms = terms + gaussian_blur(dil, 1.0 + i, mode="nearest")
            count += 1
    sm = terms / count
    return sm / (sm.amax(dim=(1, 2), keepdim=True) + SMOOTH_EPS)


# -- resize --------------------------------------------------------------


def _resize_nearest_aa(x: torch.Tensor, in_size: int, out_size: int):
    """skimage.transform.resize(order=0, anti_aliasing=True) over the two
    trailing axes: gaussian AA prefilter (mirror pad) + grid-mode nearest."""
    if in_size == out_size:
        return x
    factor = in_size / out_size
    sigma = max(0.0, (factor - 1) / 2)
    if sigma > 0:
        x = gaussian_blur(x, sigma, mode="mirror")
    idx = np.floor((np.arange(out_size) + 0.5) * factor).astype(np.int64)
    idx = torch.as_tensor(np.clip(idx, 0, in_size - 1), device=x.device)
    return x.index_select(-2, idx).index_select(-1, idx)


# -- main entry ----------------------------------------------------------


def extract_patches(
    img_zero: torch.Tensor,   # (C, H, W) f32, channel-min already subtracted
    min_val: torch.Tensor,    # (C,) per-channel minima
    mask: torch.Tensor,       # (H, W) int32
    cells: torch.Tensor,      # (5, N) int32: [cell_ids, rmin, rmax, cmin,
                              # cmax] stacked, one upload per chunk
    patch_size: int = 40,
    out_size: int = OUT_SIZE,
    row_offset: int = 0,      # band mode: global row of img_zero[., 0, .]
    full_h: int | None = None,  # band mode: full image height
    full_w: int | None = None,  # canonical-shape uploads: true image width
    prepadded: bool = False,  # img/mask already carry a +patch pad
):
    """Returns (patches (N,C,out,out) f32, avg_int (N,C) f32).

    ``prepadded=True`` skips the internal one-window bottom/right pad: the
    pipeline pads the image once instead of once per chunk."""
    cell_ids, rmin, rmax, cmin, cmax = cells.to(torch.int64).unbind(0)
    p = int(patch_size)
    # int(max(x_mean - P/2, 0)): floor for positive values -> ceil(P/2)
    # offset when P is odd, P//2 when even
    offset = p // 2 if p % 2 == 0 else (p + 1) // 2
    band_h = mask.shape[0] - p if prepadded else mask.shape[0]
    if full_h is None:
        full_h = band_h
    if full_w is None:
        full_w = mask.shape[1] - p if prepadded else mask.shape[1]

    if prepadded:
        imgp, maskp = img_zero, mask
    else:
        imgp = F.pad(img_zero, (0, p, 0, p))
        maskp = F.pad(mask, (0, p, 0, p))

    ip, mp, valid = _gather_windows(
        imgp, maskp, rmin, rmax, cmin, cmax, p, offset,
        row_offset, full_h, full_w, band_h,
    )
    # where-select, not multiply: pad pixels are NaN and NaN*0 = NaN
    ip = torch.where(valid[:, None], ip, 0.0)
    mp = torch.where(valid, mp, 0)
    cm = (mp == cell_ids[:, None, None]).to(torch.float32)
    sm = _soft_mask(cm)

    marker = ip * sm[:, None] + min_val[None, :, None, None]

    anym = (mp > 0).to(torch.float32)
    denom = torch.clamp(anym.sum(dim=(1, 2)), min=1.0)
    avg_int = (marker * anym[:, None]).sum(dim=(2, 3)) / denom[:, None]

    out = _resize_nearest_aa(marker, p, out_size)
    return out, avg_int
