"""Per-channel image normalization, single-shot route.

The port of the single-shot half of ribca_tpu's ``ops/normalize.py``. It
replicates the reference ``ImageProcessor._normalize``
(preprocess.py:214-239), branchlessly and over all channels at once:

  1. background = gaussian(channel, sigma=20), clipped at 125, subtracted,
     result clipped at 0;
  2. optional gaussian blur with sigma=blur;
  3. all-nonpositive channels become constant -1;
  4. upper clip at the ``amax`` percentile, only when that percentile > 20;
  5. scale to [-1, 1] via 2*(x / max(25, max(x))) - 1.

Images arrive padded to a canonical shape (ops/shapes.py); the statistics
of steps 3-5 see only the true pixels and the pads come out NaN. The
banded whole-slide half (band_prenorm, band_stats, ...) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ribca_tpu_torch.ops.gaussian import gaussian_blur

BG_SIGMA = 20.0
BG_CLIP = 125.0
PCT_GUARD = 20.0
SCALE_FLOOR = 25.0


def halo_radius(blur: float) -> int:
    """Rows of context exact Gaussian edges need (scipy truncate=4.0): bg
    sigma 20 -> 80, plus the optional blur radius. The canonical pad is at
    least this wide."""
    r = int(4.0 * BG_SIGMA + 0.5)
    if blur:
        r += int(4.0 * float(blur) + 0.5)
    return r


def pinned_nanpercentile(x: torch.Tensor, amax: float) -> torch.Tensor:
    """NaN-aware ``amax``-percentile (linear method) over the last axis of
    ``x``, with the scalar chain of ribca_tpu's ``pinned_nanpercentile``
    so that both packages round every step alike:

    - ``q = amax/100`` is computed on the host in f32;
    - the valid count reduces in int32, then converts to f32;
    - ``t = q * (count - 1)``, ``low = floor(t)``, ``high = ceil(t)`` and
      the weight ``t - low`` are f32;
    - the rank clamp to ``count - 1`` runs in exact integers (above 2^24
      valid pixels an f32 ``count - 1`` rounds back up to ``count``);
    - the interpolation is the single-mul lerp ``lv + (hv - lv) * w``.

    NaN sorts last, so the order statistics come from the valid pixels."""
    s = torch.sort(x, dim=-1).values
    cnt = (~torch.isnan(x)).sum(dim=-1, dtype=torch.int32)
    q = torch.tensor(np.float32(np.float32(amax) / np.float32(100.0)),
                     device=x.device)
    t = q * (cnt.to(torch.float32) - 1)
    low = torch.floor(t)
    high = torch.ceil(t)
    high_w = t - low
    nm1 = torch.clamp(cnt - 1, min=0).to(torch.int64)
    lo_i = torch.minimum(torch.clamp(low.to(torch.int64), min=0), nm1)
    hi_i = torch.minimum(torch.clamp(high.to(torch.int64), min=0), nm1)
    lv = torch.gather(s, -1, lo_i.unsqueeze(-1)).squeeze(-1)
    hv = torch.gather(s, -1, hi_i.unsqueeze(-1)).squeeze(-1)
    return lv + (hv - lv) * high_w


def _valid_mask(h: int, w: int, valid_h: int, valid_w: int, device):
    rows = torch.arange(h, device=device)[:, None] < valid_h
    cols = torch.arange(w, device=device)[None, :] < valid_w
    return rows & cols


def normalize_image_masked(img: torch.Tensor, valid_h: int, valid_w: int,
                           blur: float = 0.0,
                           amax: float = 100.0) -> torch.Tensor:
    """Normalize a canonical-shape (C, H, W) stack whose true extent is
    (valid_h, valid_w); returns f32 in [-1, 1] with NaN pads (a channel
    with no signal is -1 everywhere, pads included, as in ribca_tpu)."""
    c, h, w = img.shape
    ch = img.to(torch.float32)
    bg = torch.clamp(gaussian_blur(ch, BG_SIGMA, mode="reflect"),
                     max=BG_CLIP)
    ch = torch.clamp(ch - bg, min=0.0)
    if blur:
        ch = gaussian_blur(ch, float(blur), mode="reflect")

    valid = _valid_mask(h, w, valid_h, valid_w, img.device)
    chm = torch.where(valid, ch, float("nan"))
    flat = chm.reshape(c, -1)
    has_signal = (flat > 0).any(dim=1)            # NaN > 0 is False
    thresh = pinned_nanpercentile(flat, amax)
    t = thresh[:, None, None]
    clipped = torch.where(
        t > PCT_GUARD, torch.minimum(torch.clamp(chm, min=0.0), t), chm
    )
    cmax = torch.where(torch.isnan(clipped), -torch.inf, clipped).amax(
        dim=(1, 2))
    denom = torch.clamp(cmax, min=SCALE_FLOOR)[:, None, None]
    scaled = 2.0 * (clipped / denom) - 1.0
    return torch.where(has_signal[:, None, None], scaled, -1.0)


def cast_f32_masked(img: torch.Tensor, valid_h: int,
                    valid_w: int) -> torch.Tensor:
    """normalize=False counterpart: f32 cast with NaN pads, so the masked
    min/zero-shift in the pipeline sees only true pixels."""
    _, h, w = img.shape
    valid = _valid_mask(h, w, valid_h, valid_w, img.device)
    return torch.where(valid, img.to(torch.float32), float("nan"))
