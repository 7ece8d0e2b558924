"""Separable Gaussian filtering on the device.

The port of ribca_tpu's ``ops/gaussian.py``. It replaces the reference's two
host-side Gaussian paths:

* ``scipy.ndimage.gaussian_filter`` (mode='reflect', truncate=4.0) used for
  background estimation and optional blur (preprocess.py:219-226);
* ``skimage.filters.gaussian`` (mode='nearest', truncate=4.0) used inside the
  per-cell soft mask (utils.py:265).

Taps are built exactly like scipy's ``_gaussian_kernel1d``; each axis is a
1-D ``conv1d`` (a correlation, as in scipy) over an index-gathered pad.
The convolutions run in full f32: the Annotator turns cuDNN's TF32 off
(utils/device.py), which would otherwise keep about three digits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# scipy / skimage boundary mode -> numpy pad mode
_PAD_MODE = {"reflect": "symmetric", "nearest": "edge", "mirror": "reflect"}


@functools.lru_cache(maxsize=64)
def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy-compatible 1-D Gaussian taps (odd length 2r+1, normalized)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (float(sigma) ** 2) * x**2)
    phi = phi / phi.sum()
    return phi.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, radius: int, mode: str) -> np.ndarray:
    """Source index of every position of a length-n axis padded by
    ``radius`` on both sides in scipy boundary ``mode`` (numpy's pad
    handles pads wider than the axis)."""
    return np.pad(np.arange(n), (radius, radius), mode=_PAD_MODE[mode])


def _conv1d_along(x: torch.Tensor, taps: np.ndarray, axis: int,
                  mode: str) -> torch.Tensor:
    """Correlate ``x`` with ``taps`` along ``axis`` with scipy-style edges."""
    radius = taps.shape[0] // 2
    idx = torch.as_tensor(_pad_index(x.shape[axis], radius, mode),
                          device=x.device)
    xp = x.index_select(axis, idx).movedim(axis, -1)
    lead = xp.shape[:-1]
    flat = xp.reshape(-1, 1, xp.shape[-1])
    weight = torch.as_tensor(taps, device=x.device).view(1, 1, -1)
    out = F.conv1d(flat, weight)
    return out.reshape(*lead, out.shape[-1]).movedim(-1, axis)


def gaussian_blur(
    x: torch.Tensor,
    sigma: float,
    mode: str = "reflect",
    truncate: float = 4.0,
) -> torch.Tensor:
    """Separable 2-D Gaussian over the two trailing axes of f32 ``x``.

    mode='reflect' reproduces scipy.ndimage.gaussian_filter defaults;
    mode='nearest' reproduces skimage.filters.gaussian defaults.
    """
    if sigma <= 0:
        return x
    taps = gaussian_kernel1d(sigma, truncate)
    x = _conv1d_along(x, taps, axis=x.dim() - 2, mode=mode)
    x = _conv1d_along(x, taps, axis=x.dim() - 1, mode=mode)
    return x
