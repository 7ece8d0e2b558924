"""Host-side bioimage I/O.

The reference reads images with ``skimage.io.imread`` (preprocess.py:244-246),
which delegates to tifffile/imageio. The port keeps a thin,
dependency-light host layer: CHW TIFF stack reading on top of PIL
(multi-frame TIFF, 8/16/32-bit int and float pages). Whole-slide streaming
reads (ribca_tpu's io/tiff_stream.py) belong to the banded route, which is
not ported yet.

Contract: ``read_image`` returns a CHW ndarray (C first); ``read_mask``
returns a 2-D int32 instance mask (3-channel inputs take channel 0, matching
preprocess.py:247-249).
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageSequence

# PIL refuses very large images by default; whole-slide inputs are legitimate.
Image.MAX_IMAGE_PIXELS = None


def _page_to_array(page: Image.Image) -> np.ndarray:
    arr = np.asarray(page)
    return arr


def read_image(path: str) -> np.ndarray:
    """Read a multiplexed image as a CHW stack.

    Accepts: multi-page TIFF (one channel per page), single-page HWC or HW
    images (PNG/TIFF). HWC inputs are transposed to CHW; HW inputs get a
    singleton channel axis.
    """
    with Image.open(path) as im:
        n_frames = getattr(im, "n_frames", 1)
        if n_frames > 1:
            pages = []
            for page in ImageSequence.Iterator(im):
                a = _page_to_array(page)
                if a.ndim == 3:  # RGB page: split? keep as-is per-page channel 0
                    a = a[..., 0]
                pages.append(a)
            # Heterogeneous page sizes (pyramidal TIFF): keep only pages
            # matching the first (full-resolution) level.
            h0, w0 = pages[0].shape
            pages = [p for p in pages if p.shape == (h0, w0)]
            return np.stack(pages, axis=0)
        arr = _page_to_array(im)
    if arr.ndim == 2:
        return arr[None]
    if arr.ndim == 3:
        # HWC -> CHW when the last axis looks like channels
        if arr.shape[-1] <= arr.shape[0] and arr.shape[-1] <= arr.shape[1]:
            return np.transpose(arr, (2, 0, 1))
        return arr
    raise ValueError(f"unsupported image rank {arr.ndim} for {path}")


def read_mask(path: str) -> np.ndarray:
    """Read a 2-D instance segmentation mask (0=background, 1..N cells)."""
    with Image.open(path) as im:
        arr = np.asarray(im)  # of a multi-page file, the first page
    if arr.ndim == 3:
        arr = arr[:, :, 0]  # preprocess.py:247-249
    return arr.astype(np.int32)


def write_tiff(path: str, array: np.ndarray) -> None:
    """Write a CHW stack as a multi-page TIFF (one page per channel)."""
    array = np.asarray(array)
    if array.ndim == 2:
        array = array[None]
    pages = [Image.fromarray(array[c]) for c in range(array.shape[0])]
    pages[0].save(path, save_all=True, append_images=pages[1:], format="TIFF")
