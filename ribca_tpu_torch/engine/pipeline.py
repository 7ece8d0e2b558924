"""Per-image device pipeline: stage -> normalize -> patches -> ensemble.

The port of the single-shot route of ribca_tpu's ``engine/pipeline.py``.
The reference hands off between preprocessing and prediction through
10k-cell ``.pt`` files on disk (preprocess.py:132-135, model.py:369-391).
Here the hand-off is device memory: patch chunks come out of
ops/patches.py on the device, flow straight into the ensemble
(engine/ensemble.py) through the cohort packer (engine/packer.py), and
only the per-cell results and mean intensities return to the host.

Host <-> device copies go through pinned host buffers with
``non_blocking=True``. The image and mask upload on a side stream while
the host scans the mask for cell extents; the compute stream waits on a
CUDA event recorded after the copies. Each ensemble dispatch's outputs
and each image's intensities come back through one pinned copy and one
event wait (engine/packer.to_host). With a tracer (the Annotator's
Logger) every sub-stage synchronizes at its end, so ``trace.json``
charges device time to the stage that queued it; the device then idles
while the host queues the next chunk's work.

Chunks go to a cohort packer, which shares partly filled ensemble
dispatches across the images of a batch run (the Annotator passes one per
run; without one, the image gets its own). ribca_tpu's banded whole-slide
route is not ported yet: an image above ``device_image_budget_bytes``
raises.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ribca_tpu_torch.engine.packer import (
    CohortPacker,
    chunk_size_for,
    to_host,
)
from ribca_tpu_torch.ops.extents import CellExtents, cell_extents
from ribca_tpu_torch.ops.normalize import (
    cast_f32_masked,
    halo_radius,
    normalize_image_masked,
)
from ribca_tpu_torch.ops.patches import extract_patches
from ribca_tpu_torch.ops.shapes import bucket_dim, pad_image_chw, pad_mask_hw


def trace_stage(tracer, name: str, device: torch.device,
                quiet: bool = True):
    """Sub-stage timing context: the Annotator's Logger when plumbed
    through, a no-op otherwise. On CUDA the stage synchronizes before its
    clock stops, so it is charged for the device work it queued."""
    if tracer is None:
        return contextlib.nullcontext()
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    return tracer.stage(name, quiet=quiet, sync=sync)


@dataclasses.dataclass
class ImageRecord:
    """Everything downstream stages need for one image."""

    cell_ids: np.ndarray          # (N,) present cell ids, ascending
    mean_row: np.ndarray          # (N,) float64 centroid rows
    mean_col: np.ndarray          # (N,) float64 centroid cols
    mask: np.ndarray              # (H, W) int32 instance mask
    intensity_full: np.ndarray    # (N, C) mean intensities in [0, 1]
    panel_probs: dict             # {panel: (N, n_classes) f32}; under
                                  # device voting: {"vote_stats": (N, 3)}
                                  # — [argmax, best vote, min-Others]
                                  # (engine/voting.finish_votes)

    @property
    def n_cells(self) -> int:
        return len(self.cell_ids)


def pack_size(config) -> int:
    """Cells per ensemble dispatch."""
    return min(config.pack_cells, config.chunk_cells)


def make_packer(config, runner, n_channels: int) -> CohortPacker:
    """A cohort packer for ``runner`` sized by the config."""
    return CohortPacker(runner, pack_size(config), n_channels)


def patch_size_for(config) -> int:
    return int(40 * config.cell_size / 30.0)  # preprocess.py:67,77


def check_single_shot(image, config) -> None:
    """The port has only the single-shot route: an image whose f32 copy
    exceeds the device budget needs the banded route, not ported yet."""
    nbytes = int(np.prod(image.shape)) * 4
    if nbytes > config.device_image_budget_bytes:
        raise NotImplementedError(
            f"image of shape {tuple(image.shape)} ({nbytes} B as f32) "
            f"exceeds device_image_budget_bytes="
            f"{config.device_image_budget_bytes}; whole slides take "
            "ribca_tpu's banded route (engine/tiled.py), which "
            "ribca_tpu_torch does not port yet"
        )


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload through a pinned buffer without waiting for the copy. The
    caching host allocator keeps the pinned block alive until the copy
    has run."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class StagedImage:
    """Canonical pad done, image + mask on the device (in the source
    dtype: a uint16 slide uploads half the bytes of f32), extents
    scanned on the host."""

    img_dev: torch.Tensor         # (C, Hb, Wb) source dtype
    mask_dev: torch.Tensor        # (Hb + P, Wb + P) int32
    mask_host: np.ndarray         # true-shape int32
    extents: CellExtents          # of the true mask
    true_hw: tuple
    n_channels: int


def stage_image(image, mask, config, device: torch.device) -> StagedImage:
    """Pad, upload and scan one image for the single-shot route."""
    check_single_shot(image, config)
    if mask.ndim == 3:
        mask = mask[:, :, 0]
    mask = np.ascontiguousarray(mask).astype(np.int32)
    image = np.asarray(image)
    image = image.astype(image.dtype.newbyteorder("="), copy=False)
    c, h, w = image.shape

    if config.canonical_shapes:
        # exactness needs pad >= the Gaussian kernel radius
        pad_min = halo_radius(config.blur) if config.normalize else 0
        hb, wb = bucket_dim(h, pad_min), bucket_dim(w, pad_min)
    else:
        hb, wb = h, w
    # the mask carries one extra patch window of zero pad so that
    # extract_patches(prepadded=True) never re-pads it per chunk
    patch = patch_size_for(config)

    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        with torch.cuda.stream(side):
            img_dev = _to_device(pad_image_chw(image, hb, wb), device)
            mask_dev = _to_device(
                pad_mask_hw(mask, hb + patch, wb + patch), device)
            uploaded = torch.cuda.Event()
            uploaded.record(side)
    else:
        img_dev = _to_device(pad_image_chw(image, hb, wb), device)
        mask_dev = _to_device(pad_mask_hw(mask, hb + patch, wb + patch),
                              device)
    # the host scan overlaps the uploads
    extents = cell_extents(mask, prefer_native=config.use_native_scanner)
    if device.type == "cuda":
        compute = torch.cuda.current_stream(device)
        compute.wait_event(uploaded)
        # allocated on the side stream, used on the compute stream
        img_dev.record_stream(compute)
        mask_dev.record_stream(compute)
    return StagedImage(img_dev, mask_dev, mask, extents, (h, w), c)


def preprocess_image(st: StagedImage, config):
    """Normalize + per-channel min shift; returns (img_zero, min_val) with
    img_zero padded one patch window bottom/right with NaN."""
    h, w = st.true_hw
    if config.normalize:
        img = normalize_image_masked(
            st.img_dev, h, w,
            blur=float(config.blur), amax=float(config.upper_limit),
        )
    else:
        img = cast_f32_masked(st.img_dev, h, w)

    # _move_image_range (preprocess.py:153-157): per-channel min shift.
    # NaN-aware: pad pixels are NaN by the masked-normalization contract.
    min_val = torch.where(torch.isnan(img), torch.inf, img).amin(dim=(1, 2))
    img_zero = img - min_val[:, None, None]
    # one-window NaN pad applied ONCE, so every chunk skips a full-image
    # re-pad; the validity mask zeroes any pad pixel a window touches
    patch = patch_size_for(config)
    img_zero = F.pad(img_zero, (0, patch, 0, patch), value=float("nan"))
    return img_zero, min_val


@torch.inference_mode()
def run_image(image, mask, config, runner, packer=None,
              tracer=None) -> ImageRecord:
    """Full single-image flow: returns per-panel probs (or vote stats) and
    intensities.

    ``packer`` (engine/packer.CohortPacker) shares partial ensemble
    dispatches across the images of a batch run; with one, the record's
    ``panel_probs`` are complete only after ``packer.finalize()``. Without
    one, the image gets its own packer, finalized before return."""
    device = runner.device
    with trace_stage(tracer, "device.stage", device):
        st = stage_image(image, mask, config, device)
    with trace_stage(tracer, "device.preprocess", device):
        img_zero, min_val = preprocess_image(st, config)

    ext = st.extents
    ids = ext.present_ids
    n = len(ids)
    patch = patch_size_for(config)
    true_h, true_w = st.true_hw
    local_packer = packer is None
    if local_packer:
        packer = make_packer(config, runner, st.n_channels)
    chunk = min(packer.pack,
                chunk_size_for(min(max(n, 1), config.chunk_cells),
                               config.chunk_cells))
    sink = packer.make_sink(n)

    int_parts = []
    for start in range(0, n, chunk):
        sel = ids[start:start + chunk]
        n_valid = len(sel)
        # tail chunks drop to their power-of-two bucket; the packer shares
        # the bucket's pad rows with the next image's cells
        size = chunk_size_for(n_valid, chunk)
        cells = np.zeros((5, size), dtype=np.int32)
        cells[0, :n_valid] = sel
        cells[1, :n_valid] = ext.rmin[sel]
        cells[2, :n_valid] = ext.rmax[sel]
        cells[3, :n_valid] = ext.cmin[sel]
        cells[4, :n_valid] = ext.cmax[sel]
        with trace_stage(tracer, "device.extract", device):
            patches, avg_int = extract_patches(
                img_zero, min_val, st.mask_dev, _to_device(cells, device),
                patch_size=patch, full_h=true_h, full_w=true_w,
                prepadded=True,
            )
        with trace_stage(tracer, "device.ensemble", device):
            packer.submit(patches, n_valid, sink, start)
        int_parts.append(avg_int[:n_valid])

    with trace_stage(tracer, "device.download", device):
        (intensity,) = to_host([
            torch.cat(int_parts) if int_parts
            else torch.zeros((0, st.n_channels), device=device)
        ])
    # preprocess.py:146-149, on the host in f32 as ribca_tpu does
    intensity = (intensity + np.float32(1.0)) / np.float32(2.0)
    if local_packer:
        with trace_stage(tracer, "device.finalize", device):
            packer.finalize()

    return ImageRecord(
        cell_ids=ids,
        mean_row=ext.mean_row[ids],
        mean_col=ext.mean_col[ids],
        mask=st.mask_host,
        intensity_full=intensity,
        panel_probs=sink,
    )
