"""ribca_tpu_torch device ops against their ribca_tpu counterparts on the
CPU: same numpy inputs through both, compared at f32 tolerances."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ribca_tpu.ops import extents as jax_extents
from ribca_tpu.ops import gaussian as jax_gaussian
from ribca_tpu.ops import normalize as jax_normalize
from ribca_tpu.ops import patches as jax_patches
from ribca_tpu.ops.shapes import bucket_dim, pad_image_chw, pad_mask_hw
from ribca_tpu_torch.ops import extents, gaussian, normalize, patches
from tests.synth import make_cells, make_image


@pytest.mark.parametrize("mode", ["reflect", "nearest", "mirror"])
@pytest.mark.parametrize("sigma", [0.3, 1.0, 2.5, 20.0])
def test_gaussian_blur_matches_jax(mode, sigma):
    x = np.random.default_rng(0).uniform(size=(3, 37, 53)).astype(np.float32)
    ref = np.asarray(jax_gaussian.gaussian_blur(jnp.asarray(x), sigma,
                                                mode=mode))
    got = gaussian.gaussian_blur(torch.from_numpy(x), sigma, mode=mode)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("amax", [99.8, 99.0, 95.0, 100.0, 37.5])
def test_pinned_nanpercentile_bitwise(amax):
    rng = np.random.default_rng(int(amax * 10))
    for trial in range(20):
        h, w = rng.integers(3, 70, size=2)
        ch = rng.gamma(2.0, 40.0, size=(h, w)).astype(np.float32)
        if trial % 2:
            ch[rng.random((h, w)) < 0.4] = np.nan  # canonical-pad NaNs
        ref = np.asarray(jax_normalize.pinned_nanpercentile(
            jnp.asarray(ch), amax))
        got = normalize.pinned_nanpercentile(
            torch.from_numpy(ch).reshape(-1), amax).numpy()
        assert got.tobytes() == ref.tobytes(), (trial, got, ref)


def _bucketed_image(h, w, blur, seed=1):
    mask, _ = make_cells(h=h, w=w, n_cells=10, seed=seed)
    img = make_image(mask, n_channels=4, seed=seed)
    img[2] = 0  # an empty channel takes the has_signal=False branch
    pad = normalize.halo_radius(blur)
    return pad_image_chw(img, bucket_dim(h, pad), bucket_dim(w, pad))


@pytest.mark.parametrize("blur,amax", [(0.0, 100.0), (0.3, 99.8),
                                       (0.3, 95.0)])
@pytest.mark.parametrize("hw", [(90, 100), (300, 170)])
def test_normalize_image_masked_matches_jax(blur, amax, hw):
    h, w = hw
    img = _bucketed_image(h, w, blur)
    ref = np.asarray(jax_normalize.normalize_image_masked(
        jnp.asarray(img), h, w, blur=blur, amax=amax))
    got = normalize.normalize_image_masked(
        torch.from_numpy(img), h, w, blur=blur, amax=amax).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_cast_f32_masked_matches_jax():
    img = _bucketed_image(90, 100, 0.0)
    ref = np.asarray(jax_normalize.cast_f32_masked(jnp.asarray(img), 90, 100))
    got = normalize.cast_f32_masked(torch.from_numpy(img), 90, 100).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("prefer_native", [True, False])
def test_cell_extents_integers_equal(prefer_native):
    mask, _ = make_cells(h=120, w=150, n_cells=20, seed=3)
    mask[mask == 7] = 0  # a missing id inside the range
    ref = jax_extents.cell_extents(mask, prefer_native=True)
    got = extents.cell_extents(mask, prefer_native=prefer_native)
    for name in ("rmin", "rmax", "cmin", "cmax", "count"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    np.testing.assert_array_equal(got.mean_row, ref.mean_row)
    np.testing.assert_array_equal(got.mean_col, ref.mean_col)
    np.testing.assert_array_equal(got.present_ids, ref.present_ids)


def _patch_inputs(h=100, w=120, n_cells=14, seed=5, pad_to=None):
    """Normalized, min-shifted image + mask with cells touching every edge,
    optionally inside a canonical pad; returns numpy arrays and extents."""
    mask, _ = make_cells(h=h, w=w, n_cells=n_cells, seed=seed)
    # edge cells: the windows of these clamp at the image borders
    mask[0:5, 0:6] = n_cells + 1
    mask[h - 4:h, w - 7:w] = n_cells + 2
    mask[h - 3:h, 0:4] = n_cells + 3
    img = make_image(mask, n_channels=5, seed=seed).astype(np.float32)
    img = np.asarray(jax_normalize.normalize_image(jnp.asarray(img),
                                                   blur=0.3, amax=99.8))
    if pad_to is not None:
        hb, wb = pad_to
        img = np.pad(img, ((0, 0), (0, hb - h), (0, wb - w)),
                     constant_values=np.nan)
        mask = pad_mask_hw(mask, hb, wb)
    min_val = np.nanmin(img, axis=(1, 2)).astype(np.float32)
    img_zero = (img - min_val[:, None, None]).astype(np.float32)
    ext = jax_extents.cell_extents(mask[:h, :w])
    ids = ext.present_ids
    cells = np.stack([ids, ext.rmin[ids], ext.rmax[ids], ext.cmin[ids],
                      ext.cmax[ids]]).astype(np.int32)
    return img_zero, min_val, mask.astype(np.int32), cells


def _both(img_zero, min_val, mask, cells, **kw):
    ref = jax_patches.extract_patches(
        jnp.asarray(img_zero), jnp.asarray(min_val), jnp.asarray(mask),
        jnp.asarray(cells), **kw)
    got = patches.extract_patches(
        torch.from_numpy(img_zero), torch.from_numpy(min_val),
        torch.from_numpy(mask), torch.from_numpy(cells), **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("patch_size", [40, 48, 30])
def test_extract_patches_matches_jax(patch_size):
    (rp, ra), (gp, ga) = _both(*_patch_inputs(), patch_size=patch_size)
    assert gp.shape == rp.shape
    np.testing.assert_allclose(gp, rp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ga, ra, atol=1e-5, rtol=0)


def test_extract_patches_canonical_pad_and_band_args():
    h, w = 100, 120
    img_zero, min_val, mask, cells = _patch_inputs(pad_to=(130, 160))
    # prepadded canonical upload: true extent given by full_h / full_w
    (rp, ra), (gp, ga) = _both(img_zero, min_val, mask, cells,
                               patch_size=40, full_h=h, full_w=w,
                               prepadded=True)
    np.testing.assert_allclose(gp, rp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ga, ra, atol=1e-5, rtol=0)
    # a row band starting at row 20 of the full image
    off = 20
    keep = cells[1] >= off + 20  # windows inside the band
    (rp, ra), (gp, ga) = _both(img_zero[:, off:], min_val, mask[off:],
                               cells[:, keep], patch_size=40, row_offset=off,
                               full_h=h, full_w=w)
    np.testing.assert_allclose(gp, rp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ga, ra, atol=1e-5, rtol=0)


@pytest.mark.parametrize("index", [
    [0, 1, 2, 3, 4],        # identity
    [4, 2, 0, 1],           # reorder
    [3, -1, 0, 2],          # one blank
    [-1, 2, -1, 1, 0],      # first blank, later -1 takes the last channel
])
def test_panel_gather_matches_jax(index):
    x = np.random.default_rng(6).normal(size=(3, 5, 8, 8)).astype(np.float32)
    ref = np.asarray(jax_patches.apply_panel_gather(
        jnp.asarray(x), jax_patches.build_panel_gather(index, 5)))
    got = patches.apply_panel_gather(
        torch.from_numpy(x), patches.build_panel_gather(index, 5)).numpy()
    np.testing.assert_array_equal(got, ref)
