"""ribca_tpu_torch's MAE imputer against ribca_tpu's Flax MAE, on the CPU.

The mosaic helpers, masking plans and sin-cos tables must be exactly equal;
the forward is held to the Flax model in f32 at a narrow width that keeps
the production head dim of 64; the bf16 cast keeps the same parameters in
f32; and the registry's random imputer equals ribca_tpu's bit for bit.
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ribca_tpu.engine.ensemble import EnsembleRunner as JaxRunner
from ribca_tpu.models import mae as jmae
from ribca_tpu.models.registry import ModelRegistry as JaxRegistry
from ribca_tpu.models.vit import build_panel_model as flax_panel_model
from ribca_tpu.models.vit import init_params_np
from ribca_tpu_torch.models import mae
from ribca_tpu_torch.models.params import (
    mae_state_dict,
    mae_tree_shapes,
    vit_state_dict,
)
from ribca_tpu_torch.models.registry import ModelRegistry
from ribca_tpu_torch.models.vit import build_panel_model, cast_for_compute
from ribca_tpu_torch.panels.vocab import IMPUTER_MOSAIC, PANEL_MISSING_BUDGET
from tests.torch_mirror import TorchMAE

PANELS = sorted(IMPUTER_MOSAIC)
# narrow, shallow, but with the production head dim of 64
NARROW = dict(embed_dim=128, depth=2, num_heads=2, decoder_embed_dim=128,
              decoder_depth=1, decoder_num_heads=2)


def _missing_patterns(panel):
    h, w = IMPUTER_MOSAIC[panel]
    n = h * w
    for k in range(1, PANEL_MISSING_BUDGET[panel] + 1):
        yield from itertools.combinations(range(n), k)


@pytest.mark.parametrize("panel", PANELS)
def test_masking_plans_and_pixel_masks_equal(panel):
    h, w = IMPUTER_MOSAIC[panel]
    n = h * w
    count = 0
    for missing in _missing_patterns(panel):
        present = [i for i in range(n) if i not in missing]
        got = mae.masking_plan(present, n)
        want = jmae.masking_plan(present, n)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
        index = [-1 if i in missing else i for i in range(n)]
        plan = mae.ImputationPlan(panel, index, "cpu")
        token_mask = jnp.asarray(want[2])[None, :, None]
        want_img = jmae.unpatchify(token_mask * jnp.ones((1, n, 1600)),
                                   (h, w), 40)
        np.testing.assert_array_equal(plan.mask_img.numpy(),
                                      np.asarray(want_img))
        np.testing.assert_array_equal(plan.ids_keep.numpy(), want[0])
        np.testing.assert_array_equal(plan.ids_restore.numpy(), want[1])
        count += 1
    assert count == sum(1 for _ in _missing_patterns(panel))


@pytest.mark.parametrize("panel", PANELS)
def test_mosaic_helpers_equal(panel):
    grid = IMPUTER_MOSAIC[panel]
    n = grid[0] * grid[1]
    rng = np.random.default_rng(1)
    data = rng.normal(size=(3, n, 40, 40)).astype(np.float32)
    tokens = rng.normal(size=(3, n, 1600)).astype(np.float32)
    mosaic = mae.tile_mosaic(torch.from_numpy(data), grid)
    np.testing.assert_array_equal(
        mosaic.numpy(), np.asarray(jmae.tile_mosaic(jnp.asarray(data), grid)))
    np.testing.assert_array_equal(
        mae.untile_mosaic(mosaic, grid).numpy(), data)
    np.testing.assert_array_equal(
        mae.unpatchify(torch.from_numpy(tokens), grid).numpy(),
        np.asarray(jmae.unpatchify(jnp.asarray(tokens), grid, 40)))


@pytest.mark.parametrize("dim", [128, 512, 768])
@pytest.mark.parametrize("panel", PANELS)
def test_sincos_tables_equal(panel, dim):
    grid = IMPUTER_MOSAIC[panel]
    for cls in (False, True):
        got = mae.get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
        want = jmae.get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        mae._sincos_1d(dim, np.arange(5, dtype=np.float32)),
        jmae._sincos_1d(dim, np.arange(5, dtype=np.float32)))


def _narrow_pair(panel, seed):
    """A narrow Flax MAE with Flax-initialised weights plus seeded noise on
    every leaf (so zero-initialised tokens and biases matter), and the
    port's model with the same weights through ``mae_state_dict``."""
    h, w = IMPUTER_MOSAIC[panel]
    flax_model = jmae.MaskedAutoencoderViT(img_size=(h * 40, w * 40),
                                           **NARROW)
    dummy = jnp.zeros((1, 1, h * 40, w * 40), jnp.float32)
    ids = jnp.arange(h * w, dtype=jnp.int32)
    tree = flax_model.init(jax.random.PRNGKey(seed), dummy, ids, ids)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), tree["params"])
    port = mae.MaskedAutoencoderViT(img_size=(h * 40, w * 40), **NARROW)
    port.load_state_dict(mae_state_dict(tree), strict=True)
    return flax_model, tree, port.eval()


def _plan(panel, missing):
    h, w = IMPUTER_MOSAIC[panel]
    present = [i for i in range(h * w) if i not in missing]
    return mae.masking_plan(present, h * w)


@pytest.mark.parametrize("panel,missing", [("immune_base", (5,)),
                                           ("immune_full", (4, 9, 13))])
def test_forward_matches_flax_f32(panel, missing):
    flax_model, tree, port = _narrow_pair(panel, seed=3)
    h, w = IMPUTER_MOSAIC[panel]
    x = np.random.default_rng(4).normal(
        size=(4, 1, h * 40, w * 40)).astype(np.float32)
    keep, restore, _ = _plan(panel, missing)
    want = np.asarray(flax_model.apply(
        {"params": tree}, jnp.asarray(x), jnp.asarray(keep),
        jnp.asarray(restore)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(keep).long(),
                   torch.from_numpy(restore).long()).numpy()
    assert got.shape == want.shape == (4, h * w, 1600)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("panel,missing", [("immune_base", (2,)),
                                           ("immune_full", (0, 7))])
def test_reference_state_dict_loads_strict(panel, missing):
    h, w = IMPUTER_MOSAIC[panel]
    torch.manual_seed(6)
    ref = TorchMAE(img_size=(h * 40, w * 40), dim=128, depth=2, heads=2,
                   dec_dim=128, dec_depth=1, dec_heads=2).eval()
    port = mae.MaskedAutoencoderViT(img_size=(h * 40, w * 40), **NARROW)
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, 1, h * 40, w * 40)).astype(np.float32))
    keep, restore, _ = _plan(panel, missing)
    keep, restore = torch.from_numpy(keep).long(), torch.from_numpy(
        restore).long()
    with torch.inference_mode():
        np.testing.assert_allclose(port.eval()(x, keep, restore).numpy(),
                                   ref(x, keep, restore).numpy(),
                                   atol=1e-5, rtol=0)


def test_full_size_tree_shapes_match_flax():
    for panel in PANELS:
        h, w = IMPUTER_MOSAIC[panel]
        model = jmae.build_imputer_model(panel)
        dummy = jnp.zeros((1, 1, h * 40, w * 40), jnp.float32)
        ids = jnp.arange(h * w, dtype=jnp.int32)
        shapes = jax.eval_shape(
            lambda m=model, d=dummy, i=ids: m.init(
                jax.random.PRNGKey(0), d, i, i)["params"])
        want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
        assert mae_tree_shapes((h, w)) == want


def _flags_kept_f32(cast_tree):
    """A tree of the cast leaves' dtypes as constant 1.0 (kept f32) / 0.0
    (cast), so the bridge maps it onto the port's parameter names."""
    return jax.tree_util.tree_map(
        lambda a: np.full(np.shape(a),
                          1.0 if jnp.asarray(a).dtype == jnp.float32 else 0.0,
                          np.float32),
        cast_tree)


def _port_kept_f32(model):
    cast_for_compute(model, torch.bfloat16)
    return {n for n, p in model.named_parameters()
            if p.dtype == torch.float32}


@pytest.mark.parametrize("kind", ["mae", "vit"])
def test_bf16_cast_keeps_what_ribca_tpu_keeps(kind):
    if kind == "mae":
        tree = jax.tree_util.tree_map(
            np.zeros, mae_tree_shapes((1, 7), depth=2, decoder_depth=2),
            is_leaf=lambda x: isinstance(x, tuple))
        model, bridge = mae.MaskedAutoencoderViT(
            img_size=(40, 280), embed_dim=128, depth=2, num_heads=2,
            decoder_embed_dim=128, decoder_depth=2,
            decoder_num_heads=2), mae_state_dict
    else:
        tree = init_params_np(flax_panel_model("immune_base"))
        model, bridge = build_panel_model("immune_base"), vit_state_dict
    jax_runner = types.SimpleNamespace(dtype=jnp.bfloat16)
    cast = JaxRunner._cast_params(jax_runner, tree)
    flags = bridge(_flags_kept_f32(cast))
    want = {n for n, t in flags.items() if bool(t.flatten()[0] == 1.0)}
    got = _port_kept_f32(model)
    assert got == want
    assert any(".norm1." in n for n in got)
    if kind == "mae":
        assert {"decoder_pred.weight", "decoder_norm.weight",
                "norm.weight"} <= got
        assert "decoder_embed.weight" not in got


def test_random_imputer_equals_ribca_tpu_fallback(tmp_path):
    """Full size, one panel: ~110 M draws on each side."""
    want_tree = JaxRegistry(str(tmp_path)).imputer_params("immune_base")
    want = mae_state_dict(jax.tree_util.tree_map(np.asarray, want_tree))
    del want_tree
    registry = ModelRegistry(str(tmp_path))
    got = registry.imputer_params("immune_base")
    assert registry.used_random
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == want[name].dtype == torch.float32
        assert torch.equal(got[name], want[name]), name
    # the positional embeddings are random draws there, not sin-cos
    assert not np.allclose(got["pos_embed"].numpy()[0],
                           mae.get_2d_sincos_pos_embed(768, (1, 7), True))
    model = mae.build_imputer_model("immune_base")
    model.load_state_dict(got, strict=True)
