"""ribca_tpu_torch ViT and weight bridge against ribca_tpu's Flax model."""

import jax
import numpy as np
import pytest
import torch

from ribca_tpu.models.convert import convert_vit_state_dict
from ribca_tpu.models.vit import (
    VisionTransformer as FlaxViT,
    build_panel_model as flax_panel_model,
    init_params,
    init_params_np,
)
from ribca_tpu_torch.models.params import random_vit_tree, vit_state_dict
from ribca_tpu_torch.models.vit import VisionTransformer, cast_for_compute


def _flax_and_port(width, depth, seed=0, in_chans=7, classes=5):
    fm = FlaxViT(in_chans=in_chans, num_classes=classes, embed_dim=width,
                 depth=depth)
    tree = jax.tree_util.tree_map(np.asarray, init_params(fm, seed=seed))
    pm = VisionTransformer(in_chans=in_chans, num_classes=classes,
                           embed_dim=width, depth=depth)
    pm.load_state_dict(vit_state_dict(tree))
    return fm, tree, pm.eval()


def test_bridge_round_trip():
    _, tree, _ = _flax_and_port(144, depth=2)
    sd = {k: v.numpy() for k, v in vit_state_dict(tree).items()}
    back = convert_vit_state_dict(sd, depth=2)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    back_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in leaves] == [p for p, _ in back_leaves]
    for (path, a), (_, b) in zip(leaves, back_leaves):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_random_init_matches_jax_registry_fallback():
    ours = random_vit_tree(7, 5, 288, depth=12, seed=0)
    ref = init_params_np(flax_panel_model("immune_base"), seed=0)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    our_leaves = jax.tree_util.tree_leaves_with_path(ours)
    assert [p for p, _ in leaves] == [p for p, _ in our_leaves]
    for (_, a), (_, b) in zip(leaves, our_leaves):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("width", [144, 288])
def test_vit_matches_flax(width):
    fm, tree, pm = _flax_and_port(width, depth=2, seed=1)
    x = np.random.default_rng(2).normal(size=(16, 7, 40, 40)).astype(
        np.float32)
    ref = np.asarray(fm.apply({"params": tree}, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    # f32 on both sides; the LayerNorm variance is computed two ways
    # (Flax E[x^2]-E[x]^2, torch two-pass) and matmuls sum in other orders
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_cast_for_compute_keeps_norms_and_head_f32():
    pm = cast_for_compute(
        VisionTransformer(in_chans=7, num_classes=5, embed_dim=144,
                          depth=2), torch.bfloat16)
    for name, p in pm.named_parameters():
        f32 = name.startswith(("norm.", "head.")) or ".norm" in name
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    x = torch.zeros(2, 7, 40, 40)
    assert pm(x).dtype == torch.float32
