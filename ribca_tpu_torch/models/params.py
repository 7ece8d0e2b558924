"""Weights carried across from ribca_tpu: Flax param trees <-> state dicts.

ribca_tpu stores a classifier as a Flax param tree (models/store.py ``.npz``,
nested dicts of numpy arrays). This module maps such a tree onto the port's
timm-named ``state_dict`` (the inverse of ribca_tpu's
``models/convert.py::convert_vit_state_dict``):

  * Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
  * Conv ``kernel`` (kh, kw, in, out) -> Conv2d ``weight`` (out, in, kh, kw);
  * LayerNorm ``scale`` -> ``weight``;
  * ``cls_token`` / ``pos_embed`` pass through.

``random_vit_tree`` draws the seeded random weights ribca_tpu's registry
falls back to (``init_params_np``): the same tree, the same numpy draws in
the same order, so a missing checkpoint gives both packages equal weights.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(tree: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _f32(tree["kernel"]).T.contiguous()
    out[f"{prefix}.bias"] = _f32(tree["bias"])


def _norm(tree: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _f32(tree["scale"])
    out[f"{prefix}.bias"] = _f32(tree["bias"])


def vit_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Flax ViT param tree -> the port's VisionTransformer state dict."""
    out = {
        "cls_token": _f32(tree["cls_token"]),
        "pos_embed": _f32(tree["pos_embed"]),
        "patch_embed.proj.weight": _f32(
            tree["patch_embed"]["kernel"]).permute(3, 2, 0, 1).contiguous(),
        "patch_embed.proj.bias": _f32(tree["patch_embed"]["bias"]),
    }
    blocks = sorted(
        (k for k in tree if k.startswith("blocks_")),
        key=lambda k: int(k.split("_")[1]),
    )
    for name in blocks:
        blk, pre = tree[name], f"blocks.{name.split('_')[1]}"
        _norm(blk["norm1"], f"{pre}.norm1", out)
        _linear(blk["attn"]["qkv"], f"{pre}.attn.qkv", out)
        _linear(blk["attn"]["proj"], f"{pre}.attn.proj", out)
        _norm(blk["norm2"], f"{pre}.norm2", out)
        _linear(blk["mlp"]["fc1"], f"{pre}.mlp.fc1", out)
        _linear(blk["mlp"]["fc2"], f"{pre}.mlp.fc2", out)
    _norm(tree["norm"], "norm", out)
    _linear(tree["head"], "head", out)
    return out


def vit_tree_shapes(in_chans: int, num_classes: int, dim: int,
                    depth: int = 12, patch: int = 4, img_size: int = 40,
                    mlp_ratio: float = 4.0) -> dict:
    """Leaf shapes of ribca_tpu's Flax VisionTransformer param tree."""
    hidden = int(dim * mlp_ratio)

    def dense(i, o):
        return {"kernel": (i, o), "bias": (o,)}

    def norm():
        return {"scale": (dim,), "bias": (dim,)}

    tree = {
        "cls_token": (1, 1, dim),
        "pos_embed": (1, (img_size // patch) ** 2 + 1, dim),
        "patch_embed": {"kernel": (patch, patch, in_chans, dim),
                        "bias": (dim,)},
        "norm": norm(),
        "head": dense(dim, num_classes),
    }
    for i in range(depth):
        tree[f"blocks_{i}"] = {
            "norm1": norm(),
            "attn": {"qkv": dense(dim, 3 * dim), "proj": dense(dim, dim)},
            "norm2": norm(),
            "mlp": {"fc1": dense(dim, hidden), "fc2": dense(hidden, dim)},
        }
    return tree


def random_vit_tree(in_chans: int, num_classes: int, dim: int,
                    depth: int = 12, seed: int = 0) -> dict:
    """Seeded N(0, 0.02^2) weights in ribca_tpu's ``init_params_np`` order:
    leaves drawn one after another over the tree flattened with sorted
    keys (JAX's pytree order for dicts)."""
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        return (rng.standard_normal(node) * 0.02).astype(np.float32)

    return draw(vit_tree_shapes(in_chans, num_classes, dim, depth))
