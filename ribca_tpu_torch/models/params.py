"""Weights carried across from ribca_tpu: Flax param trees <-> state dicts.

ribca_tpu stores a classifier as a Flax param tree (models/store.py ``.npz``,
nested dicts of numpy arrays). This module maps such a tree onto the port's
timm-named ``state_dict`` (the inverse of ribca_tpu's
``models/convert.py::convert_vit_state_dict``):

  * Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
  * Conv ``kernel`` (kh, kw, in, out) -> Conv2d ``weight`` (out, in, kh, kw);
  * LayerNorm ``scale`` -> ``weight``;
  * ``cls_token`` / ``pos_embed`` pass through.

``mae_state_dict`` does the same for the MAE imputer (the inverse of
ribca_tpu's ``convert_mae_state_dict``); ``mask_token`` and
``decoder_pos_embed`` pass through too.

``random_vit_tree`` and ``random_mae_tree`` draw the seeded random weights
ribca_tpu's registry falls back to: the same tree, the same numpy draws in
the same order, so a missing checkpoint gives both packages equal weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ribca_tpu_torch.panels.vocab import IMPUTER_MOSAIC


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(tree: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _f32(tree["kernel"]).T.contiguous()
    out[f"{prefix}.bias"] = _f32(tree["bias"])


def _norm(tree: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _f32(tree["scale"])
    out[f"{prefix}.bias"] = _f32(tree["bias"])


def _conv(tree: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _f32(
        tree["kernel"]).permute(3, 2, 0, 1).contiguous()
    out[f"{prefix}.bias"] = _f32(tree["bias"])


def vit_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Flax ViT param tree -> the port's VisionTransformer state dict."""
    out = {
        "cls_token": _f32(tree["cls_token"]),
        "pos_embed": _f32(tree["pos_embed"]),
    }
    _conv(tree["patch_embed"], "patch_embed.proj", out)
    _blocks(tree, "blocks", out)
    _norm(tree["norm"], "norm", out)
    _linear(tree["head"], "head", out)
    return out


def _blocks(tree: dict, group: str, out: dict) -> None:
    """Flax ``<group>_<i>`` blocks -> ``<group>.<i>.*`` state-dict keys."""
    for name in tree:
        i = name[len(group) + 1:]
        if not (name.startswith(f"{group}_") and i.isdigit()):
            continue
        blk, pre = tree[name], f"{group}.{i}"
        _norm(blk["norm1"], f"{pre}.norm1", out)
        _linear(blk["attn"]["qkv"], f"{pre}.attn.qkv", out)
        _linear(blk["attn"]["proj"], f"{pre}.attn.proj", out)
        _norm(blk["norm2"], f"{pre}.norm2", out)
        _linear(blk["mlp"]["fc1"], f"{pre}.mlp.fc1", out)
        _linear(blk["mlp"]["fc2"], f"{pre}.mlp.fc2", out)


def mae_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Flax MAE param tree -> the port's MaskedAutoencoderViT state dict."""
    out = {k: _f32(tree[k]) for k in ("cls_token", "pos_embed", "mask_token",
                                      "decoder_pos_embed")}
    _conv(tree["patch_embed"], "patch_embed.proj", out)
    _blocks(tree, "blocks", out)
    _norm(tree["norm"], "norm", out)
    _linear(tree["decoder_embed"], "decoder_embed", out)
    _blocks(tree, "decoder_blocks", out)
    _norm(tree["decoder_norm"], "decoder_norm", out)
    _linear(tree["decoder_pred"], "decoder_pred", out)
    return out


def vit_tree_shapes(in_chans: int, num_classes: int, dim: int,
                    depth: int = 12, patch: int = 4, img_size: int = 40,
                    mlp_ratio: float = 4.0) -> dict:
    """Leaf shapes of ribca_tpu's Flax VisionTransformer param tree."""
    tree = {
        "cls_token": (1, 1, dim),
        "pos_embed": (1, (img_size // patch) ** 2 + 1, dim),
        "patch_embed": _dense((patch, patch, in_chans), dim),
        "norm": _norm_shapes(dim),
        "head": _dense((dim,), num_classes),
    }
    for i in range(depth):
        tree[f"blocks_{i}"] = _block_shapes(dim, mlp_ratio)
    return tree


def _dense(fan_in: tuple, out: int) -> dict:
    return {"kernel": (*fan_in, out), "bias": (out,)}


def _norm_shapes(dim: int) -> dict:
    return {"scale": (dim,), "bias": (dim,)}


def _block_shapes(dim: int, mlp_ratio: float) -> dict:
    hidden = int(dim * mlp_ratio)
    return {
        "norm1": _norm_shapes(dim),
        "attn": {"qkv": _dense((dim,), 3 * dim), "proj": _dense((dim,), dim)},
        "norm2": _norm_shapes(dim),
        "mlp": {"fc1": _dense((dim,), hidden), "fc2": _dense((hidden,), dim)},
    }


def mae_tree_shapes(grid: tuple, embed_dim: int = 768, depth: int = 12,
                    decoder_embed_dim: int = 512, decoder_depth: int = 8,
                    patch: int = 40, in_chans: int = 1,
                    mlp_ratio: float = 4.0) -> dict:
    """Leaf shapes of ribca_tpu's Flax MaskedAutoencoderViT param tree for
    a (h, w) mosaic grid of ``patch``-pixel tiles."""
    d, dd = embed_dim, decoder_embed_dim
    n_tokens = grid[0] * grid[1] + 1
    tree = {
        "cls_token": (1, 1, d),
        "pos_embed": (1, n_tokens, d),
        "mask_token": (1, 1, dd),
        "decoder_pos_embed": (1, n_tokens, dd),
        "patch_embed": _dense((patch, patch, in_chans), d),
        "norm": _norm_shapes(d),
        "decoder_embed": _dense((d,), dd),
        "decoder_norm": _norm_shapes(dd),
        "decoder_pred": _dense((dd,), patch * patch * in_chans),
    }
    for i in range(depth):
        tree[f"blocks_{i}"] = _block_shapes(d, mlp_ratio)
    for i in range(decoder_depth):
        tree[f"decoder_blocks_{i}"] = _block_shapes(dd, mlp_ratio)
    return tree


def _random_tree(shapes: dict, seed: int = 0) -> dict:
    """Seeded N(0, 0.02^2) weights in ribca_tpu's fallback order: leaves
    drawn one after another over the tree flattened with sorted keys
    (JAX's pytree order for dicts). Every leaf is drawn, the positional
    embeddings too."""
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        return (rng.standard_normal(node) * 0.02).astype(np.float32)

    return draw(shapes)


def random_vit_tree(in_chans: int, num_classes: int, dim: int,
                    depth: int = 12, seed: int = 0) -> dict:
    """ribca_tpu's ``init_params_np`` weights of a classifier."""
    return _random_tree(vit_tree_shapes(in_chans, num_classes, dim, depth),
                       seed)


def random_mae_tree(panel: str, seed: int = 0) -> dict:
    """The weights ribca_tpu's registry draws for a panel's imputer when
    its file is missing (``ModelRegistry.imputer_params``)."""
    return _random_tree(mae_tree_shapes(IMPUTER_MOSAIC[panel]), seed)
