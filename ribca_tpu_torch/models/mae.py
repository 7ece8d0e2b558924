"""Masked-autoencoder ViT marker imputer, PyTorch module.

The port of ribca_tpu's ``models/mae.py`` (reference markerImputer.py:
69-329), with the reference's parameter names so that a reference
``*_impute.pth`` state dict loads as it is: encoder 768 wide, 12 blocks,
12 heads; decoder 512 wide, 8 blocks, 8 heads; patch 40, one input
channel, 2-D sin-cos positional embeddings at init.

The imputation trick: the C channels of a 40x40 cell patch are tiled into
one 1-channel mosaic (full (3, 5), extended (2, 5), base (1, 7)), so each
channel is one MAE token. The reference ranks a deterministic "noise"
(0.1 present, 0.8 missing) so that its random masking keeps exactly the
present channels; ``masking_plan`` computes those keep/restore indices on
the host once. The composite ``x * (1 - mask) + pred * mask``, untiled
back to channels, replaces only the missing channels.

Every block is the ViT's ``Block``, so on the GPU each one calls the
hand-written attention kernel (head dim 64, L <= 16). The module rounds
where ribca_tpu's does: the input and ``pos_embed`` go to the compute
dtype before they are added; ``norm`` and ``decoder_norm`` run in f32;
``decoder_embed`` takes the f32 norm output cast back to the compute
dtype; ``mask_token`` and ``decoder_pos_embed`` are cast to the compute
dtype; ``decoder_pred`` runs in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ribca_tpu_torch.models.vit import LN_EPS, Block, PatchEmbed, _layer_norm
from ribca_tpu_torch.panels.vocab import IMPUTER_MOSAIC

PATCH = 40


# -- fixed sin-cos positional embeddings (public MAE recipe) ------------------


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float32)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim, grid_size, cls_token=False):
    gh, gw = (grid_size, grid_size) if isinstance(grid_size, int) else grid_size
    grid_h = np.arange(gh, dtype=np.float32)
    grid_w = np.arange(gw, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w first (MAE conv.)
    emb = np.concatenate(
        [_sincos_1d(embed_dim // 2, grid[0]), _sincos_1d(embed_dim // 2, grid[1])],
        axis=1,
    )
    if cls_token:
        emb = np.concatenate([np.zeros([1, embed_dim]), emb], axis=0)
    return emb.astype(np.float32)


# -- mosaic tiling + masking plan ---------------------------------------------


def tile_mosaic(data: torch.Tensor, grid: tuple) -> torch.Tensor:
    """(B, h*w, 40, 40) channels -> (B, 1, h*40, w*40) mosaic
    (markerImputer.py:297-300 layout: channel i*w+j at tile (i, j))."""
    b, _, p, q = data.shape
    h, w = grid
    x = data.reshape(b, h, w, p, q).permute(0, 1, 3, 2, 4)
    return x.reshape(b, 1, h * p, w * q)


def untile_mosaic(mosaic: torch.Tensor, grid: tuple,
                  p: int = PATCH) -> torch.Tensor:
    """Inverse of tile_mosaic."""
    b = mosaic.shape[0]
    h, w = grid
    x = mosaic.reshape(b, h, p, w, p).permute(0, 1, 3, 2, 4)
    return x.reshape(b, h * w, p, p)


def unpatchify(tokens: torch.Tensor, grid: tuple,
               p: int = PATCH) -> torch.Tensor:
    """(B, L, p*p) tokens -> (B, 1, h*p, w*p) (markerImputer.py:138-153)."""
    b = tokens.shape[0]
    h, w = grid
    x = tokens.reshape(b, h, w, p, p).permute(0, 1, 3, 2, 4)
    return x.reshape(b, 1, h * p, w * p)


def masking_plan(present_positions, n_tiles: int):
    """Deterministic keep/restore indices replicating the reference's
    noise-ranked masking (markerImputer.py:303-311 + 155-184).

    Returns (ids_keep, ids_restore, token_mask): token_mask[l] is 1 where
    the tile is reconstructed (missing), 0 where kept.
    """
    noise = np.full(n_tiles, 0.8, dtype=np.float32)
    present = [int(i) for i in present_positions]
    noise[present] = 0.1
    ids_shuffle = np.argsort(noise, kind="stable")
    ids_restore = np.argsort(ids_shuffle, kind="stable")
    ids_keep = ids_shuffle[:len(present)]
    mask = np.ones(n_tiles, dtype=np.float32)
    mask[ids_keep] = 0.0
    return ids_keep.astype(np.int32), ids_restore.astype(np.int32), mask


# -- model --------------------------------------------------------------------


class MaskedAutoencoderViT(nn.Module):
    def __init__(self, img_size: tuple, patch_size: int = PATCH,
                 in_chans: int = 1, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, decoder_embed_dim: int = 512,
                 decoder_depth: int = 8, decoder_num_heads: int = 8,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.patch_size = patch_size
        self.grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.from_numpy(get_2d_sincos_pos_embed(
            embed_dim, self.grid, cls_token=True))[None])
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.decoder_embed = nn.Linear(embed_dim, decoder_embed_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim))
        self.decoder_pos_embed = nn.Parameter(torch.from_numpy(
            get_2d_sincos_pos_embed(decoder_embed_dim, self.grid,
                                    cls_token=True))[None])
        self.decoder_blocks = nn.ModuleList(
            Block(decoder_embed_dim, decoder_num_heads, mlp_ratio)
            for _ in range(decoder_depth))
        self.decoder_norm = nn.LayerNorm(decoder_embed_dim, eps=LN_EPS)
        self.decoder_pred = nn.Linear(decoder_embed_dim,
                                      patch_size ** 2 * in_chans)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.patch_embed.proj.weight.dtype

    def forward(self, imgs, ids_keep, ids_restore):
        """imgs: (B, 1, H, W); ids_keep (len_keep,) and ids_restore (L,)
        int64 on the module's device. Returns the predicted tokens
        (B, L, patch_size**2 * in_chans) in f32."""
        dt = self.compute_dtype
        b = imgs.shape[0]
        # ---- encoder
        x = self.patch_embed(imgs.to(dt))
        x = x + self.pos_embed[:, 1:].to(dt)
        x = x.index_select(1, ids_keep)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(dt)
        x = torch.cat([cls.expand(b, -1, -1), x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = _layer_norm(self.norm, x)

        # ---- decoder
        y = self.decoder_embed(x.to(dt))
        n_masked = ids_restore.shape[0] + 1 - y.shape[1]
        mask_tokens = self.mask_token.to(dt).expand(b, n_masked, -1)
        y_ = torch.cat([y[:, 1:], mask_tokens], dim=1)
        y_ = y_.index_select(1, ids_restore)  # unshuffle
        y = torch.cat([y[:, :1], y_], dim=1)
        y = y + self.decoder_pos_embed.to(dt)
        for blk in self.decoder_blocks:
            y = blk(y)
        y = _layer_norm(self.decoder_norm, y)
        return self.decoder_pred(y)[:, 1:]


def build_imputer_model(panel: str) -> MaskedAutoencoderViT:
    """MAE sized for a panel's mosaic (markerImputer.py:260-284), f32
    parameters, values to be loaded."""
    h, w = IMPUTER_MOSAIC[panel]
    return MaskedAutoencoderViT(img_size=(h * PATCH, w * PATCH))


class ImputationPlan:
    """What one panel's imputation needs on the device, built once: the
    keep/restore indices and the pixel mask of the missing tiles."""

    def __init__(self, panel: str, channel_index, device):
        self.grid = IMPUTER_MOSAIC[panel]
        n_tiles = self.grid[0] * self.grid[1]
        present = [k for k, v in enumerate(channel_index) if int(v) != -1]
        keep, restore, token_mask = masking_plan(present, n_tiles)
        self.ids_keep = torch.as_tensor(keep, dtype=torch.int64,
                                        device=device)
        self.ids_restore = torch.as_tensor(restore, dtype=torch.int64,
                                           device=device)
        tokens = torch.from_numpy(token_mask)[None, :, None].expand(
            1, n_tiles, PATCH * PATCH)
        self.mask_img = unpatchify(tokens, self.grid).to(device)


def impute(model: MaskedAutoencoderViT, plan: ImputationPlan,
           x: torch.Tensor) -> torch.Tensor:
    """(B, C, 40, 40) f32 panel patches -> the same with every missing
    channel replaced by the MAE's reconstruction (markerImputer.py:
    294-329); the composite runs in f32."""
    mosaic = tile_mosaic(x, plan.grid)
    pred = model(mosaic, plan.ids_keep, plan.ids_restore)
    pred_img = unpatchify(pred, plan.grid)
    out = mosaic * (1.0 - plan.mask_img) + pred_img * plan.mask_img
    return untile_mosaic(out, plan.grid)
