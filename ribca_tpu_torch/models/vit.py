"""Vision Transformer classifier family, PyTorch modules.

The port of ribca_tpu's ``models/vit.py`` (reference model.py:31-88, timm
semantics), with timm's parameter names so that a reference ``.pth`` state
dict loads as it is:

  * patch_embed Conv k=4 s=4 over 40x40 -> 100 tokens + cls, learned
    pos_embed over 101 positions;
  * 12 pre-norm blocks: x + attn(norm1(x)), x + mlp(norm2(x)); fused qkv
    with bias; 12 heads; exact (erf) GELU; LayerNorm eps 1e-6;
  * logits = head(norm(tokens)[:, 0]).

Widths: tiny=144, s=288, m=384, l=576 (model.py:66-88). The matmuls run in
the compute dtype of the module's parameters (bf16 in production, f32 for
parity); LayerNorms, the attention softmax and the head stay f32, as
``cast_for_compute`` leaves them. Attention goes through
``ops.attention.fused_attention``: the CUDA kernel on the GPU, the plain
composition on the CPU.

ribca_tpu's experimental int8 ``QuantDense`` is not ported (it is off the
production path).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ribca_tpu_torch.ops.attention import fused_attention
from ribca_tpu_torch.panels.vocab import PANEL_MODEL_SPECS

ARCH_WIDTHS = {"vit_tiny": 144, "vit_s": 288, "vit_m": 384, "vit_l": 576}
LN_EPS = 1e-6


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm whatever the stream's dtype, as ribca_tpu's blocks."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, patch)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                  d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # views, no copy
        x = fused_attention(q, k, v, self.scale)
        return self.proj(x.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # timm nn.GELU: the erf form


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(_layer_norm(self.norm1, x).to(x.dtype))
        return x + self.mlp(_layer_norm(self.norm2, x).to(x.dtype))


class VisionTransformer(nn.Module):
    """timm-faithful ViT (reference model.py:31-88).

    With bf16 parameters, logits are not bit-identical to f32: labels agree
    at a measured rate, not by construction (ribca_tpu's
    tests/test_dtype_agreement.py; chip_smoke.py prints the port's rate).
    Exact reference parity needs f32."""

    def __init__(self, in_chans: int, num_classes: int, embed_dim: int,
                 img_size: int = 40, patch_size: int = 4, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_classes = num_classes
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1,
                                                  embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = nn.Linear(embed_dim, num_classes)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.patch_embed.proj.weight.dtype

    def forward(self, x):
        """x: (B, C, H, W) float; returns logits (B, num_classes) f32."""
        x = self.patch_embed(x.to(self.compute_dtype))
        cls = self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = _layer_norm(self.norm, x)[:, 0]
        return self.head(x)


def cast_for_compute(model: VisionTransformer,
                     dtype: torch.dtype) -> VisionTransformer:
    """Cast the matmul/conv parameters (and cls/pos) to ``dtype`` in place,
    leaving every LayerNorm and the head in f32 as ribca_tpu's
    ``EnsembleRunner._cast_params`` does."""
    for name, param in model.named_parameters():
        top = name.split(".")[0]
        if top in ("norm", "head") or ".norm" in name:
            continue
        param.data = param.data.to(dtype)
    return model


def build_panel_model(panel: str) -> VisionTransformer:
    """Classifier for a panel per the reference's load table
    (model.py:188-239), f32 parameters, values to be loaded."""
    arch, in_chans, num_classes = PANEL_MODEL_SPECS[panel]
    return VisionTransformer(in_chans=in_chans, num_classes=num_classes,
                             embed_dim=ARCH_WIDTHS[arch])
