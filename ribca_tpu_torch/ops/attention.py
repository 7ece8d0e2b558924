"""Short-sequence multi-head attention: a CUDA kernel and its plain version.

``fused_attention`` is the port of the Pallas TPU kernel
``ribca_tpu/ops/attention.py::fused_attention``. Every ViT block calls it
(models/vit.py). For a CUDA tensor it launches the hand-written kernel in
``csrc/attention.cu`` and raises if it cannot; for a CPU tensor it runs
``reference_attention``, the same function in plain PyTorch, which the
CPU tests hold against the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ribca_tpu_torch import kernels

MAX_LEN = 128
MAX_HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, scale: float):
    """(B, H, L, hd) attention as the ViT's plain composition: q scaled in
    its own dtype, an f32 softmax over the keys, P cast back to the input
    dtype before P V."""
    s = (q * scale) @ k.transpose(-2, -1)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return p @ v


@functools.cache
def _kernel():
    fn = kernels.load("attention").ribca_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"q, k, v must share one (B, H, L, hd) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"attention kernel takes float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    _, _, length, hd = q.shape
    if not (1 <= length <= MAX_LEN and 1 <= hd <= MAX_HEAD_DIM):
        raise ValueError(
            f"attention kernel takes L <= {MAX_LEN} and hd <= "
            f"{MAX_HEAD_DIM}, got L={length}, hd={hd}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel takes contiguous q, k, v")


def fused_attention(q, k, v, scale: float):
    """q, k, v: (B, H, L, hd) -> (B, H, L, hd). CPU tensors take the plain
    version; CUDA tensors launch the kernel, whose launches are counted in
    ``fused_attention.launches``."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v)
    b, h, length, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, length, hd, float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = kernels.load("attention").ribca_cuda_error_string
        msg.restype = ctypes.c_char_p
        raise RuntimeError(
            f"attention kernel launch failed: CUDA error {err} "
            f"({msg(err).decode()})"
        )
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
