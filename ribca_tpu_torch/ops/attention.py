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


def _bind(lib: ctypes.CDLL):
    """The typed C entry point ``ribca_attention`` of a built library."""
    fn = lib.ribca_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    return _bind(kernels.load("attention"))


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
    if any(t.stride(-1) != 1 for t in (q, k, v)) and hd > 1:
        raise ValueError(
            "attention kernel takes q, k, v with unit stride along hd, got "
            f"strides {q.stride()}, {k.stride()}, {v.stride()}"
        )


def _empty_output(q):
    """(B, H, L, hd) output whose storage is (B, L, H, hd): the layout in
    which the ViT's ``proj`` reads the heads back as one row per token."""
    b, h, length, hd = q.shape
    return torch.empty(b, length, h, hd, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _launch_args(q, k, v, o) -> tuple[list[int], int]:
    """The element strides of (batch, head, row) of q, k, v, o, in that
    order, and the widest copy in bytes (16, 8, 4 or 2) that every pointer,
    every stride and a row of hd elements allow. The stride of a dim of
    size 1 is never used, so it counts as 0."""
    itemsize = q.element_size()
    strides, spans = [], [q.shape[-1] * itemsize]
    for t in (q, k, v, o):
        spans.append(t.data_ptr())
        for size, stride in zip(t.shape[:3], t.stride()[:3]):
            stride = stride if size > 1 else 0
            strides.append(stride)
            spans.append(stride * itemsize)
    width = 16
    while width > itemsize and any(s % width for s in spans):
        width //= 2
    return strides, width


def _launch(fn, q, k, v, out, scale: float) -> int:
    """Launch the C entry point ``fn`` on checked q, k, v into ``out`` on
    the current stream; its CUDA error code (0: launched)."""
    b, h, length, hd = q.shape
    strides, width = _launch_args(q, k, v, out)
    with torch.cuda.device(q.device):
        return fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, length, hd, (ctypes.c_longlong * 12)(*strides), width,
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )


def fused_attention(q, k, v, scale: float):
    """q, k, v: (B, H, L, hd) -> (B, H, L, hd), strided views with unit
    stride along hd (such as the unbind views of a fused qkv projection).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    whose launches are counted in ``fused_attention.launches``, and get
    an output stored as (B, L, H, hd)."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v)
    out = _empty_output(q)
    if out.numel() == 0:
        return out
    err = _launch(_kernel(), q, k, v, out, scale)
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
