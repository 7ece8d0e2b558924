"""ribca_tpu_torch's CUDA kernels against their plain versions on the card.

These tests need an NVIDIA GPU with nvcc; on a host without CUDA they skip.
This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import ctypes

import pytest
import torch

from ribca_tpu_torch.ops.attention import (
    _kernel,
    _launch_args,
    fused_attention,
    reference_attention,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(b, length, h, hd, dtype, device, layout):
    """q, k, v of (B, H, L, hd): contiguous, or the three unbind views of a
    (B, L, 3, H, hd) fused projection, as the ViT passes them."""
    g = torch.Generator(device=device).manual_seed(0)
    if layout == "fused":
        qkv = torch.randn(b, length, 3, h, hd, device=device, generator=g)
        return qkv.to(dtype).permute(2, 0, 3, 1, 4).unbind(0)
    return tuple(torch.randn(b, h, length, hd, device=device, generator=g)
                 .to(dtype) for _ in range(3))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [5, 12, 24, 32, 48, 64])
@pytest.mark.parametrize("length", [1, 7, 16, 101, 128])
@pytest.mark.parametrize("layout", ["contiguous", "fused"])
def test_kernel_matches_plain(cuda, dtype, atol, length, hd, layout):
    q, k, v = _inputs(37, length, 12, hd, dtype, cuda, layout)
    assert q.is_contiguous() == (layout == "contiguous")
    before = fused_attention.launches
    out = fused_attention(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    ref = reference_attention(q, k, v, hd ** -0.5)
    assert out.dtype == dtype and out.shape == q.shape
    # stored as (B, L, H, hd): proj reads the heads back without a copy
    assert out.transpose(1, 2).is_contiguous()
    assert (out.float() - ref.float()).abs().max().item() <= atol


def test_kernel_rejects_what_it_does_not_take(cuda):
    strided = torch.zeros(2, 2, 24, 101, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        fused_attention(strided, strided, strided, 1.0)
    big = torch.zeros(1, 1, 129, 24, device=cuda)
    with pytest.raises(ValueError):
        fused_attention(big, big, big, 1.0)
    half = torch.zeros(2, 2, 101, 24, device=cuda, dtype=torch.half)
    with pytest.raises(TypeError):
        fused_attention(half, half, half, 1.0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_kernel_takes_views_at_odd_offsets(cuda, dtype, atol):
    # one element in: no pointer is 16-byte aligned, the copies narrow
    flat = torch.randn(3 * 5 * 12 * 101 * 24 + 1, device=cuda).to(dtype)
    q, k, v = flat[1:].view(3, 5, 12, 101, 24).unbind(0)
    out = fused_attention(q, k, v, 0.2)
    ref = reference_attention(q, k, v, 0.2)
    torch.cuda.synchronize()
    assert _launch_args(q, k, v, out)[1] == flat.element_size()
    assert (out.float() - ref.float()).abs().max().item() <= atol


def test_kernel_refuses_a_width_the_pointers_do_not_allow(cuda):
    flat = torch.zeros(4 * 101 * 24 + 1, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(1, 4, 101, 24)
    out = torch.empty(1, 4, 101, 24, device=cuda, dtype=torch.bfloat16)
    strides, width = _launch_args(q, q, q, out)
    assert width == 2
    err = _kernel()(q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(),
                    1, 4, 101, 24, (ctypes.c_longlong * 12)(*strides), 16,
                    0.2, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue, nothing launched
