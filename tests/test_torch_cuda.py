"""ribca_tpu_torch's CUDA kernels against their plain versions on the card.

These tests need an NVIDIA GPU with nvcc; on a host without CUDA they skip.
This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from ribca_tpu_torch.ops.attention import fused_attention, reference_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("length,hd", [(101, 12), (101, 24), (101, 48),
                                       (16, 64), (128, 64), (7, 5)])
def test_kernel_matches_plain(cuda, dtype, atol, length, hd):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(64, 12, length, hd, device=cuda, generator=g)
               .to(dtype) for _ in range(3))
    before = fused_attention.launches
    out = fused_attention(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    ref = reference_attention(q, k, v, hd ** -0.5)
    assert out.dtype == dtype and out.shape == q.shape
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
