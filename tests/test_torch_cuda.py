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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("length", [7, 8, 9, 10, 11, 13, 14, 15, 16])
@pytest.mark.parametrize("heads", [8, 12])
def test_kernel_matches_plain_at_the_mae_shapes(cuda, dtype, atol, length,
                                                heads):
    """The imputer's blocks: encoder 12 heads over n_present + 1 tokens,
    decoder 8 heads over n_tiles + 1, head dim 64, fused qkv views."""
    q, k, v = _inputs(37, length, heads, 64, dtype, cuda, "fused")
    before = fused_attention.launches
    out = fused_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    ref = reference_attention(q, k, v, 0.125)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.parametrize("panel,missing", [("immune_base", (5,)),
                                           ("immune_full", (4, 9, 13))])
def test_mae_on_the_card_matches_the_cpu(cuda, panel, missing):
    """Full-size MAE imputation in f32: the card (kernel in all 20 blocks)
    against the CPU (plain attention), same seeded weights."""
    import numpy as np

    from ribca_tpu_torch.models.mae import (
        ImputationPlan,
        build_imputer_model,
        impute,
    )
    from ribca_tpu_torch.models.params import mae_state_dict, random_mae_tree
    from ribca_tpu_torch.panels.vocab import IMPUTER_MOSAIC
    from ribca_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # TF32 off
    h, w = IMPUTER_MOSAIC[panel]
    index = [-1 if i in missing else i for i in range(h * w)]
    state = mae_state_dict(random_mae_tree(panel, seed=1))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(32, h * w, 40, 40)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_imputer_model(panel)
        model.load_state_dict(state)
        model = model.to(dev).eval()
        before = fused_attention.launches
        with torch.inference_mode():
            out[dev] = impute(model, ImputationPlan(panel, index, dev),
                              x.to(dev)).cpu()
        assert fused_attention.launches - before == (
            20 if dev == "cuda" else 0)
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= 1e-4
    kept = [i for i in range(h * w) if i not in missing]
    assert torch.equal(out["cuda"][:, kept], x[:, kept])


def test_packer_on_the_card_matches_the_cpu(cuda):
    """The pinned, event-waited copies of the cohort packer route the same
    rows to the same sinks as the CPU path."""
    import numpy as np

    from ribca_tpu_torch.engine.packer import CohortPacker

    class Runner:
        output_spec = {"first": 3}

        def __init__(self, device):
            self.device = torch.device(device)

        def run_chunk(self, patches):
            return {"first": patches[:, :, 0, 0] * 2.0}

    rng = np.random.default_rng(0)
    pieces = [(rng.normal(size=(b, 3, 40, 40)).astype(np.float32), n)
              for b, n in [(64, 40), (64, 45), (128, 128), (64, 64),
                           (128, 100), (64, 7)]]
    sinks = {}
    for dev in ("cpu", "cuda"):
        packer = CohortPacker(Runner(dev), 128, 3)
        sinks[dev] = [packer.make_sink(n) for _, n in pieces]
        for (p, n), sink in zip(pieces, sinks[dev]):
            packer.submit(torch.from_numpy(p).to(dev), n, sink, 0)
        packer.finalize()
    for (p, n), a, b in zip(pieces, sinks["cpu"], sinks["cuda"]):
        np.testing.assert_array_equal(a["first"], b["first"])
        np.testing.assert_array_equal(b["first"], p[:n, :, 0, 0] * 2.0)
