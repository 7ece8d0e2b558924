"""ribca_tpu_torch attention: the plain version against ribca_tpu's Pallas
kernel (interpret mode) and its XLA composition, on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ribca_tpu.ops.attention import fused_attention as jax_fused
from ribca_tpu.ops.attention import reference_attention as jax_reference
from ribca_tpu_torch.ops.attention import (
    _check,
    _empty_output,
    _launch_args,
    fused_attention,
    reference_attention,
)


def _qkv(hd, seed=0, shape=(4, 12, 101)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(*shape, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("hd", [12, 24, 48])
def test_plain_matches_jax(hd):
    q, k, v = _qkv(hd)
    scale = hd ** -0.5
    got = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              scale).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jax_fused(jq, jk, jv, scale, block_b=4,
                                  interpret=True))
    composed = np.asarray(jax_reference(jq, jk, jv, scale))
    # f32 throughout: only the summation order differs
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, composed, atol=1e-5, rtol=1e-5)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(24, shape=(2, 3, 101)))
    before = fused_attention.launches
    out = fused_attention(q, k, v, 0.2)
    torch.testing.assert_close(out, reference_attention(q, k, v, 0.2),
                               rtol=0, atol=0)
    assert fused_attention.launches == before


def test_other_devices_raise():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        fused_attention(q, q, q, 1.0)


def _fused(b, length, h, hd, seed=0, device="cpu", dtype=torch.float32):
    """The three unbind views of a seeded (B, L, 3, H, hd) fused qkv
    projection, as the ViT passes them, and the fused tensor."""
    if device == "meta":
        qkv = torch.empty(b, length, 3, h, hd, device="meta", dtype=dtype)
    else:
        rng = np.random.default_rng(seed)
        qkv = torch.from_numpy(
            rng.normal(size=(b, length, 3, h, hd)).astype(np.float32)
        ).to(dtype)
    return qkv.permute(2, 0, 3, 1, 4).unbind(0), qkv


@pytest.mark.parametrize("hd", [12, 24, 48])
def test_plain_on_fused_views_matches_copies_and_jax(hd):
    (q, k, v), _ = _fused(3, 101, 4, hd, seed=hd)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    scale = hd ** -0.5
    got = reference_attention(q, k, v, scale)
    copies = [t.contiguous() for t in (q, k, v)]
    torch.testing.assert_close(got, reference_attention(*copies, scale),
                               atol=1e-5, rtol=1e-5)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in copies)
    pallas = np.asarray(jax_fused(jq, jk, jv, scale, block_b=3,
                                  interpret=True))
    composed = np.asarray(jax_reference(jq, jk, jv, scale))
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), composed, atol=1e-5, rtol=1e-5)


def test_output_is_stored_token_major():
    (q, _, _), _ = _fused(2, 101, 12, 24, device="meta")
    out = _empty_output(q)
    assert out.shape == q.shape and out.dtype == q.dtype
    # (B, L, H, hd) storage: proj reads it back as a view
    assert out.transpose(1, 2).is_contiguous()
    assert out.stride() == (101 * 12 * 24, 24, 12 * 24, 1)


def test_launch_args_for_contiguous_inputs():
    q = torch.empty(5, 12, 101, 24, device="meta", dtype=torch.bfloat16)
    o = torch.empty_like(q)
    strides, width = _launch_args(q, q, q, o)
    assert strides == [12 * 101 * 24, 101 * 24, 24] * 4
    assert width == 16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [12, 24, 48, 64])
def test_launch_args_for_fused_views(hd, dtype):
    b, length, h = 5, 101, 12
    (q, k, v), _ = _fused(b, length, h, hd, device="meta", dtype=dtype)
    o = _empty_output(q)
    strides, width = _launch_args(q, k, v, o)
    row = 3 * h * hd
    assert strides == [length * row, hd, row] * 3 + [
        length * h * hd, hd, h * hd]
    # k and v start one and two widths (h * hd) into the token's row
    assert k.data_ptr() - q.data_ptr() == h * hd * q.element_size()
    # the widest copy that the row of one head, hd elements, allows
    head_bytes = hd * q.element_size()
    assert width == min(16, head_bytes & -head_bytes)
    if dtype == torch.bfloat16:
        assert width == {12: 8, 24: 16, 48: 16, 64: 16}[hd]


def test_launch_args_narrow_for_odd_offsets_and_ignore_unit_dims():
    flat = torch.empty(3 * 101 * 24 + 1, device="meta", dtype=torch.bfloat16)
    q, k, v = flat[1:].view(3, 1, 1, 101, 24).unbind(0)
    strides, width = _launch_args(q, k, v, _empty_output(q))
    assert width == 2  # one element in: no pointer is 4-byte aligned
    # B = H = 1: their strides are never used and count as 0
    assert strides == [0, 0, 24] * 3 + [0, 0, 24]
    odd = torch.empty(1, 1, 7, 5, device="meta", dtype=torch.float32)
    assert _launch_args(odd, odd, odd, odd)[1] == 4  # rows of 20 bytes


def test_checks_refuse_what_the_kernel_does_not_take():
    (q, k, v), _ = _fused(2, 101, 12, 24, device="meta")
    _check(q, k, v)  # fused views are taken as they are
    strided = torch.empty(2, 2, 24, 101, device="meta").transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):
        _check(strided, strided, strided)
    long = torch.empty(1, 1, 129, 24, device="meta")
    with pytest.raises(ValueError, match="L <= 128"):
        _check(long, long, long)
    wide = torch.empty(1, 1, 101, 65, device="meta")
    with pytest.raises(ValueError, match="hd <= 64"):
        _check(wide, wide, wide)
    half = torch.empty(2, 2, 101, 24, dtype=torch.float16)
    with pytest.raises(TypeError):
        _check(half, half, half)
    with pytest.raises(ValueError, match="one .B, H, L, hd. shape"):
        _check(q, k[:1], v)
