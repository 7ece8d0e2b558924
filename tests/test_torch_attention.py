"""ribca_tpu_torch attention: the plain version against ribca_tpu's Pallas
kernel (interpret mode) and its XLA composition, on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ribca_tpu.ops.attention import fused_attention as jax_fused
from ribca_tpu.ops.attention import reference_attention as jax_reference
from ribca_tpu_torch.ops.attention import (
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
