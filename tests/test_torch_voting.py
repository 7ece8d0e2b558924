"""ribca_tpu_torch device vote stats against ribca_tpu's, on every merge
branch tests/test_device_voting.py covers."""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from ribca_tpu.engine import voting as jax_voting
from ribca_tpu.panels.vocab import PANEL_CLASS_MAPS
from ribca_tpu_torch.engine import voting

N = 257

BRANCHES = [
    ("immune_full", "structure", "nerve_cell"),
    ("immune_full", "structure"),
    ("immune_extended", "structure", "nerve_cell"),  # nerve ignored
    ("immune_base", "structure"),
    ("structure", "nerve_cell"),
    ("immune_base", "nerve_cell"),
    ("immune_base",),
    ("structure",),
    ("nerve_cell",),
]


def _probs(panels):
    rng = np.random.default_rng(zlib.crc32(",".join(panels).encode()))
    out = {}
    for p in panels:
        logits = rng.normal(0, 1.5, size=(N, len(PANEL_CLASS_MAPS[p])))
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        out[p] = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    # exact ties: argmax must take the first maximum on both sides
    first = panels[0]
    out[first][:8] = np.float32(1.0 / out[first].shape[1])
    return out


@pytest.mark.parametrize("panels", BRANCHES)
def test_device_vote_stats_equal_jax(panels):
    probs = _probs(panels)
    ref_plan = jax_voting.build_vote_plan(list(panels))
    ref = np.asarray(jax_voting.device_vote_stats(probs, ref_plan))
    plan = voting.build_vote_plan(list(panels))
    assert dataclasses.astuple(plan) == dataclasses.astuple(ref_plan)
    got = voting.device_vote_stats(
        {p: torch.from_numpy(v) for p, v in probs.items()}, plan).numpy()
    np.testing.assert_array_equal(got, ref)

    conf = 0.3
    ctc = {name: -1 for p in panels for name in PANEL_CLASS_MAPS[p].values()}
    ctc[sorted(ctc)[0]] = 0.5
    labels, confs = voting.finish_votes(got, plan, conf, ctc)
    ref_labels, ref_confs = jax_voting.finish_votes(ref, ref_plan, conf, ctc)
    assert labels == ref_labels
    np.testing.assert_array_equal(confs, ref_confs)
