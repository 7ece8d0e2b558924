"""The port's cohort packer (engine/packer.py), on the CPU.

Per-image results through one shared packer must equal per-image runs;
for the same sequence of pieces the port's packer must dispatch and count
the same rows as ribca_tpu's, and route every valid row to its sink.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ribca_tpu.engine.packer import CohortPacker as JaxPacker
from ribca_tpu.parallel.mesh import get_mesh
from ribca_tpu_torch.engine.ensemble import EnsembleRunner
from ribca_tpu_torch.engine.packer import CohortPacker, _Segment
from ribca_tpu_torch.engine.pipeline import run_image
from ribca_tpu_torch.models.registry import ModelRegistry
from ribca_tpu_torch.panels.parser import MarkerParser
from ribca_tpu_torch.panels.vocab import PANELS
from ribca_tpu_torch.utils.config import AnnotatorConfig
from tests.synth import make_cells, make_image

C = 3


class _PortRunner:
    """Row-wise deterministic stand-in for the ensemble: fresh tensors."""

    device = torch.device("cpu")
    output_spec = {"first": C, "mean": C}

    def __init__(self):
        self.seen = []

    def run_chunk(self, patches):
        self.seen.append(patches.clone())
        return {"first": patches[:, :, 0, 0] * 2.0,
                "mean": patches.mean(dim=(2, 3))}


class _JaxRunner:
    output_spec = {"first": C, "mean": C}

    def __init__(self):
        self.mesh = get_mesh()

    def run_chunk(self, patches):
        return {"first": patches[:, :, 0, 0] * 2.0,
                "mean": patches.mean(axis=(2, 3))}


def _pieces(spec, seed=0):
    """(bucket, n_valid) pairs -> f32 pieces whose pad rows are NaN, so a
    pad row that reached a sink would show."""
    rng = np.random.default_rng(seed)
    out = []
    for bucket, n_valid in spec:
        p = rng.normal(size=(bucket, C, 40, 40)).astype(np.float32)
        p[n_valid:] = np.nan
        out.append((p, n_valid))
    return out


def _run(packer, pieces, to_array):
    sinks = []
    for p, n_valid in pieces:
        sink = packer.make_sink(n_valid)
        packer.submit(to_array(p), n_valid, sink, 0)
        sinks.append(sink)
    packer.finalize()
    return sinks


# (pack, [(bucket, n_valid), ...]); buckets are multiples of the JAX
# test mesh's 8 devices
SEQUENCES = {
    "straddle": (64, [(64, 40), (64, 45), (64, 64), (64, 10)]),
    "full_direct": (128, [(128, 128), (64, 50), (128, 100), (64, 64),
                          (64, 1)]),
    "many_tails": (64, [(64, 33)] * 7),
    "growth": (256, [(64, 60), (128, 90), (256, 200), (64, 5), (256, 256),
                     (128, 127)]),
    "one_piece": (64, [(64, 3)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_rows_and_sinks_match_ribca_tpu(name):
    pack, spec = SEQUENCES[name]
    pieces = _pieces(spec)
    port = CohortPacker(_PortRunner(), pack, C)
    ref = JaxPacker(_JaxRunner(), pack, C, prefetch_depth=2)
    got = _run(port, pieces, torch.from_numpy)
    want = _run(ref, pieces, jnp.asarray)
    assert port.dispatched_rows == ref.dispatched_rows
    assert port.valid_rows == ref.valid_rows == sum(n for _, n in spec)
    assert port.pad_fraction == ref.pad_fraction
    for (p, n_valid), g, w in zip(pieces, got, want):
        np.testing.assert_array_equal(g["first"], w["first"])
        np.testing.assert_array_equal(g["first"],
                                      p[:n_valid, :, 0, 0] * 2.0)
        np.testing.assert_allclose(g["mean"], w["mean"], atol=1e-6)
        assert np.isfinite(g["mean"]).all()


def test_segment_split():
    sink = {}
    seg = _Segment(sink, rec_off=100, buf_start=40, length=45)
    head, tail = seg.split(24)
    assert (head.rec_off, head.buf_start, head.length) == (100, 40, 24)
    assert (tail.rec_off, tail.buf_start, tail.length) == (124, 0, 21)
    assert head.sink is tail.sink is sink
    assert head.rows() == slice(100, 124) and tail.rows() == slice(124, 145)


def test_segment_split_across_a_flush_boundary():
    (p1, n1), (p2, n2) = _pieces([(64, 40), (64, 45)])
    runner = _PortRunner()
    packer = CohortPacker(runner, 64, C)
    s1, s2 = packer.make_sink(n1), packer.make_sink(n2)
    packer.submit(torch.from_numpy(p1), n1, s1, 0)
    packer.submit(torch.from_numpy(p2), n2, s2, 0)
    # the front 64 rows went out: 40 of image 1, the first 24 of image 2
    assert packer.dispatched_rows == 64 and packer.fill == 21
    (tail,) = packer.segments
    assert (tail.sink is s2, tail.rec_off, tail.buf_start, tail.length) == (
        True, 24, 0, 21)
    packer.finalize()
    np.testing.assert_array_equal(s1["first"], p1[:n1, :, 0, 0] * 2.0)
    np.testing.assert_array_equal(s2["first"], p2[:n2, :, 0, 0] * 2.0)


def test_shift_leaves_the_dispatched_front_intact():
    """The front is dispatched as a view of the staging buffer and the
    remainder then moves down over it: the ensemble must have read the
    front before the move."""
    (p1, n1), (p2, n2) = _pieces([(64, 40), (64, 60)], seed=3)
    runner = _PortRunner()
    packer = CohortPacker(runner, 64, C)
    sinks = [packer.make_sink(n1), packer.make_sink(n2)]
    packer.submit(torch.from_numpy(p1), n1, sinks[0], 0)
    packer.submit(torch.from_numpy(p2), n2, sinks[1], 0)
    front = runner.seen[0]
    np.testing.assert_array_equal(front[:40].numpy(), p1[:40])
    np.testing.assert_array_equal(front[40:64].numpy(), p2[:24])
    packer.finalize()
    np.testing.assert_array_equal(runner.seen[1][:36].numpy(), p2[24:60])
    for (p, n), sink in zip([(p1, n1), (p2, n2)], sinks):
        np.testing.assert_array_equal(sink["first"], p[:n, :, 0, 0] * 2.0)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sinks_are_written_when_their_rows_dispatch(name):
    """Each dispatch's rows reach their sinks before the next submit: no
    result waits for finalize() once its dispatch has gone out."""
    pack, spec = SEQUENCES[name]
    packer = CohortPacker(_PortRunner(), pack, C)
    for p, n_valid in _pieces(spec):
        sink = packer.make_sink(n_valid)
        sink["first"][:] = np.nan
        packer.submit(torch.from_numpy(p), n_valid, sink, 0)
        staged = sum(s.length for s in packer.segments if s.sink is sink)
        done = n_valid - staged
        np.testing.assert_array_equal(sink["first"][:done],
                                      p[:done, :, 0, 0] * 2.0)
        assert np.isnan(sink["first"][done:]).all()


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    mf = tmp_path_factory.mktemp("mk") / "markers.txt"
    mf.write_text("\n".join(PANELS["immune_base"]) + "\n")
    parser = MarkerParser(strict=True)
    parser.parse(str(mf))
    registry = ModelRegistry(str(tmp_path_factory.mktemp("empty")))
    return EnsembleRunner(parser, registry, n_channels=7, infer=False,
                          dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def cohort():
    images = []
    for i, n_cells in enumerate([23, 17, 29]):
        mask, _ = make_cells(h=120, w=110, n_cells=n_cells, seed=20 + i)
        images.append((make_image(mask, n_channels=7, seed=20 + i), mask))
    return images


def _run_cohort(images, cfg, runner, pack):
    packer = CohortPacker(runner, pack, 7)
    records = [run_image(img, mask, cfg, runner, packer=packer)
               for img, mask in images]
    packer.finalize()
    return records, packer


def test_packed_matches_individual(runner, cohort):
    cfg = AnnotatorConfig(device="cpu", normalize=True, blur=0.3,
                          upper_limit=99.8)
    solo = [run_image(img, mask, cfg, runner) for img, mask in cohort]
    # a pack smaller than every image forces flushes and straddled splits
    packed, packer = _run_cohort(cohort, cfg, runner, 16)
    assert packer.dispatched_rows > 0
    for a, b in zip(solo, packed):
        np.testing.assert_array_equal(a.cell_ids, b.cell_ids)
        np.testing.assert_allclose(a.panel_probs["immune_base"],
                                   b.panel_probs["immune_base"], atol=1e-6)
        np.testing.assert_array_equal(
            a.panel_probs["immune_base"].argmax(1),
            b.panel_probs["immune_base"].argmax(1))
        np.testing.assert_array_equal(a.intensity_full, b.intensity_full)


def test_packing_reduces_padding(runner, cohort):
    cfg = AnnotatorConfig(device="cpu", normalize=False)
    solo_rows = 0
    for img, mask in cohort:
        _, p = _run_cohort([(img, mask)], cfg, runner, 64)
        solo_rows += p.dispatched_rows
    _, shared = _run_cohort(cohort, cfg, runner, 64)
    assert solo_rows == 3 * 64
    assert shared.dispatched_rows == 128
    assert shared.valid_rows == 23 + 17 + 29


def test_empty_image_in_cohort(runner, cohort):
    cfg = AnnotatorConfig(device="cpu", normalize=False)
    empty = (np.zeros((7, 64, 64), np.uint16), np.zeros((64, 64), np.int32))
    packed, _ = _run_cohort([cohort[0], empty, cohort[1]], cfg, runner, 64)
    assert packed[1].n_cells == 0
    assert packed[1].panel_probs["immune_base"].shape == (0, 5)
    assert packed[0].n_cells == 23 and packed[2].n_cells == 17
