"""The port's imputing ensemble step against ribca_tpu's, on the CPU.

Both ``EnsembleRunner``s load the same seeded ``.pth`` files (a reference-
layout MAE imputer and classifier, tests/torch_mirror.py) and run the same
patches in f32: panel channel gather with the blank missing channel,
mosaic, deterministic keep-masking, MAE reconstruction, composite, untile,
classifier. Probabilities within 1e-5 and equal argmax; under device
voting, equal vote stats.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ribca_tpu.engine.ensemble import EnsembleRunner as JaxRunner
from ribca_tpu.models.registry import ModelRegistry as JaxRegistry
from ribca_tpu.parallel.mesh import get_mesh
from ribca_tpu_torch.engine.ensemble import VOTE_STATS_KEY, EnsembleRunner
from ribca_tpu_torch.models.registry import ModelRegistry
from ribca_tpu_torch.panels.parser import MarkerParser
from ribca_tpu_torch.panels.vocab import (
    IMPUTER_MOSAIC,
    PANEL_MODEL_SPECS,
    PANELS,
)
from ribca_tpu_torch.models.vit import ARCH_WIDTHS
from tests.torch_mirror import TorchMAE, TorchViT

CASES = {
    "immune_base": ["CD11c"],
    "immune_full": ["CD11c", "CD68", "FoxP3"],
}


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """Per panel, written once: the parse of a marker list that misses
    ``CASES[panel]``, and a models dir with the seeded ``.pth`` files. The
    full-size weights (and the ``.npz`` copies ribca_tpu's registry caches
    beside them) take about a gigabyte per panel, so they are removed when
    the module is done."""
    made = {}

    def setup(panel):
        if panel not in made:
            made[panel] = _write(tmp_path_factory.mktemp(panel), panel,
                                 CASES[panel])
        return made[panel]

    yield setup
    for _, models, _ in made.values():
        shutil.rmtree(models)


def _write(wd, panel, missing):
    markers = [m for m in PANELS[panel] if m not in missing]
    mf = wd / "markers.txt"
    mf.write_text("\n".join(markers) + "\n")
    parser = MarkerParser(strict=False)
    parser.parse(str(mf))
    assert parser.indices[panel].count(-1) == len(missing)

    h, w = IMPUTER_MOSAIC[panel]
    arch, in_chans, classes = PANEL_MODEL_SPECS[panel]
    torch.manual_seed(5)
    mae = TorchMAE(img_size=(h * 40, w * 40)).eval()
    vit = TorchViT(in_chans=in_chans, num_classes=classes,
                   dim=ARCH_WIDTHS[arch]).eval()
    # a wide head so that the classes differ by more than rounding
    torch.nn.init.normal_(vit.head.weight, std=0.5)
    models = wd / "models"
    models.mkdir()
    torch.save({"model": mae.state_dict()},
               str(models / f"{panel}_impute.pth"))
    torch.save({"model": vit.state_dict()}, str(models / f"{panel}.pth"))
    return parser, str(models), len(markers)


def _runners(setups, panel, device_voting):
    parser, models, n_markers = setups(panel)
    # the port reads the .pth files (or, after ribca_tpu's first run in
    # this module, the .npz copies it caches, through the bridge)
    port = EnsembleRunner(parser, ModelRegistry(models, allow_random=False),
                          n_channels=n_markers, infer=True,
                          dtype=torch.float32, device="cpu",
                          device_voting=device_voting)
    ref = JaxRunner(parser, JaxRegistry(models, allow_random=False),
                    n_channels=n_markers, infer=True, dtype=jnp.float32,
                    mesh=get_mesh(), device_voting=device_voting)
    assert [s.imputer is not None for s in port.specs] == [True]
    assert ref.specs[0].imputer is not None
    n = get_mesh().size
    patches = np.random.default_rng(2).normal(
        size=(n, n_markers, 40, 40)).astype(np.float32)
    with torch.inference_mode():
        got = port.run_chunk(torch.from_numpy(patches))
    want = ref.run_chunk(jnp.asarray(patches))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, port)


@pytest.mark.parametrize("panel", sorted(CASES))
def test_imputing_runner_matches_ribca_tpu(setups, panel):
    got, want, port = _runners(setups, panel, device_voting=False)
    assert got.keys() == want.keys() == {panel}
    np.testing.assert_allclose(got[panel], want[panel], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[panel].argmax(1), want[panel].argmax(1))
    # the labels split, so the argmax check bites
    assert len(set(want[panel].argmax(1))) >= 2
    assert port.dispatches == 1


def test_imputing_runner_device_votes_match(setups):
    got, want, _ = _runners(setups, "immune_base", device_voting=True)
    assert got.keys() == want.keys() == {VOTE_STATS_KEY}
    g, w = got[VOTE_STATS_KEY], want[VOTE_STATS_KEY]
    np.testing.assert_array_equal(g[:, 0], w[:, 0])
    np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_imputer_weights_change_the_result(setups):
    """With infer=False the same parse runs the classifier on the blank
    channel: the imputer must make a difference, or the tests above would
    pass without it."""
    parser, models, n_markers = setups("immune_base")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(8, n_markers, 40, 40)).astype(np.float32))
    out = {}
    for infer in (True, False):
        runner = EnsembleRunner(parser, ModelRegistry(models),
                                n_channels=n_markers, infer=infer,
                                dtype=torch.float32, device="cpu")
        out[infer] = runner.run_chunk(x)["immune_base"].numpy()
    assert np.abs(out[True] - out[False]).max() > 1e-3


def test_missing_imputer_weights_skip_imputation(setups, tmp_path):
    parser, models, n_markers = setups("immune_base")
    # a models dir with the classifier only
    (tmp_path / "immune_base.pth").symlink_to(
        os.path.join(models, "immune_base.pth"))
    runner = EnsembleRunner(parser,
                            ModelRegistry(str(tmp_path), allow_random=False),
                            n_channels=n_markers, infer=True,
                            dtype=torch.float32, device="cpu")
    assert runner.specs[0].imputer is None
