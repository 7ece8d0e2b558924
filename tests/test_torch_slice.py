"""The port's single-image annotation path end to end, on the CPU.

ribca_tpu_torch's Annotator and ribca_tpu's run the same fixture with the
same ``.npz`` weights in f32, with device voting on and off, and must give
identical labels and close confidences, intensities and CSVs: one image
with every marker, and a two-image batch with a missing marker, which
takes the MAE imputer and shares ensemble dispatches across the images. The port's
CLI runs in a subprocess (tests/conftest.py imports JAX) to show that the
port imports neither JAX nor ribca_tpu.
"""

import csv
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ribca_tpu.api.annotator import Annotator as JaxAnnotator
from ribca_tpu.io.manifest import write_manifest
from ribca_tpu.models.store import save_params
from ribca_tpu.models.vit import build_panel_model, init_params
from ribca_tpu.panels.vocab import PANELS
from ribca_tpu.utils.config import AnnotatorConfig as JaxConfig
from ribca_tpu_torch.api.annotator import Annotator
from ribca_tpu_torch.utils.config import AnnotatorConfig
from tests.synth import write_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    wd = tmp_path_factory.mktemp("slice")
    img_path, mask_path, _, _ = write_fixture(
        wd, n_channels=7, n_cells=9, h=90, w=100)
    markers = wd / "markers.txt"
    markers.write_text("\n".join(PANELS["immune_base"]) + "\n")
    csv_path = str(wd / "images.csv")
    write_manifest([(img_path, mask_path)], csv_path)
    models = wd / "models"
    models.mkdir()
    # Flax-initialized weights (not the N(0, 0.02) fallback); this seed
    # gives four different labels on the fixture, some cells near the 0.3
    # confidence threshold
    tree = jax.tree_util.tree_map(
        np.asarray, init_params(build_panel_model("immune_base"), seed=8))
    save_params(tree, str(models / "immune_base.npz"))
    return {"wd": wd, "markers": str(markers), "csv": csv_path,
            "models": str(models), "img": img_path, "mask": mask_path}


def _common(ws, name, device_voting):
    return dict(marker_file=ws["markers"], csv_file=ws["csv"],
                main_dir=str(ws["wd"] / name), batch_id="s", infer=False,
                dtype="float32", device_voting=device_voting,
                allow_random_weights=False, device="cpu")


@pytest.fixture(scope="module", params=[True, False],
                ids=["device_voting", "host_voting"])
def pair(request, workspace):
    dv = request.param
    tag = "dv" if dv else "hv"
    ref = JaxAnnotator(JaxConfig(**_common(workspace, f"jax_{tag}", dv)),
                       models_dir=workspace["models"])
    port = Annotator(AnnotatorConfig(**_common(workspace, f"port_{tag}", dv)),
                     models_dir=workspace["models"])
    for a in (ref, port):
        a.preprocess()
        a.predict()
        a.export_annotations()
    return ref, port


def test_labels_identical(pair):
    ref, port = pair
    assert len(port.annotations[0]) == 9
    assert len(set(ref.annotations[0])) >= 3
    assert port.annotations == ref.annotations
    assert list(port.cell_types) == list(ref.cell_types)


def test_confidences_and_intensities_close(pair):
    ref, port = pair
    # twelve f32 blocks with the LayerNorm variance computed two ways
    np.testing.assert_allclose(port.confidence[0], ref.confidence[0],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.intensity_full[0], ref.intensity_full[0],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(port.records[0].cell_ids,
                                  ref.records[0].cell_ids)


def _rows(annotator):
    path = os.path.join(annotator.result_dir, "s_annotation_0.csv")
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_csv_matches(pair):
    ref, port = pair
    got, want = _rows(port), _rows(ref)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        for col in ("Cell Index", "Cell Type", "Row", "Column",
                    "Tissue Region"):
            assert g[col] == w[col], col
        # 3-digit rounding of values within 1e-4 of each other
        assert abs(float(g["Confidence"]) - float(w["Confidence"])) <= 1e-3


def test_colorized_maps_pixel_equal(pair, tmp_path):
    from PIL import Image

    ref, port = pair
    names = ("s_colorized_annotation_0.png", "s_confidence_0.png")
    for a, tag in ((ref, "ref"), (port, "port")):
        a.colorize(from_script=False, working_dir=str(tmp_path / tag))
    for name in names:
        got = np.asarray(Image.open(os.path.join(port.result_dir, name)))
        want = np.asarray(Image.open(os.path.join(ref.result_dir, name)))
        np.testing.assert_array_equal(got, want, err_msg=name)
    got, want = (np.asarray(Image.open(tmp_path / t / "output_img.png"))
                 for t in ("port", "ref"))
    np.testing.assert_array_equal(got, want)


def test_revote_with_changed_thresholds(pair):
    ref, port = pair
    for a in (ref, port):
        a.confidence_thresh = 0.6
        a.merge_by_voting()
    try:
        assert port.annotations == ref.annotations
        np.testing.assert_allclose(port.confidence[0], ref.confidence[0],
                                   atol=1e-4, rtol=0)
    finally:
        for a in (ref, port):
            a.confidence_thresh = 0.3
            a.merge_by_voting()


def test_cli_imports_neither_jax_nor_ribca_tpu(workspace, tmp_path):
    script = (
        "import sys\n"
        "from ribca_tpu_torch.cli import main\n"
        "main(sys.argv[1:])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'ribca_tpu'))\n"
        "print('FOREIGN', bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", script,
         "--marker-list-path", workspace["markers"],
         "--image-path", workspace["img"], "--mask-path", workspace["mask"],
         "--batch-id", "cli", "--device", "cpu", "--main-dir", str(tmp_path),
         "--models-dir", workspace["models"]],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout, out.stdout
    results = tmp_path / "results"
    with open(results / "cli_annotation_0.csv") as f:
        assert len(f.readlines()) == 1 + 9
    for name in ("cli_colorized_annotation_0.png", "cli_confidence_0.png",
                 "cell_color_legend.png", "log.txt", "trace.json"):
        assert (results / name).exists(), name
    assert "not ported yet" in (results / "log.txt").read_text()


def test_cli_without_cuda_exits_naming_cuda(workspace, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    out = subprocess.run(
        [sys.executable, "-m", "ribca_tpu_torch",
         "--marker-list-path", workspace["markers"],
         "--image-path", workspace["img"], "--mask-path", workspace["mask"],
         "--batch-id", "nocuda", "--main-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert not (tmp_path / "results").exists()


def _port_config(ws, tmp_path, **kw):
    base = _common(ws, "unused", True)
    base.update(main_dir=str(tmp_path), allow_random_weights=True)
    base.update(kw)
    return AnnotatorConfig(**base)


def test_image_over_device_budget_raises(workspace, tmp_path):
    ann = Annotator(_port_config(workspace, tmp_path,
                                 device_image_budget_bytes=1000))
    with pytest.raises(NotImplementedError, match="banded"):
        ann.predict()


def test_tpu_only_settings_are_ignored_and_logged(workspace, tmp_path):
    raw = {"marker_file": workspace["markers"], "csv_file": workspace["csv"],
           "main_dir": str(tmp_path), "device": "cpu", "infer": False,
           "compile_cache_dir": "~/.cache/x", "prefetch_depth": 4,
           "amax": 99.0}
    cfg = AnnotatorConfig.from_dict(raw)
    assert cfg.upper_limit == 99.0
    assert set(cfg.ignored_keys) == {"compile_cache_dir", "prefetch_depth"}
    Annotator(cfg)
    log = (tmp_path / "results" / "log.txt").read_text()
    assert "compile_cache_dir, prefetch_depth" in log


# -- the batch path with a missing marker: MAE imputation + cohort packer ----


@pytest.fixture(scope="module")
def impute_workspace(workspace, tmp_path_factory):
    """Two images in one batch CSV, immune_base markers without CD11c, and
    full-size seeded weights: the slice's Flax-initialised classifier and a
    Flax-initialised MAE imputer, as ``.npz`` that both packages read."""
    from ribca_tpu.models.mae import build_imputer_model

    wd = tmp_path_factory.mktemp("impute")
    pairs = []
    for seed, n_cells in ((1, 45), (2, 40)):
        img, mask, _, _ = write_fixture(wd, n_channels=6, n_cells=n_cells,
                                        h=100, w=110, seed=seed)
        pairs.append((img, mask))
    csv_path = str(wd / "images.csv")
    write_manifest(pairs, csv_path)
    markers = wd / "markers.txt"
    markers.write_text("\n".join(
        m for m in PANELS["immune_base"] if m != "CD11c") + "\n")
    models = wd / "models"
    models.mkdir()
    shutil.copy(os.path.join(workspace["models"], "immune_base.npz"), models)
    mae = build_imputer_model("immune_base")
    ids = jax.numpy.arange(7, dtype=jax.numpy.int32)
    tree = mae.init(jax.random.PRNGKey(9),
                    jax.numpy.zeros((1, 1, 40, 280)), ids, ids)["params"]
    save_params(jax.tree_util.tree_map(np.asarray, tree),
                str(models / "immune_base_impute.npz"))
    yield {"wd": wd, "csv": csv_path, "markers": str(markers),
           "models": str(models)}
    shutil.rmtree(models)  # the full-size imputer: ~0.4 GB


def _impute_common(ws, name, device_voting):
    return dict(marker_file=ws["markers"], csv_file=ws["csv"],
                main_dir=str(ws["wd"] / name), batch_id="b", infer=True,
                dtype="float32", device_voting=device_voting,
                allow_random_weights=False, pack_cells=64, device="cpu")


@pytest.fixture(scope="module", params=[True, False],
                ids=["device_voting", "host_voting"])
def impute_pair(request, impute_workspace):
    dv = request.param
    ws = impute_workspace
    ref = JaxAnnotator(JaxConfig(**_impute_common(ws, f"jax_{dv}", dv)),
                       models_dir=ws["models"])
    port = Annotator(AnnotatorConfig(**_impute_common(ws, f"port_{dv}", dv)),
                     models_dir=ws["models"])
    for a in (ref, port):
        a.preprocess()
        a.predict()
        a.export_annotations()
    return ref, port


def test_imputing_batch_matches_ribca_tpu(impute_pair):
    ref, port = impute_pair
    spec = port._runner.specs[0]
    assert spec.imputer is not None and ref._runner.specs[0].imputer
    assert [len(a) for a in port.annotations] == [
        r.n_cells for r in ref.records]
    assert len(set(ref.annotations[0] + ref.annotations[1])) >= 2
    assert port.annotations == ref.annotations
    assert list(port.cell_types) == list(ref.cell_types)
    for i in range(2):
        np.testing.assert_array_equal(port.records[i].cell_ids,
                                      ref.records[i].cell_ids)
        np.testing.assert_allclose(port.confidence[i], ref.confidence[i],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(port.intensity_full[i],
                                   ref.intensity_full[i], atol=1e-5, rtol=0)


def test_imputing_batch_csvs_match(impute_pair):
    ref, port = impute_pair
    for i in range(2):
        name = f"b_annotation_{i}.csv"
        rows = []
        for a in (port, ref):
            with open(os.path.join(a.result_dir, name), newline="") as f:
                rows.append(list(csv.DictReader(f)))
        got, want = rows
        assert len(got) == len(want) == ref.records[i].n_cells
        for g, w in zip(got, want):
            for col in ("Cell Index", "Cell Type", "Row", "Column",
                        "Tissue Region"):
                assert g[col] == w[col], col
            assert abs(float(g["Confidence"])
                       - float(w["Confidence"])) <= 1e-3


def _padding_line(annotator):
    log = open(annotator.logger.log_file_path).read()
    (line,) = [x for x in log.splitlines()
               if x.startswith("Ensemble dispatch padding")]
    return line


def test_imputing_batch_shares_dispatches(impute_pair):
    ref, port = impute_pair
    assert _padding_line(port) == _padding_line(ref)
    # 45 + 40 cells in 64-cell dispatches: two shared dispatches, one of
    # them split across the images, instead of two per image
    n = sum(r.n_cells for r in port.records)
    assert port._runner.dispatches == 2 and n > 64
    assert _padding_line(port) == (
        f"Ensemble dispatch padding: {1 - n / 128:.1%} of rows")


def test_random_imputer_marks_the_run(impute_workspace, tmp_path):
    ws = impute_workspace
    models = tmp_path / "models"
    models.mkdir()
    shutil.copy(os.path.join(ws["models"], "immune_base.npz"), models)
    cfg = _impute_common(ws, "unused", True)
    cfg.update(main_dir=str(tmp_path), allow_random_weights=True)
    ann = Annotator(AnnotatorConfig(**cfg), models_dir=str(models))
    ann.preprocess()
    ann.predict()
    log = (tmp_path / "results" / "log.txt").read_text()
    assert "immune_base imputer weights not found" in log
    assert "RANDOM_WEIGHTS" in log
    assert ann._runner.specs[0].imputer is not None
