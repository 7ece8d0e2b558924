"""Command-line front end — flag parity with the reference ``main.py``.

The port of ribca_tpu's ``cli.py``. Same flags, names and defaults
(main.py:56-112), except that ``--device`` defaults to ``cuda``; same
single-image / batch-CSV mode split (main.py:9-52). Steps the port does not
have yet (tissue regions, neighborhoods, heatmap, composition pies,
``--warm-cache``) are written to ``results/log.txt`` as "not ported yet";
``--serve`` exits with that message.

    python -m ribca_tpu_torch --marker-list-path M.txt --image-path I.tif \\
        --mask-path K.png --batch-id run1 --main-dir out/
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ribca_tpu_torch.api.annotator import Annotator
from ribca_tpu_torch.io.manifest import write_manifest
from ribca_tpu_torch.utils.config import AnnotatorConfig
from ribca_tpu_torch.utils.device import resolve_device


def _not_ported(annotator: Annotator, step: str) -> None:
    annotator.logger.log(f"{step}: not ported yet (ribca_tpu_torch)")


def _run_pipeline(annotator: Annotator, bs: int, n_regions: int,
                  warm_cache: bool = False):
    if warm_cache:
        _not_ported(annotator, "--warm-cache")
    annotator.preprocess()
    annotator.predict(bs)
    if n_regions > 0:
        _not_ported(annotator, f"Tissue region analysis (n_regions="
                               f"{n_regions})")
    annotator.export_annotations()
    _not_ported(annotator, "Marker heatmap")
    _not_ported(annotator, "Neighborhood analysis")
    annotator.colorize(from_script=True)
    _not_ported(annotator, "Cell-type composition pies")
    annotator.clear_tmp()


def run(config: AnnotatorConfig, bs: int, n_regions: int,
        warm_cache: bool = False):
    """Single-image mode: writes a 1-row images.csv then delegates
    (main.py:9-36); returns ({cell_id: intensity_vector}, legend text)."""
    os.makedirs(config.main_dir, exist_ok=True)
    csv_path = os.path.join(config.main_dir, "images.csv")
    write_manifest([(config.image_path, config.mask_path)], csv_path)
    config = AnnotatorConfig(**{
        **config.to_dict(), "csv_file": csv_path,
        "image_path": None, "mask_path": None,
    })
    annotator = Annotator(config)
    if not annotator.channel_parser.any_panel:
        raise ValueError("No panels are applied. Please check the marker list.")
    _run_pipeline(annotator, bs, n_regions, warm_cache)

    intensity = annotator.intensity_full[0]
    intensity_dict = {0: np.zeros(intensity.shape[1], intensity.dtype)}
    for j, cid in enumerate(annotator.records[0].cell_ids):
        intensity_dict[int(cid)] = intensity[j]
    names = annotator.get_cell_type_names()
    os.remove(csv_path)
    return intensity_dict, names


def batch_run(config: AnnotatorConfig, bs: int, n_regions: int,
              warm_cache: bool = False):
    """Batch-CSV mode (main.py:39-52); returns the Annotator."""
    annotator = Annotator(config)
    if not annotator.channel_parser.any_panel:
        raise ValueError("No panels are applied. Please check the marker list.")
    _run_pipeline(annotator, bs, n_regions, warm_cache)
    return annotator


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Process images with markers"
    )
    parser.add_argument("--marker-list-path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on (cuda/cuda:<i>/cpu)")
    parser.add_argument("--main-dir", type=str, default="./")
    parser.add_argument("--batch-id", type=str, default=None)
    parser.add_argument("--strict", action="store_true")
    parser.add_argument("--infer", action="store_true", default=True)
    parser.add_argument("--min-cells", type=int, default=-1)
    parser.add_argument("--n-regions", type=int, default=3)
    parser.add_argument("--normalize", action="store_true", default=True)
    parser.add_argument("--blur", type=float, default=0.3)
    parser.add_argument("--amax", type=float, default=99.8)
    parser.add_argument("--confidence", type=float, default=0.3)
    parser.add_argument("--cell-type-confidence", type=str, default=None,
                        help="JSON file with per-type thresholds")
    parser.add_argument("--bs", type=int, default=128)
    parser.add_argument("--cell-size", type=int, default=30)
    parser.add_argument("--n_jobs", type=int, default=0)
    # without region analysis (not ported yet) both stage orders export
    # the same CSV, so the flag is accepted and has no effect
    parser.add_argument("--reference-ordering", action="store_true",
                        help="Reproduce the reference CLI stage order "
                             "(export before region analysis)")
    parser.add_argument("--warm-cache", action="store_true",
                        help="ribca_tpu's XLA compile-cache warm-up; not "
                             "ported yet (logged)")
    parser.add_argument("--warm-shapes", type=str, default=None,
                        help="Image sizes for --warm-cache (not ported)")
    parser.add_argument("--allow-random-weights", action="store_true",
                        help="Run with RANDOM weights when checkpoints are "
                             "missing (annotations meaningless; for shape/"
                             "flow validation only). Production CLI runs "
                             "fail fast without this flag — the reference "
                             "silently skips absent panels, model.py:195")
    parser.add_argument("--models-dir", type=str, default=None,
                        help="Checkpoint directory for the model registry "
                             "(default: the package's bundled weights dir)")
    parser.add_argument("--serve", type=str, default=None, metavar="DIR",
                        help="ribca_tpu's persistent annotation server; "
                             "not ported yet")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--image-path", type=str)
    group.add_argument("--batch-csv", type=str)
    parser.add_argument("--mask-path", type=str)

    args = parser.parse_args(argv)
    if args.serve:
        parser.exit(2, "--serve: the annotation server is not ported yet "
                       "(ribca_tpu_torch)\n")
    if not (args.image_path or args.batch_csv):
        parser.error("one of --image-path or --batch-csv is required")
    if args.image_path and not args.mask_path:
        parser.error("--mask-path is required when using --image-path")
    if args.marker_list_path is None:
        parser.error("--marker-list-path is required")
    if args.batch_id is None:
        parser.error("--batch-id is required")
    return args


def config_from_args(args: argparse.Namespace) -> AnnotatorConfig:
    cell_type_confidence = None
    if args.cell_type_confidence:
        with open(args.cell_type_confidence) as f:
            cell_type_confidence = json.load(f)
    return AnnotatorConfig(
        marker_file=args.marker_list_path,
        image_path=args.image_path,
        mask_path=args.mask_path,
        csv_file=args.batch_csv,
        device=args.device,
        main_dir=args.main_dir,
        batch_id=args.batch_id,
        strict=args.strict,
        infer=args.infer,
        min_cells=args.min_cells,
        n_regions=args.n_regions,
        normalize=args.normalize,
        blur=args.blur,
        upper_limit=args.amax,
        confidence=args.confidence,
        cell_size=args.cell_size,
        n_jobs=args.n_jobs,
        cell_type_confidence=cell_type_confidence,
        # the CLI is the production surface: missing checkpoints fail
        # fast unless the user explicitly opted into random weights
        allow_random_weights=args.allow_random_weights,
        models_dir=args.models_dir,
    )


def main(argv=None):
    args = parse_args(argv)
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"error: {e}")
    config = config_from_args(args)
    if args.batch_csv:
        return batch_run(config, args.bs, args.n_regions, args.warm_cache)
    return run(config, args.bs, args.n_regions, args.warm_cache)


if __name__ == "__main__":
    main()
