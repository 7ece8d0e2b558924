"""Annotator facade — the reference's public surface on the GPU pipeline.

The port of ribca_tpu's ``api/annotator.py`` for the single-image
annotation path. Method-level parity with the reference Annotator
(model.py:90-919) for ``preprocess() predict(bs) merge_by_voting()
export_annotations() colorize() get_cell_type_names() clear()
clear_tmp()`` plus the attributes downstream code reads
(``channel_parser``, ``cell_types``, ``colors``, ``annotations``,
``confidence``, ``intensity_full``).

``preprocess()`` only resolves the manifest; ``predict()`` streams each
image through normalization, patch extraction and the ensemble (with MAE
imputation of missing immune markers when ``infer`` is on) on the device
(engine/pipeline.py) without tmp ``.pt`` files, sharing partly filled
ensemble dispatches across the images of the run (engine/packer.py); the
``tmp/`` dir is still created and cleaned for workflow parity.

Not ported yet: tissue regions, neighborhoods, heatmaps, composition pies,
UMAP and extra-cell-type discovery (``min_cells > 0`` raises).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ribca_tpu_torch.engine.ensemble import VOTE_STATS_KEY, EnsembleRunner
from ribca_tpu_torch.engine.pipeline import (
    make_packer,
    run_image,
    trace_stage,
)
from ribca_tpu_torch.engine.voting import (
    PanelProbs,
    finish_votes,
    merge_by_voting,
)
from ribca_tpu_torch.io import read_image, read_manifest, read_mask
from ribca_tpu_torch.models.registry import ModelRegistry
from ribca_tpu_torch.outputs import (
    color_legend,
    colorize_image,
    export_annotations_csv,
    get_colors,
    rgb_to_hex,
    save_png,
)
from ribca_tpu_torch.panels.parser import MarkerParser
from ribca_tpu_torch.utils.config import AnnotatorConfig
from ribca_tpu_torch.utils.device import dtype_from_name, resolve_device
from ribca_tpu_torch.utils.logging import Logger


class Annotator:
    def __init__(
        self,
        config: AnnotatorConfig | None = None,
        models_dir: str | None = None,
        **overrides,
    ):
        if config is None:
            config = AnnotatorConfig(**overrides)
        elif overrides:
            config = AnnotatorConfig(**{**config.to_dict(), **overrides})
        self.config = config
        self.device = resolve_device(config.device)
        if config.min_cells > 0:
            raise NotImplementedError(
                "min_cells > 0 asks for extra-cell-type discovery, which "
                "ribca_tpu_torch does not port yet"
            )

        self.main_dir = config.main_dir
        self.batch_id = config.batch_id
        self.result_dir = os.path.join(self.main_dir, "results")
        self.temp_dir = os.path.join(self.main_dir, "tmp")
        os.makedirs(self.result_dir, exist_ok=True)
        os.makedirs(self.temp_dir, exist_ok=True)

        self.logger = Logger(self.main_dir)
        self.logger.log_all_hyperparameters(
            config.loggable_hyperparameters()
        )
        self.logger.log(f"Device: {self.device}, compute dtype: "
                        f"{config.dtype}")
        if self.device.type == "cuda":
            self.logger.log("TF32 off for matmuls and cuDNN convolutions")
        if config.ignored_keys:
            self.logger.log(
                "Ignored settings that only ribca_tpu's TPU runtime reads: "
                + ", ".join(config.ignored_keys)
            )
        self.logger.log("")
        self.logger.log("Start parsing the marker list.")

        self.channel_parser = MarkerParser(
            strict=config.strict, logger=self.logger
        )
        self.channel_parser.parse(config.marker_file)

        self.registry = ModelRegistry(
            models_dir or config.models_dir, logger=self.logger,
            allow_random=config.allow_random_weights,
        )

        self.confidence_thresh = config.confidence
        self.cell_type_confidence = dict(config.cell_type_confidence)

        # per-image state (filled by preprocess/predict)
        self._image_paths: list[str] = []
        self._mask_paths: list[str] = []
        self.records = []                  # engine.pipeline.ImageRecord
        self.annotations: list[list[str]] = []
        self.confidence: list[np.ndarray] = []
        self.annotations_all: list[list[dict]] = []
        self.cell_types = np.array([], dtype=object)
        self.colors: list = []
        self._runner = None
        # the last predict()'s cohort packer, which holds its row counts
        self.packer = None

    # -- pipeline -----------------------------------------------------------

    @property
    def intensity_full(self) -> list[np.ndarray]:
        return [r.intensity_full for r in self.records]

    def preprocess(self) -> None:
        """Resolve the image/mask manifest. Device work happens in
        predict(): each image streams through preprocessing + ensemble in
        one pass without touching disk."""
        cfg = self.config
        if cfg.csv_file:
            pairs = read_manifest(cfg.csv_file)
            self._image_paths = [p for p, _ in pairs]
            self._mask_paths = [m for _, m in pairs]
        elif cfg.image_path and cfg.mask_path:
            self._image_paths = [cfg.image_path]
            self._mask_paths = [cfg.mask_path]
        else:
            raise ValueError(
                "Provide csv_file or image_path+mask_path in the config"
            )
        self.logger.log("\n")
        self.logger.log("Starting image processing...")

    def _ensure_runner(self) -> EnsembleRunner:
        if self._runner is None:
            if not self.channel_parser.any_panel:
                raise ValueError(
                    "No panels are applied. Please check the marker list."
                )
            self._runner = EnsembleRunner(
                self.channel_parser,
                self.registry,
                n_channels=self.channel_parser.n_markers,
                infer=self.config.infer,
                dtype=dtype_from_name(self.config.dtype),
                device=self.device,
                logger=self.logger,
                device_voting=self.config.device_voting,
            )
            if self.registry.used_random:
                self.logger.log(
                    "RANDOM_WEIGHTS: one or more models are randomly "
                    "initialized — annotations in this run are "
                    "meaningless."
                )
                self.logger.set_flag("random_weights", True)
        return self._runner

    def predict(self, batch_size: int | None = None) -> None:
        """Stream every image through the device pipeline, then merge
        votes exactly as model.py:481-639."""
        self.logger.log("\nStart predicting cell types and tissue structures.")
        runner = self._ensure_runner()
        cfg = self.config
        if batch_size:
            # reference bs semantics: a GPU micro-batch (default 128,
            # main.py:88). As in ribca_tpu, a dispatch takes max(bs, 4096)
            # cells, capped at chunk_cells, rather than bs: the CLI's
            # default gives 4096-cell dispatches instead of many tiny ones.
            cfg = AnnotatorConfig(**{
                **cfg.to_dict(),
                "chunk_cells": min(
                    cfg.chunk_cells, max(int(batch_size), 4096)
                ),
            })

        if not self._image_paths:
            self.preprocess()

        self._predict_images(cfg, runner)
        self.logger.log(
            "Finished predicting cell types and tissue structures."
        )

        with self.logger.stage("voting.merge"):
            self.merge_by_voting()

        # unique types, Others forced last (model.py:455-458)
        uniq = set()
        for labels in self.annotations:
            uniq.update(labels)
        cts = np.sort(np.array(list(uniq)))
        cts = np.delete(cts, np.where(cts == "Others"))
        self.cell_types = np.append(cts, "Others")
        self.colors = get_colors(len(self.cell_types))
        color_legend(
            self.result_dir,
            {
                str(self.cell_types[i]): rgb_to_hex(self.colors[i])
                for i in range(len(self.cell_types))
            },
        )
        self._build_annotations_all()

    def _predict_images(self, cfg, runner) -> None:
        """Decode image i+1 on a host thread while image i runs on the
        device. One cohort packer serves the whole run: the tail cells of
        image i and the head cells of image i+1 share ensemble dispatches,
        so bucket padding is paid once per run, not once per image."""

        def decode(paths):
            img_path, mask_path = paths
            return read_image(img_path), read_mask(mask_path)

        pairs = list(zip(self._image_paths, self._mask_paths))
        self.records = []
        packer = self.packer = make_packer(cfg, runner,
                                           self.channel_parser.n_markers)
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(decode, pairs[0]) if pairs else None
            for i, (img_path, _) in enumerate(pairs):
                with self.logger.stage("io.read"):
                    image, mask = pending.result()
                pending = (
                    pool.submit(decode, pairs[i + 1])
                    if i + 1 < len(pairs) else None
                )
                with self.logger.stage("device.pipeline"):
                    record = run_image(image, mask, cfg, runner,
                                       packer=packer, tracer=self.logger)
                self.records.append(record)
                self.logger.log(
                    f"Processed {os.path.basename(img_path)}: "
                    f"{record.n_cells} cells"
                )
            with trace_stage(self.logger, "device.finalize", self.device,
                             quiet=False):
                packer.finalize()
        self.logger.log(
            "Ensemble dispatch padding: "
            f"{packer.pad_fraction:.1%} of rows"
        )

    def merge_by_voting(self) -> None:
        self.annotations, self.confidence = [], []
        for rec in self.records:
            if VOTE_STATS_KEY in rec.panel_probs:
                # device voting: the ensemble step already merged the
                # heads; apply the (current) thresholds on the host —
                # exact for any confidence settings, including ones
                # changed after predict() (engine/voting.finish_votes)
                labels, conf = finish_votes(
                    rec.panel_probs[VOTE_STATS_KEY],
                    self._runner.vote_plan,
                    self.confidence_thresh, self.cell_type_confidence,
                )
                self.annotations.append(labels)
                self.confidence.append(conf)
                continue
            immune = structure = nerve = None
            for panel, probs in rec.panel_probs.items():
                pp = PanelProbs(panel, probs)
                if panel.startswith("immune"):
                    immune = pp
                elif panel == "structure":
                    structure = pp
                elif panel == "nerve_cell":
                    nerve = pp
            labels, conf = merge_by_voting(
                immune, structure, nerve,
                self.confidence_thresh, self.cell_type_confidence,
            )
            self.annotations.append(labels)
            self.confidence.append(conf)

    def _type_index(self) -> dict:
        return {str(t): i for i, t in enumerate(self.cell_types)}

    def _build_annotations_all(self) -> None:
        tindex = self._type_index()
        self.annotations_all = []
        for i, rec in enumerate(self.records):
            rows = []
            for j, cid in enumerate(rec.cell_ids):
                rows.append({
                    "Cell ID": int(cid),
                    "Cell type": tindex[self.annotations[i][j]],
                    "Confidence": float(self.confidence[i][j]),
                    "Row": float(rec.mean_row[j]),
                    "Column": float(rec.mean_col[j]),
                })
            self.annotations_all.append(rows)

    # -- outputs ------------------------------------------------------------

    def export_annotations(self) -> None:
        if not self.annotations:
            raise ValueError("No annotations to export")
        with self.logger.stage("outputs.export"):
            for i, rec in enumerate(self.records):
                path = os.path.join(
                    self.result_dir, f"{self.batch_id}_annotation_{i}.csv"
                )
                # no tissue regions yet: the column reads None, as in a
                # reference CLI run (SURVEY §3.1)
                export_annotations_csv(
                    path, rec.cell_ids, self.annotations[i],
                    self.confidence[i], rec.mean_row, rec.mean_col,
                )
                self.logger.log(
                    f"Exported annotations for image {i} to {path}")

    def colorize(self, from_script: bool = True,
                 working_dir: str | None = None) -> None:
        """Write colorized cell-type / confidence maps (model.py:806-858).
        ``from_script=False`` additionally writes the GUI label map into
        ``working_dir`` (default <main_dir>/_working_dir_temp)."""
        if not self.records:
            raise ValueError("No masks to colorize")
        if not self.annotations:
            raise ValueError("No annotations to colorize")
        tindex = self._type_index()
        if working_dir is None:
            working_dir = os.path.join(self.main_dir, "_working_dir_temp")
        with self.logger.stage("outputs.colorize"):
            for i, rec in enumerate(self.records):
                type_ids = np.asarray(
                    [tindex[lab] for lab in self.annotations[i]],
                    dtype=np.int64,
                )
                maps = colorize_image(
                    rec.mask, rec.cell_ids, type_ids, self.confidence[i],
                    self.colors, want_labels=not from_script,
                )
                rd, bid = self.result_dir, self.batch_id
                save_png(
                    os.path.join(rd, f"{bid}_colorized_annotation_{i}.png"),
                    maps["cell_type_rgb"])
                save_png(os.path.join(rd, f"{bid}_confidence_{i}.png"),
                         maps["confidence_rgb"])
                if not from_script:
                    os.makedirs(working_dir, exist_ok=True)
                    save_png(os.path.join(working_dir, "output_img.png"),
                             maps["cell_type_labels"])

    def get_cell_type_names(self) -> str:
        """3-per-line numbered legend text (model.py:689-697)."""
        txt = ""
        for i in range(len(self.cell_types)):
            txt += f"{i + 1}: {self.cell_types[i]}"
            txt += "\n" if i % 3 == 2 else "  "
        return txt

    def clear(self) -> None:
        self.records = []
        self.annotations = []
        self.confidence = []
        self.annotations_all = []

    def clear_tmp(self) -> None:
        if os.path.isdir(self.temp_dir):
            for f in os.listdir(self.temp_dir):
                os.remove(os.path.join(self.temp_dir, f))
            os.rmdir(self.temp_dir)
        self.logger.log("Temporary files cleared")
        # per-stage wall-time trace (SURVEY §5: the reference has none)
        self.logger.write_trace_summary()
