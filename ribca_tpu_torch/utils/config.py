"""Unified run configuration.

The reference exposes the same hyperparameters through three surfaces with
identical semantics (argparse in ``main.py:56-112``, magicgui fields in
``_widget.py:124-158,505-539``, and JSON files ``hyperparameters.json`` /
``hyperparams{,_batch}.json``). Here there is ONE dataclass; the CLI and
``from_json`` are thin adapters over it.

Names and defaults follow the reference CLI (``main.py:56-112``) and the
example ``hyperparameters.json``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from ribca_tpu_torch.panels.vocab import CELL_TYPES


# ribca_tpu settings with no meaning in the port (XLA compile cache, TPU
# mesh, cohort packer queue, banded-route tuning, jax.profiler)
TPU_ONLY_KEYS = frozenset({
    "prefetch_depth", "data_parallel", "profile_dir",
    "device_prenorm_cache_bytes", "stream_decode_bytes", "tiled_band_rows",
    "compile_cache_dir", "exact_select_stats", "host_image_budget_bytes",
    "multi_host_image_sharding",
})


def default_cell_type_confidence() -> dict[str, float]:
    """All-(-1) per-type threshold map (reference ``model.py:162-167``)."""
    return {name: -1 for name in CELL_TYPES}


@dataclasses.dataclass
class AnnotatorConfig:
    # inputs
    marker_file: str = ""
    image_path: Optional[str] = None   # single-image mode
    mask_path: Optional[str] = None
    csv_file: Optional[str] = None     # batch mode: csv with image_path,mask_path

    # run identity / placement
    device: str = "cuda"               # "cuda" | "cuda:<i>" | "cpu"
    main_dir: str = "./"
    batch_id: str = ""

    # pipeline knobs (reference names & defaults)
    batch_size: int = 128              # main.py:88-89
    strict: bool = False               # main.py:70-71 (store_true)
    infer: bool = True                 # main.py:72-73
    normalize: bool = True             # main.py:78-79
    blur: float = 0.3                  # main.py:80-81
    upper_limit: float = 99.8          # "amax"; main.py:82-83
    confidence: float = 0.3            # main.py:84-85
    cell_size: int = 30                # main.py:90-91
    min_cells: int = -1                # main.py:74-75
    n_regions: int = 3                 # main.py:76-77
    n_jobs: int = 0                    # main.py:92-93
    cell_type_confidence: Optional[dict] = None

    # extensions of the redesign (absent from the reference)
    dtype: str = "bfloat16"            # compute dtype of the model ensemble
    # merge the ensemble votes on the device: only the 3 per-cell vote
    # stats (argmax / winning vote / min-Others) come back to the host
    # instead of per-panel prob matrices; thresholds still apply on the
    # host, so re-voting with different confidences stays exact. False
    # returns full per-panel probs and merges on the host.
    device_voting: bool = True
    use_native_scanner: bool = True    # C++ mask scanner when built
    chunk_cells: int = 65536           # cells per device dispatch (cap)
    # cells per ensemble dispatch (engine/pipeline.pack_size)
    pack_cells: int = 8192
    # images whose f32 footprint exceeds this take the banded whole-slide
    # route, which the port does not have yet (it raises)
    device_image_budget_bytes: int = 2 << 30
    # round uploaded images up to a canonical shape ladder (ops/shapes.py);
    # masked statistics and clamped gathers keep results bitwise equal for
    # blur=0 and ~1e-5 allclose with a blur kernel
    canonical_shapes: bool = True
    # run with random-initialized weights when checkpoints are missing
    # (loudly logged + stderr warning); False makes missing weights fatal
    allow_random_weights: bool = True
    # checkpoint directory for the model registry; None = the package's
    # bundled weights dir (the reference hardcodes cwd-relative .pth
    # paths, model.py:189-239)
    models_dir: Optional[str] = None
    # keys of ribca_tpu's config that only its TPU/XLA runtime reads; a
    # hyperparameters JSON may carry them, and from_dict records them here
    # so the Annotator can log that they were ignored
    ignored_keys: tuple = ()

    def __post_init__(self):
        if self.cell_type_confidence is None:
            self.cell_type_confidence = default_cell_type_confidence()

    # -- adapters -----------------------------------------------------------

    @property
    def amax(self) -> float:
        return self.upper_limit

    @classmethod
    def from_json(cls, path: str, **overrides) -> "AnnotatorConfig":
        """Load a reference-style hyperparameters json (single or batch)."""
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict(raw, **overrides)

    @classmethod
    def from_dict(cls, raw: dict, **overrides) -> "AnnotatorConfig":
        known = {f.name for f in dataclasses.fields(cls)} - {"ignored_keys"}
        kwargs = {}
        ignored = []
        alias = {
            "image_file": "image_path",
            "mask_file": "mask_path",
            "amax": "upper_limit",
        }
        for key, value in raw.items():
            key = alias.get(key, key)
            if key in known and value is not None:
                kwargs[key] = value
            elif key in TPU_ONLY_KEYS:
                ignored.append(key)
        if ignored:
            kwargs["ignored_keys"] = tuple(ignored)
        kwargs.update(overrides)
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def loggable_hyperparameters(self) -> dict:
        """The subset the reference logs (``model.py:106-117``)."""
        return {
            "Batch name": self.batch_id,
            "Strictly match panel(s)": self.strict,
            "Normalize image(s)": self.normalize,
            "Image blurring kernel size": self.blur,
            "Percentile of intensity to upper clip": self.upper_limit,
            "Confidence threshold": self.confidence,
            "Estimated cell size (in pixels)": self.cell_size,
        }
