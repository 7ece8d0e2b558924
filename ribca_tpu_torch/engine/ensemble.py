"""Ensemble execution over cell chunks.

The port of ribca_tpu's ``engine/ensemble.py``. The reference streams
``.pt`` patch files from disk and runs each panel's classifier in a
separate torch loop (model.py:351-426), re-cropping patches per panel. Here
one ensemble step takes a chunk of full-channel patches already on the
device:

    full-channel patches (B, C, 40, 40)
      -> per-panel channel gather (ops/patches.py)
      -> optional MAE imputation of missing channels (models/mae.py)
      -> ViT forward + f32 softmax per active head
      -> optional device vote stats (engine/voting.py)

Parameters (classifiers and imputers) are cast once and stay on the device
across chunks and images.

Head selection replicates model.py:241-349: exactly one immune head (full >
extended > base) plus structure and nerve when matched. Imputation applies
only to immune panels with missing markers when ``infer`` is on
(preprocess.py:268-281); without imputer weights (and with random init
off) the classifier runs on the blank-filled channels, as in ribca_tpu.
"""

from __future__ import annotations

import dataclasses

import torch

from ribca_tpu_torch.engine.voting import (
    VOTE_STATS_WIDTH,
    build_vote_plan,
    device_vote_stats,
)
from ribca_tpu_torch.models.mae import (
    ImputationPlan,
    build_imputer_model,
    impute,
)
from ribca_tpu_torch.models.vit import build_panel_model, cast_for_compute
from ribca_tpu_torch.ops.patches import (
    PanelGather,
    apply_panel_gather,
    build_panel_gather,
)
from ribca_tpu_torch.panels.vocab import IMPUTER_MOSAIC
from ribca_tpu_torch.utils.device import resolve_device

# output key of the fused device vote stats (engine/voting.py)
VOTE_STATS_KEY = "vote_stats"


def prediction_panels(parser) -> list[str]:
    """Panels the ensemble actually runs (model.py:241-349 elif chains)."""
    panels = []
    if parser.immune_full:
        panels.append("immune_full")
    elif parser.immune_extended:
        panels.append("immune_extended")
    elif parser.immune_base:
        panels.append("immune_base")
    if parser.struct:
        panels.append("structure")
    if parser.nerve:
        panels.append("nerve_cell")
    return panels


@dataclasses.dataclass
class _HeadSpec:
    panel: str
    gather: PanelGather
    model: torch.nn.Module
    imputer: torch.nn.Module | None = None
    plan: ImputationPlan | None = None


def _on_device(model: torch.nn.Module, state: dict, dtype, device):
    """Load ``state``, cast for compute once and move to the device."""
    model.load_state_dict(state)
    model = cast_for_compute(model, dtype).to(device).eval()
    model.requires_grad_(False)
    return model


class EnsembleRunner:
    """Runs the ensemble step for one marker parse on one device.

    ``dispatches`` counts ensemble steps run, so a caller can check that
    every step went through the ViT's attention kernel."""

    def __init__(
        self,
        parser,
        registry,
        n_channels: int,
        infer: bool = True,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cuda",
        logger=None,
        device_voting: bool = False,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.logger = logger
        self.vote_plan = None
        self.specs: list[_HeadSpec] = []
        self.dispatches = 0

        for panel in prediction_panels(parser):
            indices = parser.indices[panel]
            state = registry.classifier_params(panel)
            if state is None:
                if logger is not None:
                    logger.log(f"Skipping {panel}: no weights")
                continue
            spec = _HeadSpec(
                panel, build_panel_gather(indices, n_channels),
                _on_device(build_panel_model(panel), state, dtype,
                           self.device))
            needs_impute = (
                infer and -1 in indices
                and panel in IMPUTER_MOSAIC  # immune panels only
            )
            mae_state = (registry.imputer_params(panel) if needs_impute
                         else None)
            if mae_state is not None:
                spec.imputer = _on_device(build_imputer_model(panel),
                                          mae_state, dtype, self.device)
                spec.plan = ImputationPlan(panel, indices, self.device)
            self.specs.append(spec)

        if not self.specs:
            raise ValueError("No classifier heads available to run")

        if device_voting:
            self.vote_plan = build_vote_plan([s.panel for s in self.specs])
            # heads the reference's merge branch ignores (e.g. nerve under
            # immune+structure, model.py:509-527) need not run at all
            self.specs = [s for s in self.specs
                          if s.panel in self.vote_plan.heads]

    @property
    def output_spec(self) -> dict[str, int]:
        """Columns of each f32 output matrix ``run_chunk`` emits."""
        if self.vote_plan is not None:
            return {VOTE_STATS_KEY: VOTE_STATS_WIDTH}
        return {s.panel: s.model.num_classes for s in self.specs}

    @torch.inference_mode()
    def run_chunk(self, patches_full: torch.Tensor) -> dict:
        """patches_full: (B, C, 40, 40) f32 on the runner's device. Returns
        {panel: (B, n_classes) f32}, or {"vote_stats": (B, 3)} when device
        voting is on; tensors stay on the device."""
        out = {}
        for s in self.specs:
            x = apply_panel_gather(patches_full, s.gather)
            if s.imputer is not None:
                x = impute(s.imputer, s.plan, x)
            out[s.panel] = torch.softmax(s.model(x).float(), dim=-1)
        self.dispatches += 1
        if self.vote_plan is not None:
            return {VOTE_STATS_KEY: device_vote_stats(out, self.vote_plan)}
        return out
