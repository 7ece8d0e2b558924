"""Model registry: locate and load ensemble weights.

The port of ribca_tpu's ``models/registry.py``. The reference hardcodes
cwd-relative ``.pth`` paths (model.py:189-239) and silently skips panels
whose checkpoint is absent. Here a registry owns one models directory and
resolves each classifier's weights, as a state dict of the port's
VisionTransformer, and each imputer's, as a state dict of its
MaskedAutoencoderViT, in this order:

  1. ``<name>.npz``  — ribca_tpu's converted Flax store, through the bridge
     in models/params.py (so one file serves both packages);
  2. ``<name>.pth``  — the reference's timm-layout torch checkpoint, loaded
     straight into the module;
  3. seeded random init — only when ``allow_random``; every such load is
     logged loudly and marks the run RANDOM_WEIGHTS.

Checkpoint basenames follow the reference: ``immune_base``,
``immune_extended``, ``immune_full``, ``struct``, ``nerve`` and
``<immune_panel>_impute`` for the MAE imputers.
"""

from __future__ import annotations

import os
import sys

import torch

from ribca_tpu_torch.models import store
from ribca_tpu_torch.models.params import (
    mae_state_dict,
    random_mae_tree,
    random_vit_tree,
    vit_state_dict,
)
from ribca_tpu_torch.models.vit import ARCH_WIDTHS
from ribca_tpu_torch.panels.vocab import PANEL_MODEL_SPECS

CLASSIFIER_BASENAME = {
    "immune_base": "immune_base",
    "immune_extended": "immune_extended",
    "immune_full": "immune_full",
    "structure": "struct",
    "nerve_cell": "nerve",
}

DEFAULT_MODELS_DIR = os.path.join(os.path.dirname(__file__), "weights")


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` (``{"model": state_dict}`` or a bare state dict).
    The reference's checkpoints pickle more than tensors, so this unpickles
    like ribca_tpu's converter does: load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return {k: v.detach().to(torch.float32) for k, v in sd.items()}


class ModelRegistry:
    def __init__(self, models_dir: str | None = None, logger=None,
                 allow_random: bool = True):
        self.models_dir = models_dir or DEFAULT_MODELS_DIR
        self.logger = logger
        self.allow_random = allow_random
        self._cache: dict[str, dict] = {}
        # set when any component fell back to random init; surfaced as a
        # RANDOM_WEIGHTS marker in log.txt and trace.json so such runs
        # cannot be mistaken for real ones after the fact
        self.used_random = False

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.log(msg)

    def _warn_random(self, what: str) -> None:
        """Missing weights are easy to miss in log.txt alone; also shout
        to stderr so a misconfigured models_dir is visible at the console."""
        msg = (
            f"WARNING: {what} weights not found in {self.models_dir}; "
            "using RANDOM initialization — annotations will be "
            "meaningless. Set allow_random_weights=False to make this "
            "fatal."
        )
        self.used_random = True
        self._log(msg)
        print(msg, file=sys.stderr)

    def _resolve(self, basename: str, bridge):
        npz = os.path.join(self.models_dir, f"{basename}.npz")
        if os.path.exists(npz):
            return bridge(store.load_params(npz))
        pth = os.path.join(self.models_dir, f"{basename}.pth")
        if os.path.exists(pth):
            return load_torch_checkpoint(pth)
        return None

    def classifier_params(self, panel: str):
        """State dict of a panel's classifier, or None when weights are
        missing and random init is disallowed."""
        key = f"cls:{panel}"
        if key in self._cache:
            return self._cache[key]
        sd = self._resolve(CLASSIFIER_BASENAME[panel], vit_state_dict)
        if sd is None:
            if not self.allow_random:
                self._log(f"{panel} classifier weights not found")
                return None
            self._warn_random(f"{panel} classifier")
            arch, in_chans, num_classes = PANEL_MODEL_SPECS[panel]
            sd = vit_state_dict(random_vit_tree(
                in_chans, num_classes, ARCH_WIDTHS[arch], seed=0))
        self._cache[key] = sd
        return sd

    def imputer_params(self, panel: str):
        """State dict of an immune panel's MAE imputer, or None when
        weights are missing and random init is disallowed."""
        key = f"mae:{panel}"
        if key in self._cache:
            return self._cache[key]
        basename = f"{CLASSIFIER_BASENAME[panel]}_impute"
        sd = self._resolve(basename, mae_state_dict)
        if sd is None:
            if not self.allow_random:
                self._log(f"{panel} imputer weights not found")
                return None
            self._warn_random(f"{panel} imputer")
            sd = mae_state_dict(random_mae_tree(panel, seed=0))
        self._cache[key] = sd
        return sd
