"""Neutral on-disk parameter store (.npz of flattened param paths).

The same file format as ribca_tpu's ``models/store.py``: a Flax param tree
flattened to ``a/b/c`` keys. The port reads these files and converts the
tree to its own state dicts (models/params.py), so one ``.npz`` serves
both packages. ribca_tpu's Orbax directory checkpoints are not read here.
"""

from __future__ import annotations

import numpy as np


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_params(path: str) -> dict:
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})
