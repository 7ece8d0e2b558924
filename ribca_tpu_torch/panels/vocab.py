"""Fixed vocabularies of the RIBCA annotation task.

These must match the reference exactly to keep annotations compatible:
cell-type list (reference ``model.py:97-99``), vote-key set
(``utils.py:143-146``), panel marker orders (``markerParse.py:8-17``),
per-panel class-index maps (``model.py:247-252,266-270,284-287,309-312,334``),
marker alias table (``markerParse.py:76-77``) and per-panel missing-marker
budgets (``markerParse.py:33``).
"""

from __future__ import annotations

import numpy as np

# The 18-type global vocabulary, in the reference's declaration order.
CELL_TYPES: tuple[str, ...] = (
    "B cell",
    "CD4 T cell",
    "CD8 T cell",
    "Dendritic cell",
    "Regulatory T cell",
    "Granulocyte cell",
    "Mast cell",
    "M1 macrophage cell",
    "M2 macrophage cell",
    "Natural killer cell",
    "Plasma cell",
    "Endothelial cell",
    "Epithelial cell",
    "Stroma cell",
    "Smooth muscle",
    "Proliferating/tumor cell",
    "Nerve cell",
    "Others",
)

# The 17 keys of the ensemble vote vector ("Others" is NOT a key; the
# immune_full merge branch adds its "Others" prob into the vote dict, which
# in the reference silently creates an 18th key — replicated in engine/voting).
VOTE_KEYS: tuple[str, ...] = (
    "CD4 T cell",
    "CD8 T cell",
    "Dendritic cell",
    "B cell",
    "M1 macrophage cell",
    "M2 macrophage cell",
    "Regulatory T cell",
    "Granulocyte cell",
    "Plasma cell",
    "Natural killer cell",
    "Mast cell",
    "Stroma cell",
    "Smooth muscle",
    "Endothelial cell",
    "Epithelial cell",
    "Proliferating/tumor cell",
    "Nerve cell",
)

VOTE_INDEX: dict[str, int] = {k: i for i, k in enumerate(VOTE_KEYS)}


def get_void_vote() -> dict[str, float]:
    """Fresh all-zero vote dict, same key order as the reference."""
    return {k: 0.0 for k in VOTE_KEYS}


# Antibody panels and their fixed marker orders.
PANELS: dict[str, list[str]] = {
    "immune_base": ["CD45", "CD20", "CD4", "CD8", "DAPI", "CD11c", "CD3"],
    "immune_extended": [
        "DAPI", "CD3", "CD4", "CD8", "CD11c", "CD20", "CD45", "CD68",
        "CD163", "CD56",
    ],
    "immune_full": [
        "DAPI", "CD3", "CD4", "CD8", "CD11c", "CD15", "CD20", "CD45",
        "CD56", "CD68", "CD138", "CD163", "FoxP3", "Granzyme B", "Trypase",
    ],
    "structure": ["DAPI", "aSMA", "CD31", "PanCK", "Vimentin", "Ki67", "CD45"],
    "nerve_cell": ["DAPI", "CD45", "GFAP"],
}

# Missing-marker tolerance per panel when strict=False (and len(panel) > 3).
PANEL_MISSING_BUDGET: dict[str, int] = {
    "immune_base": 1,
    "immune_extended": 2,
    "immune_full": 3,
    "structure": 1,
    "nerve_cell": 0,
}

# Marker-name aliases applied before panel matching.
REPLACEMENTS: dict[str, str] = {
    "DNA": "DAPI",
    "DPAI-02": "DAPI",
    "CD16": "CD15",
    "CD38": "CD138",
    "CD79": "CD20",
    "CHGA": "GFAP",
    "SMActin": "aSMA",
    "CD3e": "CD3",
    "CK": "PanCK",
    "CytoKeratin": "PanCK",
    "Cytokeratin": "PanCK",
    "Cytokeratin-19": "PanCK",
    "panCK": "PanCK",
}

# "X or Y" phrasing used in missing-marker messages.
MISSING_ALTERNATIVES: dict[str, str] = {
    "CD20": "CD20 or CD79a",
    "GFAP": "GFAP or Chromogranin A",
    "CD138": "CD138 or CD38",
}

# Per-panel classifier-head class-index -> cell-type-name maps.
PANEL_CLASS_MAPS: dict[str, dict[int, str]] = {
    "immune_full": {
        0: "CD4 T cell", 1: "CD8 T cell", 2: "Dendritic cell", 3: "B cell",
        4: "M1 macrophage cell", 5: "M2 macrophage cell",
        6: "Regulatory T cell", 7: "Granulocyte cell", 8: "Plasma cell",
        9: "Natural killer cell", 10: "Mast cell", 11: "Others",
    },
    "immune_extended": {
        0: "CD4 T cell", 1: "CD8 T cell", 2: "Dendritic cell", 3: "B cell",
        4: "M1 macrophage cell", 5: "M2 macrophage cell",
        6: "Natural killer cell", 7: "Others",
    },
    "immune_base": {
        0: "B cell", 1: "CD4 T cell", 2: "CD8 T cell", 3: "Others",
        4: "Dendritic cell",
    },
    "structure": {
        0: "Stroma cell", 1: "Smooth muscle", 2: "Endothelial cell",
        3: "Epithelial cell", 4: "Proliferating/tumor cell", 5: "Others",
    },
    "nerve_cell": {0: "Nerve cell", 1: "Others"},
}

# Classifier architecture per panel: (arch, in_chans, num_classes).
PANEL_MODEL_SPECS: dict[str, tuple[str, int, int]] = {
    "immune_base": ("vit_s", 7, 5),
    "immune_extended": ("vit_m", 10, 8),
    "immune_full": ("vit_l", 15, 12),
    "structure": ("vit_s", 7, 6),
    "nerve_cell": ("vit_tiny", 3, 2),
}

# MAE imputer mosaic layouts per panel: (rows, cols) of 40x40 tiles.
IMPUTER_MOSAIC: dict[str, tuple[int, int]] = {
    "immune_full": (3, 5),
    "immune_extended": (2, 5),
    "immune_base": (1, 7),
}


def class_prob_matrix(panel: str) -> np.ndarray:
    """(num_classes, 17) one-hot scatter matrix from a panel's class map into
    the vote vector; the "Others" class row is all-zero (handled separately
    by the voting branches)."""
    cmap = PANEL_CLASS_MAPS[panel]
    mat = np.zeros((len(cmap), len(VOTE_KEYS)), dtype=np.float32)
    for idx, name in cmap.items():
        if name != "Others":
            mat[idx, VOTE_INDEX[name]] = 1.0
    return mat


def others_index(panel: str) -> int:
    """Class index of "Others" in a panel's head (every panel has one)."""
    cmap = PANEL_CLASS_MAPS[panel]
    for idx, name in cmap.items():
        if name == "Others":
            return idx
    raise KeyError(f"panel {panel} has no Others class")
