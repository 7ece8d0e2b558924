"""Per-cell annotation CSV export.

Format parity with Annotator.export_annotations (model.py:768-795):

    Cell Index,Cell Type,Confidence,Row,Column,Tissue Region
    <id>,<type name>,<round(conf,3)>,<round(mean_row,2)>,<round(mean_col,2)>,<Region k | None>

The reference rounds with Python ``round`` (banker's rounding) and writes
the literal string ``None`` when tissue regions were not computed — both
kept.
"""

from __future__ import annotations

import os


def export_annotations_csv(
    path: str,
    cell_ids,
    labels,
    confidence,
    mean_row,
    mean_col,
    tissue_regions: dict | None = None,
) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("Cell Index,Cell Type,Confidence,Row,Column,Tissue Region\n")
        for j, cid in enumerate(cell_ids):
            conf = round(float(confidence[j]), 3)
            row = round(float(mean_row[j]), 2)
            col = round(float(mean_col[j]), 2)
            region = (
                "Region " + str(tissue_regions[int(cid)])
                if tissue_regions is not None else None
            )
            f.write(f"{cid},{labels[j]},{conf},{row},{col},{region}\n")
    return path
