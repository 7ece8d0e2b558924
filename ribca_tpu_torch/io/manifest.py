"""Batch manifests: the ``images.csv`` contract of the reference
(main.py:12-13; preprocess.py:27-30): columns ``image_path,mask_path``."""

from __future__ import annotations

import csv


def read_manifest(csv_path: str) -> list[tuple[str, str]]:
    pairs: list[tuple[str, str]] = []
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or "image_path" not in reader.fieldnames:
            raise ValueError(
                f"{csv_path}: expected header with image_path,mask_path"
            )
        for row in reader:
            pairs.append((row["image_path"], row["mask_path"]))
    return pairs


def write_manifest(pairs: list[tuple[str, str]], csv_path: str) -> str:
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["image_path", "mask_path"])
        for img, mask in pairs:
            writer.writerow([img, mask])
    return csv_path
