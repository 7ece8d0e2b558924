"""Marker auto-extraction from OME-TIFF / QPTIFF metadata.

Replaces the reference's two paths (SURVEY §2 row 20):
  * OME-TIFF: XML-parse ``//ome:Channel@Name`` from the OME block
    (_widget.py:249-269,686-709) — done here in pure Python from the TIFF
    ImageDescription tag;
  * QPTIFF: the reference shells out to the vendored Java Bio-Formats
    ``showinf`` and regexes ``Biomarker #N:`` lines (_widget.py:271-295).
    Here we parse the per-page PerkinElmer/Akoya XML descriptions directly
    (``<Biomarker>`` elements); an optional ``bftools_showinf`` hook keeps
    subprocess compatibility for exotic formats.
"""

from __future__ import annotations

import os
import re
import subprocess
import xml.etree.ElementTree as ET

from PIL import Image, ImageSequence

IMAGEDESCRIPTION_TAG = 270


def _page_descriptions(path: str) -> list[str]:
    descs = []
    with Image.open(path) as im:
        for page in ImageSequence.Iterator(im):
            tag = getattr(page, "tag_v2", None)
            if tag is not None and IMAGEDESCRIPTION_TAG in tag:
                value = tag[IMAGEDESCRIPTION_TAG]
                if isinstance(value, bytes):
                    value = value.decode("utf-8", errors="replace")
                descs.append(str(value))
            else:
                descs.append("")
    return descs


def extract_markers_ome(path: str) -> list[str]:
    """Channel names from the OME-XML block of an OME-TIFF."""
    descs = _page_descriptions(path)
    for desc in descs:
        if "<OME" not in desc and "ome.xml" not in desc.lower():
            continue
        try:
            root = ET.fromstring(desc)
        except ET.ParseError:
            continue
        names = []
        for el in root.iter():
            if el.tag.endswith("Channel"):
                name = el.attrib.get("Name")
                if name:
                    names.append(name)
        if names:
            return names
    return []


def extract_markers_qptiff(path: str) -> list[str]:
    """Biomarker names from QPTIFF (PerkinElmer/Akoya) page descriptions."""
    names: list[str] = []
    for desc in _page_descriptions(path):
        if "<Biomarker>" in desc:
            m = re.search(r"<Biomarker>\s*([^<]+?)\s*</Biomarker>", desc)
            if m:
                names.append(m.group(1))
            continue
        try:
            root = ET.fromstring(desc)
        except ET.ParseError:
            continue
        for el in root.iter():
            if el.tag.endswith("Biomarker") and el.text:
                names.append(el.text.strip())
    return names


def bftools_showinf(path: str, showinf: str) -> list[str]:
    """Compatibility shim for the reference's Java ``showinf`` flow
    (_widget.py:280,720): regex ``Biomarker #N: NAME`` lines."""
    out = subprocess.run(
        [showinf, "-nopix", "-omexml", path],
        capture_output=True, text=True, check=False,
    ).stdout
    return re.findall(r"Biomarker\s*#\d+:\s*(\S+)", out)


def extract_markers(path: str, showinf: str | None = None) -> list[str]:
    """Best-effort marker extraction: OME first, then QPTIFF, then showinf."""
    names = extract_markers_ome(path)
    if not names:
        names = extract_markers_qptiff(path)
    if not names and showinf and os.path.exists(showinf):
        names = bftools_showinf(path, showinf)
    return names


def write_marker_txt(names: list[str], out_path: str) -> str:
    """Write the AUTOMATIC_markers_*.txt file the GUI flow expects
    (_widget.py:307-326)."""
    with open(out_path, "w") as f:
        for n in names:
            f.write(n + "\n")
    return out_path
