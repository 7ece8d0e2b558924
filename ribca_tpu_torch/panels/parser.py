"""Marker/panel parser.

Behavioral contract follows the reference ``markerParse.py`` exactly:

* marker file is read with ``np.loadtxt(delimiter=',', dtype=str)`` —
  including its fixed-width string dtype, so alias replacement can
  truncate (a faithful quirk of the reference, ``markerParse.py:79-82``);
* alias replacement only fires when the canonical name is not already in
  the list;
* a panel matches if every panel marker is present, tolerating up to
  ``PANEL_MISSING_BUDGET[panel]`` missing markers when ``strict=False``
  and the panel has more than 3 markers; missing markers get index -1
  (``markerParse.py:30-60``);
* matched indices are positions in the user's marker list, in panel order.
"""

from __future__ import annotations

import numpy as np

from ribca_tpu_torch.panels.vocab import (
    MISSING_ALTERNATIVES,
    PANELS,
    PANEL_MISSING_BUDGET,
    REPLACEMENTS,
)


class MarkerParser:
    """Matches a user marker list against the five supported panels."""

    def __init__(self, strict: bool = True, logger=None):
        self.panels = {name: list(markers) for name, markers in PANELS.items()}
        self.indices: dict[str, list[int] | None] = {}

        self.immune_base = False
        self.immune_extended = False
        self.immune_full = False
        self.struct = False
        self.nerve = False

        self.strict = strict
        self.markers: list[str] = []
        self.n_markers = 0
        self.logger = logger

    # -- internals ---------------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.log(msg)

    def _matching(self, marker_list: list[str], panel: list[str], panel_name: str):
        matched: list[int] = []
        missing: list[str] = []
        budget = PANEL_MISSING_BUDGET[panel_name]
        for marker in panel:
            if marker in marker_list:
                matched.append(marker_list.index(marker))
                continue
            marker_ = MISSING_ALTERNATIVES.get(marker, marker)
            if not self.strict and len(panel) > 3:
                missing.append(marker_)
                matched.append(-1)
                if len(missing) > budget:
                    str_missing = ", ".join(missing)
                    self._log(f"Markers {str_missing} are not found in the list.")
                    return None
            else:
                self._log(f"Marker {marker_} is not found in the list.")
                return None
        return matched

    # -- public API ---------------------------------------------------------

    def parse(self, marker_file: str) -> None:
        # np.loadtxt keeps the reference's exact reading semantics
        # (comment stripping, whitespace handling, fixed-width str dtype).
        marker_list = np.loadtxt(marker_file, delimiter=",", dtype=str)
        marker_list = np.atleast_1d(marker_list)

        text = "The panel contains the following markers: "
        for marker in marker_list:
            text += str(marker) + ", "
            self.markers.append(str(marker))
        self._log(text[:-2] + ".")

        for i in range(len(marker_list)):
            name = str(marker_list[i])
            if name in REPLACEMENTS and REPLACEMENTS[name] not in marker_list:
                marker_list[i] = REPLACEMENTS[name]  # may truncate, like the ref
                self._log(
                    f"Replaced the marker name {name} with {marker_list[i]} "
                    "to match our panel."
                )
        self._log("")

        marker_list = [str(m) for m in marker_list]
        self.n_markers = len(marker_list)

        for panel in self.panels:
            matched = self._matching(marker_list, self.panels[panel], panel)
            if matched:
                self.indices[panel] = matched
                self._log(f"{panel} panel is applied.")
                self._log("\n")
            else:
                self._log(f"{panel} panel is not applied.")
                self._log("\n")
                self.indices[panel] = None

        self.immune_base = bool(self.indices["immune_base"])
        self.immune_extended = bool(self.indices["immune_extended"])
        self.immune_full = bool(self.indices["immune_full"])
        self.struct = bool(self.indices["structure"])
        self.nerve = bool(self.indices["nerve_cell"])

    @property
    def any_panel(self) -> bool:
        return (
            self.immune_base
            or self.immune_extended
            or self.immune_full
            or self.struct
            or self.nerve
        )

    def active_panels(self) -> list[str]:
        """Panels that matched, in the reference's fixed panel order."""
        return [p for p in self.panels if self.indices.get(p) is not None]
