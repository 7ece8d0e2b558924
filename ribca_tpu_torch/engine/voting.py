"""Ensemble vote merging — vectorized, semantics-exact.

The reference merges per-panel softmax dicts cell-by-cell in pure Python
(model.py:481-639): seven explicit combination branches with subtly
different rules. Here each branch is a handful of (N, K) @ (K, 18) numpy
ops over the whole image — same float32 addition order per cell (immune,
then structure, then nerve), same first-max tie-breaking as ``max(vote,
key=vote.get)`` — so labels match the reference bit-for-bit.

Branch rules replicated exactly:

* full+struct+nerve (model.py:483-507): ALL class probs are summed into
  the vote, including each head's "Others" — the vote gains an 18th
  "Others" slot (inserted last, so argmax ties still prefer the 17 named
  keys).  NOTE: the reference's own code would raise KeyError here
  (``vote[k] += pred[k]`` with k="Others" on the 17-key dict from
  utils.py:143-146); we implement the evident intent instead of the crash
  and document the divergence.
* pairwise branches (model.py:509-581): "Others" probs are EXCLUDED from
  the vote but still drive the threshold via min(o_i..., confidence);
  threshold override applies when cell_type_confidence[type] >= 0
  (the reference tests ``< 0`` for fallback).
* single-panel branches (model.py:583-636): argmax over the head's own
  classes; an argmax of "Others" is accepted unconditionally
  (model.py:600,614,628); override applies only when strictly > 0.
* immune priority: only ONE immune head ever contributes — full >
  extended > base (elif chain, model.py:246-301); e.g. extended+struct+
  nerve falls into the immune+struct branch and nerve is IGNORED.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ribca_tpu_torch.panels.vocab import (
    PANEL_CLASS_MAPS,
    VOTE_KEYS,
    others_index,
)

# Vote-vector name order: the 17 void-vote keys, then the "Others" slot the
# immune_full branch appends.
VOTE_NAMES: tuple[str, ...] = VOTE_KEYS + ("Others",)
_OTHERS_SLOT = len(VOTE_KEYS)
_NAME_TO_SLOT = {n: i for i, n in enumerate(VOTE_NAMES)}


@dataclasses.dataclass
class PanelProbs:
    """Softmax outputs of one classifier head for one image."""

    panel: str           # panel name in PANEL_CLASS_MAPS
    probs: np.ndarray    # (N, num_classes) float32


def scatter_matrix(panel: str, include_others: bool) -> np.ndarray:
    """(num_classes, 18) scatter of head classes into the vote vector."""
    cmap = PANEL_CLASS_MAPS[panel]
    mat = np.zeros((len(cmap), len(VOTE_NAMES)), dtype=np.float32)
    for idx, name in cmap.items():
        if name == "Others" and not include_others:
            continue
        mat[idx, _NAME_TO_SLOT[name]] = 1.0
    return mat


def _others_col(p: PanelProbs) -> np.ndarray:
    cmap = PANEL_CLASS_MAPS[p.panel]
    for idx, name in cmap.items():
        if name == "Others":
            return p.probs[:, idx]
    raise KeyError(p.panel)


def _class_names(panel: str) -> list[str]:
    cmap = PANEL_CLASS_MAPS[panel]
    return [cmap[i] for i in range(len(cmap))]


def _thresholds(
    names: np.ndarray,
    override: np.ndarray,
    fallback: np.ndarray,
    strict_positive: bool,
) -> np.ndarray:
    """Per-cell threshold: override[name] when set, else fallback.

    ``strict_positive`` selects the single-panel rule (override > 0) vs the
    multi-panel rule (override >= 0, i.e. fallback only when < 0)."""
    ov = override[names]
    use_override = ov > 0 if strict_positive else ov >= 0
    return np.where(use_override, ov, fallback).astype(np.float32)


def _override_vector(cell_type_confidence: dict, names) -> np.ndarray:
    return np.asarray(
        [cell_type_confidence.get(n, -1.0) for n in names], dtype=np.float32
    )


def _multi_panel_merge(
    heads: list[PanelProbs],
    include_others: bool,
    confidence_thresh: float,
    cell_type_confidence: dict,
):
    vote = np.zeros((heads[0].probs.shape[0], len(VOTE_NAMES)), np.float32)
    for h in heads:
        vote += h.probs.astype(np.float32) @ scatter_matrix(
            h.panel, include_others
        )
    others = np.stack([_others_col(h) for h in heads], axis=1)

    # max(vote, key=vote.get): first key in insertion order wins ties. With
    # Others excluded its slot stays 0 and never beats a real key unless all
    # are <= 0 (softmax probs are positive, so unreachable).
    width = len(VOTE_NAMES) if include_others else len(VOTE_KEYS)
    arg = np.argmax(vote[:, :width], axis=1)
    best = vote[np.arange(len(arg)), arg]

    fallback = np.minimum(others.min(axis=1), np.float32(confidence_thresh))
    override = _override_vector(cell_type_confidence, VOTE_NAMES)
    thresh = _thresholds(arg, override, fallback, strict_positive=False)

    accept = best >= thresh
    names = np.asarray(VOTE_NAMES, dtype=object)[arg]
    labels = np.where(accept, names, "Others")
    conf = np.where(accept, best, np.float32(-1)).astype(np.float32)
    return list(labels), conf


def _single_panel_merge(
    head: PanelProbs, confidence_thresh: float, cell_type_confidence: dict
):
    probs = head.probs.astype(np.float32)
    names = _class_names(head.panel)
    arg = np.argmax(probs, axis=1)
    best = probs[np.arange(len(arg)), arg]

    override = _override_vector(cell_type_confidence, names)
    fallback = np.full(len(arg), confidence_thresh, np.float32)
    thresh = _thresholds(arg, override, fallback, strict_positive=True)

    is_others = np.asarray([names[a] == "Others" for a in arg], dtype=bool)
    accept = is_others | (best >= thresh)
    name_arr = np.asarray(names, dtype=object)[arg]
    labels = np.where(accept, name_arr, "Others")
    conf = np.where(accept, best, np.float32(-1)).astype(np.float32)
    return list(labels), conf


def merge_by_voting(
    immune: PanelProbs | None,
    structure: PanelProbs | None,
    nerve: PanelProbs | None,
    confidence_thresh: float,
    cell_type_confidence: dict,
) -> tuple[list[str], np.ndarray]:
    """Merge one image's panel probabilities into labels + confidences.

    ``immune`` is the single winning immune head (full > extended > base).
    Returns (labels list[str] length N, confidence float32 (N,))."""
    cc = cell_type_confidence

    if immune is not None and immune.panel == "immune_full" \
            and structure is not None and nerve is not None:
        return _multi_panel_merge(
            [immune, structure, nerve], True, confidence_thresh, cc
        )
    if immune is not None and structure is not None:
        return _multi_panel_merge(
            [immune, structure], False, confidence_thresh, cc
        )
    if structure is not None and nerve is not None:
        return _multi_panel_merge(
            [structure, nerve], False, confidence_thresh, cc
        )
    if immune is not None and nerve is not None:
        return _multi_panel_merge(
            [immune, nerve], False, confidence_thresh, cc
        )
    if immune is not None:
        return _single_panel_merge(immune, confidence_thresh, cc)
    if structure is not None:
        return _single_panel_merge(structure, confidence_thresh, cc)
    if nerve is not None:
        return _single_panel_merge(nerve, confidence_thresh, cc)
    raise ValueError("No predictions to merge")


# -- device-side voting -------------------------------------------------------
#
# The merge runs on the device after the ensemble: it only ever needs three
# scalars per cell, so only those leave the device (12 B/cell instead of up
# to ~80 B/cell of per-panel probs):
#
#     arg        = argmax of the summed vote vector (or the single head)
#     best       = the winning vote value
#     min_others = min over heads of their "Others" prob (multi-panel)
#
# because the confidence thresholds (model.py:504,531,558,585,599) enter
# ONLY in the accept/reject comparison. So the ensemble step computes
# (arg, best, min_others) on device — bit-identical to the host numpy
# path: the per-head scatter matrices are one-hot selections (no
# summation inside a head), and the cross-head f32 adds run in the same
# immune -> structure -> nerve order — and ``finish_votes`` applies the
# thresholds on host, which keeps re-voting with DIFFERENT thresholds
# (and the dict-oracle parity tests) exact without re-running inference.

VOTE_STATS_WIDTH = 3  # [arg as f32, best, min_others]


@dataclasses.dataclass(frozen=True)
class VotePlan:
    """Static description of the merge branch for one marker parse.

    Replicates the reference's branch cascade (model.py:481-639): the
    full+struct+nerve triple includes each head's "Others" in the vote;
    immune+structure IGNORES a matched nerve head (the elif chain);
    single panels argmax their own classes with the strict-positive
    override rule."""

    heads: tuple[str, ...]         # voting heads, reference add order
    multi: bool
    include_others: bool           # multi: vote gains the 18th slot
    names: tuple[str, ...]         # label table indexed by ``arg``
    others_arg: int                # single-panel: class index of "Others"


def build_vote_plan(panels) -> VotePlan:
    """``panels``: the classifier heads that actually ran (at most one
    immune head, reference priority already applied)."""
    immune = next((p for p in panels if p.startswith("immune")), None)
    structure = "structure" if "structure" in panels else None
    nerve = "nerve_cell" if "nerve_cell" in panels else None

    if immune == "immune_full" and structure and nerve:
        heads, include = (immune, structure, nerve), True
    elif immune and structure:
        heads, include = (immune, structure), False
    elif structure and nerve:
        heads, include = (structure, nerve), False
    elif immune and nerve:
        heads, include = (immune, nerve), False
    else:
        single = immune or structure or nerve
        if single is None:
            raise ValueError("No panels to build a vote plan for")
        return VotePlan(
            heads=(single,), multi=False, include_others=False,
            names=tuple(_class_names(single)),
            others_arg=others_index(single),
        )
    return VotePlan(
        heads=heads, multi=True, include_others=include,
        names=VOTE_NAMES, others_arg=-1,
    )


def _slot_class_idx(panel: str, include_others: bool) -> np.ndarray:
    """(18,) int32: head class index feeding each vote slot, -1 if none.

    The inverse view of ``scatter_matrix`` — valid because every panel's
    class map is bijective (each cell-type name appears at most once per
    head), so a vote slot receives at most one class prob per head and
    the device gather reproduces the host matmul bit-for-bit."""
    cmap = PANEL_CLASS_MAPS[panel]
    idx = np.full(len(VOTE_NAMES), -1, dtype=np.int32)
    for ci, name in cmap.items():
        if name == "Others" and not include_others:
            continue
        slot = _NAME_TO_SLOT[name]
        assert idx[slot] == -1, f"duplicate class name {name} in {panel}"
        idx[slot] = ci
    return idx


def device_vote_stats(probs: dict, plan: VotePlan):
    """torch: per-cell (B, 3) f32 ``[arg, best, min_others]`` from the
    per-panel softmax outputs (``{panel: (B, k) f32 tensor}``), computed
    on the tensors' device."""

    if not plan.multi:
        p = probs[plan.heads[0]]
        arg = torch.argmax(p, dim=1)
        best = torch.gather(p, 1, arg[:, None])[:, 0]
        min_others = torch.full_like(best, float("inf"))
        return torch.stack([arg.to(torch.float32), best, min_others], dim=1)

    width = len(VOTE_NAMES) if plan.include_others else len(VOTE_KEYS)
    vote = None
    others = []
    for panel in plan.heads:
        p = probs[panel]                       # (B, k) f32
        slots = _slot_class_idx(panel, plan.include_others)
        # gather each slot's class prob (clip keeps the gather in
        # bounds; the where zeroes unmapped slots — adding 0.0 is exact)
        cols = torch.as_tensor(np.clip(slots, 0, None), device=p.device)
        mapped = torch.as_tensor(slots >= 0, device=p.device)
        contrib = torch.where(mapped, p[:, cols], 0.0)
        vote = contrib if vote is None else vote + contrib
        others.append(p[:, others_index(panel)])
    arg = torch.argmax(vote[:, :width], dim=1)
    best = torch.gather(vote, 1, arg[:, None])[:, 0]
    min_others = torch.stack(others, dim=1).amin(dim=1)
    return torch.stack([arg.to(torch.float32), best, min_others], dim=1)


def finish_votes(
    stats: np.ndarray,
    plan: VotePlan,
    confidence_thresh: float,
    cell_type_confidence: dict,
) -> tuple[list[str], np.ndarray]:
    """Host thresholding of device vote stats; semantics identical to
    ``merge_by_voting`` on the full prob matrices (asserted by
    tests/test_device_voting.py)."""
    stats = np.asarray(stats, dtype=np.float32)
    arg = stats[:, 0].astype(np.int64)
    best = stats[:, 1]
    names_arr = np.asarray(plan.names, dtype=object)
    override = _override_vector(cell_type_confidence, plan.names)

    if plan.multi:
        min_others = stats[:, 2]
        fallback = np.minimum(min_others, np.float32(confidence_thresh))
        thresh = _thresholds(arg, override, fallback, strict_positive=False)
        accept = best >= thresh
    else:
        fallback = np.full(len(arg), confidence_thresh, np.float32)
        thresh = _thresholds(arg, override, fallback, strict_positive=True)
        accept = (arg == plan.others_arg) | (best >= thresh)

    labels = np.where(accept, names_arr[arg], "Others")
    conf = np.where(accept, best, np.float32(-1)).astype(np.float32)
    return list(labels), conf
