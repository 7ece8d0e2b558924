"""Cohort-level dispatch packing: tail cells of many images share full
ensemble dispatches.

The port of ribca_tpu's ``engine/packer.py``. Each image's last chunk of
cells rounds up to a power-of-two bucket (engine/pipeline.py), and the
rows past its cells are padding the ensemble computes for nothing; with
the MAE imputer in the ensemble a pad row costs about 1.35-1.7x what it
cost without. The packer keeps a device staging buffer of at most twice
the pack size:

* full pieces (valid == bucket == pack) dispatch directly, with no copy;
* partial pieces are copied into the buffer at its fill mark;
* whenever the buffer holds >= pack valid cells, its front ``pack`` rows
  dispatch as one full ensemble step and the rest moves down, so the tail
  of image i and the head of image i+1 ride the same dispatch;
* ``finalize()`` dispatches the remainder at its power-of-two bucket, so
  the padding is paid once per cohort, not once per image.

Results route back through per-image "sinks" (numpy matrices made by
``make_sink``): a segment list maps buffer spans to (sink, row offset) and
splits a span that crosses a flush boundary. Each dispatch's outputs (a
few floats per cell) come back at once through pinned host buffers and
one event wait (``to_host``). ribca_tpu keeps ``prefetch_depth``
dispatches in flight instead; here every ``device.*`` stage of a traced
run synchronizes at its end, so a deeper queue would overlap nothing, and
the port ignores that setting (utils/config.TPU_ONLY_KEYS).

The front dispatches before the buffer shifts: the ensemble reads a view
of the buffer, and the shift is queued behind it on the same stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MIN_CHUNK = 64
MIN_CAPACITY = 64


def chunk_size_for(n: int, cap: int) -> int:
    """Power-of-two bucket >= n (>= MIN_CHUNK), capped at ``cap``."""
    size = MIN_CHUNK
    while size < n and size < cap:
        size *= 2
    return min(size, cap)


@dataclasses.dataclass
class _Segment:
    sink: dict            # {key: np.ndarray (n_cells, width)}
    rec_off: int          # first sink row of the span
    buf_start: int        # first row in the staging buffer
    length: int

    def rows(self) -> slice:
        return slice(self.rec_off, self.rec_off + self.length)

    def split(self, head: int) -> tuple["_Segment", "_Segment"]:
        """(first ``head`` rows, remainder with buf_start reset to 0)."""
        a = dataclasses.replace(self, length=head)
        b = dataclasses.replace(self, rec_off=self.rec_off + head,
                                buf_start=0, length=self.length - head)
        return a, b


def to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Copy device tensors into pinned host buffers; one event wait."""
    if not tensors or tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))
    done.synchronize()
    return [h.numpy() for h in hosts]


class CohortPacker:
    """Packs partial ensemble dispatches across the images of one run."""

    def __init__(self, runner, pack_cells: int, n_channels: int):
        self.runner = runner
        self.pack = int(pack_cells)
        self.c = int(n_channels)
        self._buf = None      # lazy: many runs never pack anything
        self.fill = 0
        self.segments: list[_Segment] = []
        # cells dispatched vs cells actually valid
        self.dispatched_rows = 0
        self.valid_rows = 0

    def make_sink(self, n_cells: int) -> dict:
        """Per-image output matrices the packer writes into (per-panel
        probs, or the 3-wide vote stats under device voting)."""
        return {
            key: np.empty((n_cells, width), np.float32)
            for key, width in self.runner.output_spec.items()
        }

    # -- submission -------------------------------------------------------------

    def submit(self, patches: torch.Tensor, n_valid: int, sink: dict,
               rec_off: int) -> None:
        """One extracted piece: ``patches`` is a (bucket, C, 40, 40) f32
        tensor on the runner's device with ``n_valid`` true rows destined
        for ``sink[key][rec_off : rec_off + n_valid]``."""
        b = int(patches.shape[0])
        if n_valid == 0:
            return
        if n_valid == b == self.pack:
            self._dispatch(patches, [_Segment(sink, rec_off, 0, n_valid)])
            return
        self._ensure_capacity(self.fill + b)
        self._buf[self.fill:self.fill + b].copy_(patches)
        self.segments.append(_Segment(sink, rec_off, self.fill, n_valid))
        self.fill += n_valid
        while self.fill >= self.pack:
            self._flush_front()

    def _ensure_capacity(self, rows: int) -> None:
        """Grow the staging buffer geometrically, from 64 rows up to 2x
        pack: a small run must not allocate a buffer sized for a
        production cohort."""
        cap = 0 if self._buf is None else int(self._buf.shape[0])
        if rows <= cap:
            return
        new_cap = MIN_CAPACITY
        while new_cap < rows:
            new_cap *= 2
        new_cap = min(new_cap, 2 * self.pack)
        new = torch.zeros((new_cap, self.c, 40, 40), dtype=torch.float32,
                          device=self.runner.device)
        if self.fill:
            # carry the staged rows into the bigger buffer
            new[:cap].copy_(self._buf)
        self._buf = new

    # -- flushing ---------------------------------------------------------------

    def _dispatch(self, patches: torch.Tensor,
                  segments: list[_Segment]) -> None:
        outputs = self.runner.run_chunk(patches)
        self.dispatched_rows += int(patches.shape[0])
        self.valid_rows += sum(s.length for s in segments)
        self._drain(outputs, segments)

    def _flush_front(self) -> None:
        resolved, carried = [], []
        for s in self.segments:
            if s.buf_start + s.length <= self.pack:
                resolved.append(s)
            elif s.buf_start >= self.pack:
                carried.append(dataclasses.replace(
                    s, buf_start=s.buf_start - self.pack))
            else:  # straddles the boundary: split
                head, tail = s.split(self.pack - s.buf_start)
                resolved.append(head)
                carried.append(tail)
        # dispatch first: the ensemble reads a view of the buffer's front,
        # and the shift below is queued behind it
        self._dispatch(self._buf[:self.pack], resolved)
        rest = self.fill - self.pack
        if rest:
            # rest < pack: source and destination never overlap
            self._buf[:rest].copy_(self._buf[self.pack:self.pack + rest])
        self.segments = carried
        self.fill = rest

    def _drain(self, outputs: dict, segments: list[_Segment]) -> None:
        """Route one dispatch's valid rows to their sinks."""
        host = dict(zip(outputs, to_host(list(outputs.values()))))
        for s in segments:
            for key, arr in host.items():
                s.sink[key][s.rows()] = arr[s.buf_start:s.buf_start + s.length]

    def finalize(self) -> None:
        """Dispatch the remainder (at its bucket). After this, every sink
        handed out by make_sink is fully written."""
        if self.fill > 0:
            size = chunk_size_for(self.fill, self.pack)
            self._dispatch(self._buf[:size], self.segments)
            self.segments = []
            self.fill = 0

    @property
    def pad_fraction(self) -> float:
        """Fraction of dispatched ensemble rows that were padding."""
        if not self.dispatched_rows:
            return 0.0
        return 1.0 - self.valid_rows / self.dispatched_rows
