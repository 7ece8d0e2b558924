"""Run logging.

Keeps the reference's plain-text ``results/log.txt`` contract
(``logger.py:4-20``) and adds per-stage wall-time tracing, written to
``results/trace.json``, which the reference lacks.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


class Logger:
    """Plain-text run log, same file layout as the reference logger."""

    def __init__(self, main_dir: str, subdir: str = "results"):
        os.makedirs(os.path.join(main_dir, subdir), exist_ok=True)
        self.log_file_path = os.path.join(main_dir, subdir, "log.txt")
        self.log_file = open(self.log_file_path, "w")
        self.log_file.write("Log file created at {}\n".format(time.ctime()))
        self._timings: dict[str, float] = {}
        self._flags: dict[str, object] = {}

    def set_flag(self, name: str, value) -> None:
        """Run-level marker surfaced in trace.json (e.g. random_weights)."""
        self._flags[name] = value

    def log(self, message: str) -> None:
        self.log_file.write(message + "\n")
        self.log_file.flush()

    def log_all_hyperparameters(self, hyperparameters: dict) -> None:
        self.log_file.write("Hyperparameters:\n")
        for key, value in hyperparameters.items():
            self.log_file.write(f"{key}: {value}\n")
        self.log_file.flush()

    @contextlib.contextmanager
    def stage(self, name: str, quiet: bool = False, sync=None):
        """Time a pipeline stage; accumulated into the trace summary.
        ``quiet`` skips the per-call log line, for sub-stages entered many
        times per run. ``sync`` (a callable, e.g. the device's synchronize)
        runs before the clock stops, so asynchronous GPU work is charged
        to the stage that queued it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            dt = time.perf_counter() - t0
            self._timings[name] = self._timings.get(name, 0.0) + dt
            if not quiet:
                self.log(f"[trace] stage {name}: {dt:.3f}s")

    @property
    def timings(self) -> dict[str, float]:
        return dict(self._timings)

    def write_trace_summary(self) -> None:
        path = os.path.join(os.path.dirname(self.log_file_path), "trace.json")
        with open(path, "w") as f:
            json.dump({**self._timings, **self._flags}, f, indent=2)

    def close(self) -> None:
        self.log_file.close()
