"""Time the attention kernel's staging and compute apart on one NVIDIA GPU.

    python -m ribca_tpu_torch.tools.attention_split

Builds ``csrc/attention.cu`` three times, all at once, with
``RIBCA_ATTN_PART`` 0 (the port's build: every (cell, head) pair staged
and computed), 1 (every pair staged, none computed, no output written) and
2 (a block's first two pairs staged, every pair computed from them and its
output written). For each shape, dtype and input layout it prints one JSON
line: CUDA-event medians of 10 of each build, timed in the order 0, 1, 2,
2, 1, 0 so that a drift of the card shows, beside the least time of the
work each build does (bytes at 3.35 TB/s, operations at the type's peak).
Build 0 is also held against the plain version. Needs one CUDA device and
nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ribca_tpu_torch import kernels
from ribca_tpu_torch.ops.attention import (
    _bind,
    _check,
    _empty_output,
    _launch,
    reference_attention,
)
from ribca_tpu_torch.utils.device import resolve_device

BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PARTS = {0: "full", 1: "staging", 2: "compute"}
# (shape, dtype, layout): the main path's shapes (an 8192-cell pack, the
# CLI's 4096-cell dispatch, a slide's 2048-cell tail)
CASES = (
    ((8192, 12, 101, 24), torch.bfloat16, "fused"),
    ((8192, 12, 101, 24), torch.bfloat16, "contiguous"),
    ((4096, 12, 101, 24), torch.bfloat16, "fused"),
    ((4096, 12, 101, 24), torch.bfloat16, "contiguous"),
    ((2048, 12, 101, 24), torch.bfloat16, "fused"),
    ((8192, 12, 101, 24), torch.float32, "fused"),
    ((8192, 12, 101, 24), torch.float32, "contiguous"),
)


def build_parts() -> dict[int, ctypes.CDLL]:
    """{part: loaded library}, built into the package's _build/."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = kernels.sources()["attention"]
    procs = {}
    for part in PARTS:
        out = os.path.join(kernels.BUILD_DIR, f"libattention_part{part}.so")
        procs[part] = (out, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS,
             f"-DRIBCA_ATTN_PART={part}", "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for part, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for part {part}:\n{log}")
        libs[part] = ctypes.CDLL(out)
    return libs


def cuda_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def bounds_ms(shape, dtype) -> dict[str, float]:
    """Least time of each build's work: q, k, v read (1, and 0), o written
    (2, and 0), 4 L^2 hd operations per pair (2 and 0)."""
    b, h, length, hd = shape
    tensor = b * h * length * hd * torch.empty((), dtype=dtype).itemsize
    ops = 4 * b * h * length * length * hd / PEAK_FLOPS[dtype] * 1e3
    per = tensor / BYTES_PER_S * 1e3
    return {"full": max(4 * per, ops), "staging": 3 * per,
            "compute": max(per, ops)}


def inputs(shape, dtype, layout, gen):
    b, h, length, hd = shape
    if layout == "fused":
        qkv = torch.randn(b, length, 3, h, hd, device="cuda", generator=gen)
        return qkv.to(dtype).permute(2, 0, 3, 1, 4).unbind(0)
    return tuple(torch.randn(shape, device="cuda", generator=gen).to(dtype)
                 for _ in range(3))


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_split: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    resolve_device("cuda")  # TF32 off: the f32 check means f32
    fns = {part: _bind(lib) for part, lib in build_parts().items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, dtype, layout in CASES:
        q, k, v = inputs(shape, dtype, layout, gen)
        _check(q, k, v)
        scale = shape[-1] ** -0.5
        out = _empty_output(q)
        if _launch(fns[0], q, k, v, out, scale):
            raise RuntimeError(f"launch failed at {shape} {dtype}")
        err = float((out.float() - reference_attention(q, k, v, scale)
                     .float()).abs().max())
        if not err <= TOL[dtype]:
            raise AssertionError(f"build 0 disagrees with the plain version "
                                 f"at {shape} {dtype} {layout}: {err}")
        ms = {name: [] for name in PARTS.values()}
        for part in (0, 1, 2, 2, 1, 0):
            fn = fns[part]
            ms[PARTS[part]].append(cuda_ms(
                lambda: _launch(fn, q, k, v, out, scale)))
        print(json.dumps({
            "shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "layout": layout, "max_abs_err": err, "ms": ms,
            "bound_ms": bounds_ms(shape, dtype),
        }), flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
