#!/usr/bin/env python3
"""Drive ribca_tpu_torch on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and the CUDA
toolkit (nvcc); it imports no JAX and nothing of ribca_tpu. Phases, each
printing one JSON line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port, from the sources in the checkout,
   with ptxas's registers and spills for the main path's instantiations;
3. kernel: each kernel against its plain PyTorch version on the card at
   the main path's shapes, both on the unbind views of a fused qkv
   projection (as the ViT calls it) and on contiguous inputs, at the
   other ViT widths' head dims, at the MAE's L = 16, hd = 64 and at the
   edges L = 128 and L = 1 (max |diff| <= 1e-4 in f32, <= 2e-2 in bf16),
   with CUDA-event medians of the kernel, the plain version and, as a
   yardstick the port never calls, one PyTorch library call;
4. model: the immune_base ViT (width 288, depth 12) on 128 seeded patches,
   f32 on the card through the kernel vs the CPU plain path, same weights;
   then one bf16 forward at 4096 cells under torch.profiler: the top
   device operations by time, the attention kernel's share and that of
   the copy and transpose kernels, and the device's busy share;
5. reference: a small slide through the whole Annotator in f32 on the card
   and on the CPU (plain versions): identical labels, close confidences;
6. end to end: the CLI's single-image annotation of a seeded synthetic
   2048 x 2048 7-channel uint16 slide with ~10,000 cells, bf16, device
   voting; checks the outputs and that every ensemble dispatch launched
   the attention kernel 12 times; repeats in f32 for the label agreement.

Then the kernel table, the card line again, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# an 8192-cell dispatch (pack_cells) of the immune_base ViT: 12 heads of
# 24 dims over 101 tokens; the CLI's default --bs 128 caps dispatches at
# 4096 cells, and a slide's last chunk drops to its power-of-two bucket
MAIN_SHAPE = (8192, 12, 101, 24)
CLI_SHAPES = ((4096, 12, 101, 24), (2048, 12, 101, 24))
# the MAE imputer's blocks (L <= 16, hd 64) and the kernel's edges
OTHER_SHAPES = ((4096, 12, 16, 64), (4096, 12, 128, 24), (4096, 12, 1, 24))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` event-timed calls."""
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


# -- phase 2 ------------------------------------------------------------------


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from the
    compiler's -Xptxas=-v lines; template arguments shown as <...>."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"attention_(?:bf16|f32)", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            name = (base.group(0) if base else mangled) + (
                f"<{','.join(args)}>" if args else "")
            usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


# -- phase 3 ------------------------------------------------------------------


def attention_bound(shape, dtype) -> tuple[float, str]:
    """Least time for the work: q, k, v read and o written once, against
    4 * L^2 * hd operations per (cell, head) at the type's peak."""
    b, h, length, hd = shape
    nbytes = 4 * b * h * length * hd * torch.empty((), dtype=dtype).itemsize
    flops = 4 * b * h * length * length * hd
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_inputs(shape, dtype, gen, layout):
    """q, k, v of (B, H, L, hd): contiguous, or the unbind views of one
    (B, L, 3, H, hd) fused projection as the ViT passes them."""
    b, h, length, hd = shape
    if layout == "fused":
        qkv = torch.randn(b, length, 3, h, hd, device="cuda", generator=gen)
        return qkv.to(dtype).permute(2, 0, 3, 1, 4).unbind(0)
    return tuple(torch.randn(shape, device="cuda", generator=gen).to(dtype)
                 for _ in range(3))


def check_attention(shape, dtype, gen, layout="fused") -> dict:
    import torch.nn.functional as F

    from ribca_tpu_torch.ops.attention import (
        fused_attention,
        reference_attention,
    )

    q, k, v = attention_inputs(shape, dtype, gen, layout)
    scale = shape[-1] ** -0.5
    out = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - reference_attention(q, k, v, scale).float()).abs()
    err = float(err.max())
    if not err <= ATTN_TOL[dtype]:
        raise AssertionError(
            f"attention kernel disagrees with its plain version at "
            f"{shape} {dtype} {layout}: max |diff| {err} > "
            f"{ATTN_TOL[dtype]}")
    bound, bound_by = attention_bound(shape, dtype)
    row = {
        "shape": list(shape), "dtype": str(dtype).split(".")[-1],
        "layout": layout,
        "max_abs_err": err, "tol": ATTN_TOL[dtype],
        "ms": cuda_ms(lambda: fused_attention(q, k, v, scale)),
        "plain_ms": cuda_ms(lambda: reference_attention(q, k, v, scale)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    emit("kernel", name="fused_attention", **row)
    return row


# -- phase 4 ------------------------------------------------------------------


def check_model() -> dict:
    from ribca_tpu_torch.models.params import random_vit_tree, vit_state_dict
    from ribca_tpu_torch.models.vit import build_panel_model
    from ribca_tpu_torch.ops.attention import fused_attention

    state = vit_state_dict(random_vit_tree(7, 5, 288, depth=12, seed=1))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(128, 7, 40, 40)).astype(np.float32))
    logits = {}
    for dev in ("cuda", "cpu"):
        model = build_panel_model("immune_base")
        model.load_state_dict(state)
        model = model.to(dev).eval()
        before = fused_attention.launches
        with torch.inference_mode():
            logits[dev] = model(x.to(dev)).cpu().numpy()
        launched = fused_attention.launches - before
        if launched != (12 if dev == "cuda" else 0):
            raise AssertionError(f"{dev} forward launched the attention "
                                 f"kernel {launched} times")
    gpu, cpu = logits["cuda"], logits["cpu"]
    diff = float(np.abs(gpu - cpu).max())
    top2 = np.sort(cpu, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 1e-4
    agree = gpu.argmax(1)[decided] == cpu.argmax(1)[decided]
    if not (np.isfinite(gpu).all() and diff <= 1e-3 and agree.all()):
        raise AssertionError(
            f"ViT on the card disagrees with the CPU: max |diff| {diff}, "
            f"{int((~agree).sum())} argmax flips")
    row = {"cells": 128, "max_abs_logit_diff": diff, "atol": 1e-3,
           "argmax_checked": int(decided.sum())}
    emit("model", **row)
    return row


def kernel_kind(name: str) -> str:
    """A coarse class of a device kernel's name, for the forward's split."""
    low = name.lower()
    if "attention_bf16" in low or "attention_f32" in low:
        return "attention kernel"
    if "copy" in low or "transpose" in low:
        return "copy / transpose"
    # before "gemm": the patch embedding's kernel is a convolve_sgemm
    if "conv" in low or "implicit" in low:
        return "convolution"
    if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul (cuBLAS)"
    if "layer_norm" in low or "layernorm" in low:
        return "layer norm"
    if "gelu" in low:
        return "gelu"
    return "other elementwise"


def profile_forward(cells: int = 4096) -> dict:
    """One bf16 immune_base forward at ``cells`` patches under
    torch.profiler: device time by kernel and by kind. Without device time
    in the trace it reports the CUDA-event time alone."""
    from torch.profiler import ProfilerActivity, profile

    from ribca_tpu_torch.models.params import random_vit_tree, vit_state_dict
    from ribca_tpu_torch.models.vit import build_panel_model, cast_for_compute

    model = build_panel_model("immune_base")
    model.load_state_dict(vit_state_dict(random_vit_tree(7, 5, 288, depth=12,
                                                         seed=1)))
    model = cast_for_compute(model.to("cuda").eval(), torch.bfloat16)
    x = torch.randn(cells, 7, 40, 40, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4))
    with torch.inference_mode():
        event_ms = cuda_ms(lambda: model(x), reps=5, warmup=2)
        row = {"cells": cells, "dtype": "bfloat16", "forward_ms": event_ms}
        # only the profiler's own calls are guarded (the trace is
        # information); the forward runs outside, so its failure stops here
        try:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        except Exception:
            prof = None
            row["profiler"] = "failed: " + traceback.format_exc()[-2000:]
        t0 = time.perf_counter()
        model(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, counts = {}, {}
    if prof is not None:
        try:
            prof.stop()
            for evt in prof.key_averages():
                if evt.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(evt, "self_device_time_total", None)
                if us is None:
                    us = evt.self_cuda_time_total
                kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
                counts[evt.key] = counts.get(evt.key, 0) + evt.count
        except Exception:
            row["profiler"] = "failed: " + traceback.format_exc()[-2000:]
    if "profiler" in row:
        emit("profile", **row)
        return row
    device_ms = sum(kernels.values())
    if device_ms <= 0:
        row["profiler"] = "the trace holds no device time"
        emit("profile", **row)
        return row
    kinds = {}
    for name, ms in kernels.items():
        kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        print(f"  {ms:9.3f} ms {100 * ms / device_ms:5.1f}% "
              f"{counts[name]:4d}x {kernel_kind(name):18s} {name[:100]}",
              flush=True)
    row.update({
        "profiled_wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "share_by_kind": {k: v / device_ms for k, v in
                          sorted(kinds.items(), key=lambda kv: -kv[1])},
        "ms_by_kind": kinds,
        "attention_share": kinds.get("attention kernel", 0.0) / device_ms,
        "copy_share": kinds.get("copy / transpose", 0.0) / device_ms,
        "top": [{"name": n[:160], "ms": ms, "launches": counts[n]}
                for n, ms in top],
    })
    emit("profile", **row)
    return row


# -- phases 5 and 6 -----------------------------------------------------------


def make_slide(h: int, w: int, n_cells: int, channels: int, seed: int):
    """Seeded disk cells on a jittered grid plus per-cell expression."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((h, w), np.int32)
    gy = int(np.ceil(np.sqrt(n_cells * h / w)))
    gx = int(np.ceil(n_cells / gy))
    step_y, step_x = h / gy, w / gx
    radius = max(2, int(min(step_y, step_x) * 0.35))
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    stamp = yy ** 2 + xx ** 2 <= radius ** 2
    cid = 0
    for iy in range(gy):
        for ix in range(gx):
            if cid == n_cells:
                break
            cy = int(np.clip((iy + 0.5) * step_y + rng.integers(-2, 3),
                             radius, h - radius - 1))
            cx = int(np.clip((ix + 0.5) * step_x + rng.integers(-2, 3),
                             radius, w - radius - 1))
            cid += 1
            win = mask[cy - radius:cy + radius + 1,
                       cx - radius:cx + radius + 1]
            win[stamp & (win == 0)] = cid
    expr = rng.uniform(0, 1, size=(cid + 1, channels)).astype(np.float32)
    expr[0] = 0
    img = rng.uniform(0, 10, size=(channels, h, w)).astype(np.float32)
    img += 200.0 * np.moveaxis(expr[mask], -1, 0)
    return img.astype(np.uint16), mask


def write_inputs(workdir: str, h: int, w: int, n_cells: int, seed: int):
    from PIL import Image

    from ribca_tpu_torch.io import write_tiff
    from ribca_tpu_torch.io.manifest import write_manifest
    from ribca_tpu_torch.panels.vocab import PANELS

    img, mask = make_slide(h, w, n_cells, 7, seed)
    img_path = os.path.join(workdir, f"slide_{h}.tif")
    mask_path = os.path.join(workdir, f"mask_{h}.png")
    write_tiff(img_path, img)
    Image.fromarray(mask.astype(np.uint16)).save(mask_path)
    markers = os.path.join(workdir, "markers.txt")
    with open(markers, "w") as f:
        f.write("\n".join(PANELS["immune_base"]) + "\n")
    manifest = os.path.join(workdir, f"images_{h}.csv")
    write_manifest([(img_path, mask_path)], manifest)
    return markers, manifest, int(len(np.unique(mask)) - 1)


def write_weights(models_dir: str) -> None:
    """Seeded random immune_base classifier in the reference's .pth layout:
    torch's default init, with a zero-bias, wide head so that the labels
    split between classes (on the reference slide this seed gives two
    classes in about equal parts), which makes the label checks bite."""
    from ribca_tpu_torch.models.vit import build_panel_model

    torch.manual_seed(3)
    model = build_panel_model("immune_base")
    torch.nn.init.normal_(model.pos_embed, std=0.02)
    torch.nn.init.zeros_(model.head.bias)
    torch.nn.init.normal_(model.head.weight, std=0.5)
    os.makedirs(models_dir, exist_ok=True)
    torch.save({"model": model.state_dict()},
               os.path.join(models_dir, "immune_base.pth"))


def annotate(markers, manifest, main_dir, models_dir, device, dtype):
    from ribca_tpu_torch.api.annotator import Annotator
    from ribca_tpu_torch.utils.config import AnnotatorConfig

    ann = Annotator(AnnotatorConfig(
        marker_file=markers, csv_file=manifest, main_dir=main_dir,
        batch_id="ref", device=device, dtype=dtype,
        allow_random_weights=False, models_dir=models_dir))
    ann.preprocess()
    ann.predict()
    return ann


def check_reference(workdir: str, models_dir: str) -> dict:
    markers, manifest, n = write_inputs(workdir, 256, 256, 150, seed=3)
    runs = {dev: annotate(markers, manifest,
                          os.path.join(workdir, f"ref_{dev}"), models_dir,
                          dev, "float32")
            for dev in ("cuda", "cpu")}
    gpu, cpu = runs["cuda"], runs["cpu"]
    conf = float(np.abs(gpu.confidence[0] - cpu.confidence[0]).max())
    inten = float(np.abs(gpu.intensity_full[0]
                         - cpu.intensity_full[0]).max())
    same = gpu.annotations == cpu.annotations
    if not (len(gpu.annotations[0]) == n and same and conf <= 1e-4
            and inten <= 1e-5):
        raise AssertionError(
            f"f32 Annotator on the card disagrees with the CPU: labels "
            f"equal {same}, max |conf diff| {conf}, max |intensity diff| "
            f"{inten}")
    row = {"cells": n, "labels_equal": same, "max_abs_conf_diff": conf,
           "max_abs_intensity_diff": inten,
           "label_kinds": sorted(set(cpu.annotations[0]))}
    emit("reference", **row)
    return row


def run_end_to_end(workdir: str, models_dir: str) -> dict:
    from ribca_tpu_torch import cli
    from ribca_tpu_torch.ops.attention import fused_attention

    t0 = time.perf_counter()
    markers, manifest, n = write_inputs(workdir, 2048, 2048, 10_000, seed=0)
    setup_s = time.perf_counter() - t0
    main_dir = os.path.join(workdir, "e2e_bf16")

    fused_attention.launches = 0
    t0 = time.perf_counter()
    ann = cli.main([
        "--marker-list-path", markers, "--batch-csv", manifest,
        "--batch-id", "smoke", "--main-dir", main_dir,
        "--models-dir", models_dir,
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_attention.launches
    dispatches = ann._runner.dispatches

    results = os.path.join(main_dir, "results")
    with open(os.path.join(results, "smoke_annotation_0.csv")) as f:
        rows = f.read().splitlines()[1:]
    confs = np.asarray([float(r.split(",")[2]) for r in rows])
    missing = [p for p in ("smoke_colorized_annotation_0.png",
                           "smoke_confidence_0.png", "cell_color_legend.png")
               if not os.path.exists(os.path.join(results, p))]
    problems = []
    if len(rows) != n:
        problems.append(f"CSV has {len(rows)} rows for {n} cells")
    if missing:
        problems.append(f"missing outputs {missing}")
    if np.isnan(confs).any():
        problems.append("NaN confidences")
    if dispatches == 0 or launches != 12 * dispatches:
        problems.append(f"{launches} attention launches for {dispatches} "
                        "ensemble dispatches (want 12 each)")
    if problems:
        raise AssertionError("; ".join(problems))

    timings = ann.logger.timings
    row = {
        "image": [7, 2048, 2048], "cells": n, "dispatches": dispatches,
        "attention_launches": launches, "slide_setup_s": setup_s,
        "cli_wall_s": wall,
        "cells_per_s": n / timings["device.pipeline"],
        "stage_s": timings,
        "label_kinds": sorted(set(ann.annotations[0])),
    }
    emit("end_to_end", dtype="bfloat16", **row)

    f32 = annotate(markers, manifest, os.path.join(workdir, "e2e_f32"),
                   models_dir, "cuda", "float32")
    agree = float(np.mean(np.asarray(f32.annotations[0])
                          == np.asarray(ann.annotations[0])))
    emit("end_to_end", dtype="float32",
         cells_per_s=n / f32.logger.timings["device.pipeline"],
         stage_s=f32.logger.timings, bf16_f32_label_agreement=agree)
    row["launches"] = launches
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from ribca_tpu_torch import kernels
    from ribca_tpu_torch.utils.device import resolve_device

    card = card_line()
    print(card, flush=True)
    resolve_device("cuda")  # TF32 off: f32 checks mean f32
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = kernels.build_all(force=True)
    usage = ptxas_usage(logs["attention"])
    # the main path's instantiations: L = 101 (7 row tiles), hd = 24 (3)
    emit("build", seconds=time.perf_counter() - t0,
         kernels=sorted(kernels.sources()),
         ptxas={k: v for k, v in usage.items()
                if k in ("attention_bf16<7,3>", "attention_f32")},
         instantiations=len(usage),
         max_registers=max(v.get("registers", 0) for v in usage.values()),
         spilling=sorted(k for k, v in usage.items()
                         if v.get("spill_stores", 0) > 0))

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_rows = {dt: check_attention(MAIN_SHAPE, dt, gen)
                 for dt in (torch.bfloat16, torch.float32)}
    for dt in (torch.bfloat16, torch.float32):
        check_attention(MAIN_SHAPE, dt, gen, layout="contiguous")
    for shape in CLI_SHAPES:
        check_attention(shape, torch.bfloat16, gen)
        check_attention(shape, torch.bfloat16, gen, layout="contiguous")
    for hd in (12, 32, 48):
        for dt in (torch.bfloat16, torch.float32):
            check_attention((1024, 12, 101, hd), dt, gen)
    for shape in OTHER_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            check_attention(shape, dt, gen)
    torch.cuda.empty_cache()

    check_model()
    profile_forward()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=HERE) as wd:
        models_dir = os.path.join(wd, "models")
        write_weights(models_dir)
        check_reference(wd, models_dir)
        e2e = run_end_to_end(wd, models_dir)

    main_row, f32_row = main_rows[torch.bfloat16], main_rows[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "ribca_tpu_torch/csrc/attention.cu",
        "replaces": "ribca_tpu/ops/attention.py:80",
        "launches": e2e["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "f32_ms": f32_row["ms"], "f32_bound_ms": f32_row["bound_ms"],
        "f32_max_abs_err": f32_row["max_abs_err"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
