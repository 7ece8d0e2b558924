#!/usr/bin/env python3
"""Drive ribca_tpu_torch on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and the CUDA
toolkit (nvcc); it imports no JAX and nothing of ribca_tpu. Phases, each
printing one JSON line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port, from the sources in the checkout,
   with ptxas's registers and spills for the on-path instantiations;
3. kernel: each kernel against its plain PyTorch version on the card at
   the main path's shapes, both on the unbind views of a fused qkv
   projection (as the ViT calls it) and on contiguous inputs, at the
   other ViT widths' head dims, at the MAE imputer's shapes (hd 64,
   L 7-16, 12 and 8 heads), at the immune_full classifier's dispatch and
   at the edges L = 128 and L = 1 (max |diff| <= 1e-4 in f32, <= 2e-2 in
   bf16), with CUDA-event medians of the kernel, the plain version and,
   as a yardstick the port never calls, one PyTorch library call;
4. model: the immune_base ViT (width 288, depth 12) on 128 seeded patches,
   f32 on the card through the kernel vs the CPU plain path, same weights;
   then one bf16 forward at 4096 cells under torch.profiler: the top
   device operations by time, the attention kernel's share and that of
   the copy and transpose kernels, and the device's busy share;
   imputer: the immune_full MAE (768 x 12 encoder, 512 x 8 decoder) on
   128 seeded patches with one marker missing, f32, card vs CPU;
5. reference: a small slide through the whole Annotator in f32 on the card
   and on the CPU (plain versions): identical labels, close confidences;
   then the same for a two-slide batch that misses a marker (MAE
   imputation and the cohort packer);
6. end to end: the CLI's single-image annotation of a seeded synthetic
   2048 x 2048 7-channel uint16 slide with ~10,000 cells, bf16, device
   voting; checks the outputs and that every ensemble dispatch launched
   the attention kernel 12 times; repeats in f32 for the label agreement;
7. batch imputation: the CLI's batch run of three seeded 15-channel
   slides (~10,000, ~5,000 and ~2,500 cells) whose marker list misses
   CD68, so the immune_full classifier runs behind the MAE imputer;
   checks the outputs, 32 attention launches per dispatch and that the
   cohort packer dispatched the rows its rules plan; repeats in f32.

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
# the imputer at the batch path's 4096-cell dispatch: the encoder's 12
# heads over n_present + 1 tokens (15: the (3, 5) mosaic missing one
# marker; 7: the (1, 7) mosaic missing one), the decoder's 8 heads over
# n_tiles + 1 (16, 8); and the immune_full classifier (vit_l, hd 48)
BATCH_SHAPES = ((4096, 12, 15, 64), (4096, 12, 7, 64), (4096, 8, 16, 64),
                (4096, 8, 8, 64), (4096, 12, 101, 48))
# instantiations on the paths the smoke drives: L = 101 with hd 24 and
# 48, L <= 16 with hd 64, and the f32 kernel
ON_PATH = ("attention_bf16<7,3>", "attention_bf16<7,6>",
           "attention_bf16<1,8>", "attention_f32")
# a marker no panel uses: it takes CD68's place in the batch's list
NOT_A_PANEL_MARKER = "Pax5"
# the batch path's slides: (h, w, cells, seed), 15 channels each
BATCH_SLIDES = ((2048, 2048, 10_000, 10), (2048, 1024, 5_000, 11),
                (1024, 1024, 2_500, 12))


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
    if "index" in low or "gather" in low:
        return "gather / index"
    return "other elementwise"


def profile_forward(cells: int = 4096) -> dict:
    """One bf16 immune_base forward at ``cells`` patches, profiled."""
    from ribca_tpu_torch.models.params import random_vit_tree, vit_state_dict
    from ribca_tpu_torch.models.vit import build_panel_model, cast_for_compute

    model = build_panel_model("immune_base")
    model.load_state_dict(vit_state_dict(random_vit_tree(7, 5, 288, depth=12,
                                                         seed=1)))
    model = cast_for_compute(model.to("cuda").eval(), torch.bfloat16)
    x = torch.randn(cells, 7, 40, 40, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4))
    return profile_call("profile", lambda: model(x),
                        {"cells": cells, "dtype": "bfloat16",
                         "forward": "immune_base vit_s"})


def profile_call(phase: str, fn, row: dict) -> dict:
    """``fn`` (one forward or dispatch) under torch.profiler: device time
    by kernel and by kind, emitted as ``phase``. Without device time in
    the trace it reports the CUDA-event time alone."""
    from torch.profiler import ProfilerActivity, profile

    row = dict(row)
    with torch.inference_mode():
        row["forward_ms"] = cuda_ms(fn, reps=5, warmup=2)
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
        fn()
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
        emit(phase, **row)
        return row
    device_ms = sum(kernels.values())
    if device_ms <= 0:
        row["profiler"] = "the trace holds no device time"
        emit(phase, **row)
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
    emit(phase, **row)
    return row


def check_imputer(cells: int = 128) -> dict:
    """The immune_full MAE on seeded patches with CD68 missing, f32: the
    composite on the card (the kernel in all 20 blocks) against the CPU's
    (plain attention), same seeded weights."""
    from ribca_tpu_torch.models.mae import (
        ImputationPlan,
        build_imputer_model,
        impute,
    )
    from ribca_tpu_torch.models.params import mae_state_dict, random_mae_tree
    from ribca_tpu_torch.ops.attention import fused_attention
    from ribca_tpu_torch.panels.vocab import PANELS

    panel = "immune_full"
    index = [-1 if m == "CD68" else i for i, m in enumerate(PANELS[panel])]
    state = mae_state_dict(random_mae_tree(panel, seed=1))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(cells, 15, 40, 40)).astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_imputer_model(panel)
        model.load_state_dict(state)
        model = model.to(dev).eval()
        before = fused_attention.launches
        with torch.inference_mode():
            out[dev] = impute(model, ImputationPlan(panel, index, dev),
                              x.to(dev)).cpu()
        launched = fused_attention.launches - before
        if launched != (20 if dev == "cuda" else 0):
            raise AssertionError(f"{dev} imputation launched the attention "
                                 f"kernel {launched} times (want 20 on the "
                                 "card)")
    diff = float((out["cuda"] - out["cpu"]).abs().max())
    kept = [i for i, v in enumerate(index) if v != -1]
    if not (torch.isfinite(out["cuda"]).all() and diff <= 1e-4
            and torch.equal(out["cuda"][:, kept], x[:, kept])):
        raise AssertionError(f"MAE imputation on the card disagrees with "
                             f"the CPU: max |diff| {diff}")
    row = {"panel": panel, "cells": cells, "missing": ["CD68"],
           "max_abs_composite_diff": diff, "atol": 1e-4}
    emit("imputer", **row)
    return row


# -- phases 5, 6 and 7 --------------------------------------------------------


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


def write_inputs(workdir: str, name: str, markers: list, slides: list):
    """Seeded slides ((h, w, n_cells, seed) each, one channel per marker),
    their masks, the marker list and a batch CSV; returns (marker file,
    CSV, cells per slide)."""
    from PIL import Image

    from ribca_tpu_torch.io import write_tiff
    from ribca_tpu_torch.io.manifest import write_manifest

    pairs, counts = [], []
    for h, w, n_cells, seed in slides:
        img, mask = make_slide(h, w, n_cells, len(markers), seed)
        img_path = os.path.join(workdir, f"{name}_{seed}.tif")
        mask_path = os.path.join(workdir, f"{name}_mask_{seed}.png")
        write_tiff(img_path, img)
        Image.fromarray(mask.astype(np.uint16)).save(mask_path)
        pairs.append((img_path, mask_path))
        counts.append(int(len(np.unique(mask)) - 1))
    marker_file = os.path.join(workdir, f"{name}_markers.txt")
    with open(marker_file, "w") as f:
        f.write("\n".join(markers) + "\n")
    manifest = os.path.join(workdir, f"{name}.csv")
    write_manifest(pairs, manifest)
    return marker_file, manifest, counts


def write_weights(models_dir: str) -> None:
    """Seeded random classifiers (immune_base, and immune_full's vit_l) and
    MAE imputers in the reference's .pth layout: torch's default init,
    with a zero-bias, wide classifier head so that the labels split
    between classes (on the reference slide this seed gives two classes
    in about equal parts), which makes the label checks bite."""
    from ribca_tpu_torch.models.mae import build_imputer_model
    from ribca_tpu_torch.models.vit import build_panel_model

    os.makedirs(models_dir, exist_ok=True)
    for seed, panel in enumerate(("immune_base", "immune_full"), start=3):
        torch.manual_seed(seed)
        model = build_panel_model(panel)
        torch.nn.init.normal_(model.pos_embed, std=0.02)
        torch.nn.init.zeros_(model.head.bias)
        torch.nn.init.normal_(model.head.weight, std=0.5)
        torch.save({"model": model.state_dict()},
                   os.path.join(models_dir, f"{panel}.pth"))
        torch.manual_seed(seed + 10)
        torch.save({"model": build_imputer_model(panel).state_dict()},
                   os.path.join(models_dir, f"{panel}_impute.pth"))


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


def check_reference(workdir: str, models_dir: str, name: str, markers,
                    slides) -> dict:
    """The f32 Annotator on the card against the CPU on a small batch."""
    marker_file, manifest, counts = write_inputs(workdir, name, markers,
                                                 slides)
    runs = {dev: annotate(marker_file, manifest,
                          os.path.join(workdir, f"{name}_{dev}"), models_dir,
                          dev, "float32")
            for dev in ("cuda", "cpu")}
    gpu, cpu = runs["cuda"], runs["cpu"]
    conf = max(float(np.abs(g - c).max())
               for g, c in zip(gpu.confidence, cpu.confidence))
    inten = max(float(np.abs(g - c).max())
                for g, c in zip(gpu.intensity_full, cpu.intensity_full))
    same = gpu.annotations == cpu.annotations
    if not ([len(a) for a in gpu.annotations] == counts and same
            and conf <= 1e-4 and inten <= 1e-5):
        raise AssertionError(
            f"f32 Annotator on the card disagrees with the CPU ({name}): "
            f"labels equal {same}, max |conf diff| {conf}, max |intensity "
            f"diff| {inten}")
    imputing = [s.panel for s in gpu._runner.specs if s.imputer is not None]
    row = {"batch": name, "cells": counts, "imputing": imputing,
           "dispatches": gpu._runner.dispatches,
           "pad_fraction": gpu.packer.pad_fraction,
           "labels_equal": same, "max_abs_conf_diff": conf,
           "max_abs_intensity_diff": inten,
           "label_kinds": sorted({x for a in cpu.annotations for x in a})}
    emit("reference", **row)
    return row


def device_seconds(timings: dict) -> float:
    """The Annotator's device time: its per-image stages plus the cohort
    packer's last dispatch, which runs after the last image."""
    return timings["device.pipeline"] + timings["device.finalize"]


def run_end_to_end(workdir: str, models_dir: str) -> dict:
    from ribca_tpu_torch import cli
    from ribca_tpu_torch.ops.attention import fused_attention
    from ribca_tpu_torch.panels.vocab import PANELS

    t0 = time.perf_counter()
    markers, manifest, (n,) = write_inputs(
        workdir, "slide", PANELS["immune_base"], [(2048, 2048, 10_000, 0)])
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
        "cli_wall_s": wall, "cells_per_s": n / device_seconds(timings),
        "stage_s": timings,
        "label_kinds": sorted(set(ann.annotations[0])),
    }
    emit("end_to_end", dtype="bfloat16", **row)

    f32 = annotate(markers, manifest, os.path.join(workdir, "e2e_f32"),
                   models_dir, "cuda", "float32")
    agree = float(np.mean(np.asarray(f32.annotations[0])
                          == np.asarray(ann.annotations[0])))
    emit("end_to_end", dtype="float32",
         cells_per_s=n / device_seconds(f32.logger.timings),
         stage_s=f32.logger.timings, bf16_f32_label_agreement=agree)
    row["launches"] = launches
    return row


def packer_plan(counts, pack: int, chunk_cells: int):
    """(dispatches, rows) the cohort packer's rules give for images of
    ``counts`` cells, and the rows without a packer: chunks of at most
    ``pack`` cells, each image's last one at its power-of-two bucket (>= 64);
    full chunks go straight out, the others pool across images, a full
    pool goes out at ``pack`` rows and the remainder at its bucket."""
    def bucket(n, cap):
        size = 64
        while size < n and size < cap:
            size *= 2
        return min(size, cap)

    dispatches = rows = fill = solo_rows = 0
    for n in counts:
        chunk = min(pack, bucket(min(max(n, 1), chunk_cells), chunk_cells))
        for start in range(0, n, chunk):
            valid = min(chunk, n - start)
            solo_rows += bucket(valid, chunk)
            if valid == pack:
                dispatches, rows = dispatches + 1, rows + pack
                continue
            fill += valid
            while fill >= pack:
                dispatches, rows, fill = dispatches + 1, rows + pack, \
                    fill - pack
    if fill:
        dispatches, rows = dispatches + 1, rows + bucket(fill, pack)
    return dispatches, rows, solo_rows


def dispatch_split(runner, n_channels: int, cells: int = 4096) -> dict:
    """CUDA-event medians of one full ensemble dispatch of the run's
    runner on seeded patches, and of its imputer and classifier alone."""
    from ribca_tpu_torch.models.mae import impute
    from ribca_tpu_torch.ops.patches import apply_panel_gather

    (spec,) = runner.specs
    x = torch.randn(cells, n_channels, 40, 40, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6))
    dispatches = runner.dispatches
    with torch.inference_mode():
        panel_x = apply_panel_gather(x, spec.gather)
        imputed = impute(spec.imputer, spec.plan, panel_x)
        split = {
            "cells": cells,
            "dispatch": cuda_ms(lambda: runner.run_chunk(x), reps=5),
            "imputer": cuda_ms(
                lambda: impute(spec.imputer, spec.plan, panel_x), reps=5),
            "classifier": cuda_ms(lambda: spec.model(imputed), reps=5),
        }
        split["profile"] = profile_call(
            "batch_dispatch_profile", lambda: runner.run_chunk(x),
            {"cells": cells, "dtype": "bfloat16",
             "forward": "immune_full MAE + vit_l dispatch"})
    runner.dispatches = dispatches
    split["imputer_share"] = split["imputer"] / split["dispatch"]
    return split


def run_batch_imputation(workdir: str, models_dir: str) -> dict:
    """The CLI's batch run with a missing immune marker: MAE imputation in
    front of the immune_full classifier, one cohort packer for the run."""
    from ribca_tpu_torch import cli
    from ribca_tpu_torch.ops.attention import fused_attention
    from ribca_tpu_torch.panels.vocab import PANELS

    markers = [NOT_A_PANEL_MARKER if m == "CD68" else m
               for m in PANELS["immune_full"]]
    t0 = time.perf_counter()
    marker_file, manifest, counts = write_inputs(workdir, "batch", markers,
                                                 BATCH_SLIDES)
    setup_s = time.perf_counter() - t0
    main_dir = os.path.join(workdir, "batch_bf16")

    fused_attention.launches = 0
    t0 = time.perf_counter()
    ann = cli.main([
        "--marker-list-path", marker_file, "--batch-csv", manifest,
        "--batch-id", "batch", "--main-dir", main_dir,
        "--models-dir", models_dir,
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_attention.launches
    runner, packer = ann._runner, ann.packer
    dispatches = runner.dispatches
    # the CLI's default --bs 128: 4096-cell chunks, pack_cells capped there
    plan = packer_plan(counts, pack=4096, chunk_cells=4096)

    problems = []
    heads = [(s.panel, s.imputer is not None) for s in runner.specs]
    if heads != [("immune_full", True)]:
        problems.append(f"heads {heads}, want the imputing immune_full")
    results = os.path.join(main_dir, "results")
    for i, n in enumerate(counts):
        with open(os.path.join(results, f"batch_annotation_{i}.csv")) as f:
            rows = f.read().splitlines()[1:]
        confs = np.asarray([float(r.split(",")[2]) for r in rows])
        if len(rows) != n:
            problems.append(f"image {i}: CSV has {len(rows)} rows for {n} "
                            "cells")
        if np.isnan(confs).any():
            problems.append(f"image {i}: NaN confidences")
    if dispatches == 0 or launches != 32 * dispatches:
        problems.append(f"{launches} attention launches for {dispatches} "
                        "ensemble dispatches (want 32 each: 12 in the "
                        "classifier, 12 + 8 in the imputer)")
    if (dispatches, packer.dispatched_rows) != plan[:2]:
        problems.append(f"{dispatches} dispatches of "
                        f"{packer.dispatched_rows} rows, the packer's plan "
                        f"is {plan[0]} of {plan[1]}")
    if packer.valid_rows != sum(counts):
        problems.append(f"{packer.valid_rows} valid rows for "
                        f"{sum(counts)} cells")
    if problems:
        raise AssertionError("; ".join(problems))

    split = dispatch_split(runner, len(markers))
    timings = ann.logger.timings
    row = {
        "images": [[15, h, w] for h, w, _, _ in BATCH_SLIDES],
        "cells": counts,
        "dispatches": dispatches, "attention_launches": launches,
        "dispatched_rows": packer.dispatched_rows,
        "pad_fraction": packer.pad_fraction,
        "rows_without_packer": plan[2],
        "pad_fraction_without_packer": 1 - sum(counts) / plan[2],
        "slide_setup_s": setup_s, "cli_wall_s": wall,
        "cells_per_s": sum(counts) / device_seconds(timings),
        "stage_s": timings,
        "label_kinds": sorted({x for a in ann.annotations for x in a}),
        "dispatch_ms": split,
    }
    emit("batch_imputation", dtype="bfloat16", **row)

    f32 = annotate(marker_file, manifest, os.path.join(workdir, "batch_f32"),
                   models_dir, "cuda", "float32")
    agree = float(np.mean(np.concatenate(
        [np.asarray(a) == np.asarray(b)
         for a, b in zip(f32.annotations, ann.annotations)])))
    emit("batch_imputation", dtype="float32",
         cells_per_s=sum(counts) / device_seconds(f32.logger.timings),
         stage_s=f32.logger.timings, bf16_f32_label_agreement=agree)
    row["launches"] = launches
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from ribca_tpu_torch import kernels
    from ribca_tpu_torch.panels.vocab import PANELS
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
    emit("build", seconds=time.perf_counter() - t0,
         kernels=sorted(kernels.sources()),
         ptxas={k: v for k, v in usage.items() if k in ON_PATH},
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
    batch_rows = [check_attention(shape, dt, gen) for shape in BATCH_SHAPES
                  for dt in (torch.bfloat16, torch.float32)]
    torch.cuda.empty_cache()

    check_model()
    profile_forward()
    check_imputer()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=HERE) as wd:
        models_dir = os.path.join(wd, "models")
        write_weights(models_dir)
        check_reference(wd, models_dir, "ref", PANELS["immune_base"],
                        [(256, 256, 150, 3)])
        check_reference(wd, models_dir, "ref_impute",
                        [m for m in PANELS["immune_base"] if m != "CD11c"],
                        [(256, 256, 150, 4), (192, 256, 100, 5)])
        e2e = run_end_to_end(wd, models_dir)
        batch = run_batch_imputation(wd, models_dir)

    main_row, f32_row = main_rows[torch.bfloat16], main_rows[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "ribca_tpu_torch/csrc/attention.cu",
        "replaces": "ribca_tpu/ops/attention.py:80",
        "launches": batch["launches"],
        "launches_by_path": {"single_image": e2e["launches"],
                             "batch_imputation": batch["launches"]},
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "f32_ms": f32_row["ms"], "f32_bound_ms": f32_row["bound_ms"],
        "f32_max_abs_err": f32_row["max_abs_err"],
        "batch_path_shapes": [
            {k: r[k] for k in ("shape", "dtype", "max_abs_err", "ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}
            for r in batch_rows],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
