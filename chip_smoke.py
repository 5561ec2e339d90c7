#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (umpr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Print the card's name and power limit; build every CUDA kernel of the
   port (K1-K9) from the sources in the checkout (one nvcc per source, in
   parallel) and print the build time and ptxas report.
2. Hold each kernel against its plain PyTorch version and time the
   kernel, the plain version and one PyTorch library call (yardstick only:
   the port never calls it): K1 and K2 (the bi-GRU forward), K3 and K4
   (its backward) and K9 (its input gradient) at the UMPR-R shapes
   (N=2560 sentence rows, L=20, E=50, H=64, f32; lengths 1..20); K5 and
   K6 (the fused bias + ReLU + 2x2 pool and its backward) at the three
   VGG16 blocks they close at B=64, 224 px, bit for bit; K7 and K8 (the
   affinity attention) at the long-history shape (B=64, P=8192, D=128)
   and at B10's (P=400), on saturated inputs where every max is a tie,
   and on NaN inputs; K8 also timed at B=8, P=8192.  K2's time by kernel
   (row order, recurrence) and K3's (hg pass, row order, sweep, dW pass,
   reduce) beside their bounds.  K1-K4 and K9 also at H = 8, 100 and 256
   (other --gru_size values; K2 and K3's L2 routes at 256), each launched
   twice for the same bits; K2 and K3 at the long-history 1,048,576 rows
   (K2 timed there beside its bound); K9 past the old grid cap of
   4,194,240 rows; K7/K8 at D = 16, 200 and 512 and a ragged P.
3. Serve UMPR-R at the reference widths (B=64, S=L=20, E=50, H=64) from a
   seeded synthetic corpus and a seeded checkpoint: HTTP /predict requests
   through make_http_server, one CSV-mode pass through serve.main, and the
   same rows on the CPU with the plain versions.  Launch counts show the
   requests went through K1 and K2.
4. Train UMPR-R at the same widths through ``umpr_tpu_torch.main.main``
   (2 epochs over a seeded train/valid/test corpus, Adam at lr 1e-3, an
   evaluation every 2 batches, then the test pass).  Launch counts show
   every train step went through K1-K4 and every evaluation batch through
   K1 and K2; the loss is finite and the GRU weights and M moved; one
   step's gradients and the first validation MSE agree with the CPU
   (plain versions).  Then the ms per train step (CUDA events) and a
   torch.profiler breakdown of train steps.
5. Train full UMPR (``--review_net_only False --vgg_fused_pool True``,
   224 px photos) the same way.  This machine has no JPEG decoder, so
   the photos come from a seeded uint8 source keyed by file name (the
   script says so).  Launch counts show every train step went through
   K1-K4 three times (R-Net and C-Net's two calls) and K5/K6 once per
   closed VGG block, every evaluation batch through K1, K2 and K5; the
   loss is finite; the fused blocks' biases and C-Net's GRU moved; on 8
   rows with dropout off, the card's predictions and gradients agree with
   the CPU's.  Then the ms per train step and a profiler breakdown.
   The train step is timed with cuDNN's deterministic algorithms (as the
   Trainer sets them) and without, in turns.
5b. Serve full UMPR at 224 px (B=64, ``--vgg_fused_pool True``) from a
   seeded checkpoint with the resident photo bank: HTTP requests (each
   one's wall time, its K1/K2/K5 launches, the photos it decoded: the
   bank decodes each photo once), a CSV pass, the bank against streaming
   photos (``--device_dataset off``: the same bits), CPU_ROWS rows
   against a CPU Predictor, and the host and device ms per batch.
6. A gradient through ``bigru_split`` with x requiring grad at the UMPR-R
   shapes, card (K1-K4, K9) against CPU.
7. Long-history UMPR-R (``--max_sent_count 128 --max_sent_length 64``,
   P = 8192; every batch of the corpus reaches both maxima): serving as in
   3, with K7/K8 once per batch (above 4 GiB of (B, P, P) f32) and 4 rows
   held against a CPU Predictor of batch 4, which takes the composite
   attention; training as in 4, with K7/K8 in every train step and
   evaluation batch and one step's gradients against the CPU's.
8. UMPR-R training at ``--gru_size 100`` as in 4 (K2 with a ragged block,
   K3 at a width off the 64-multiples, K9-free: the embedding is frozen),
   launch counts and one step's gradients against the CPU.
9. Resume, for UMPR-R, full UMPR (224 px) and long-history UMPR-R: an
   uninterrupted 2-epoch run, a run with ``--save_every_batches 2``
   stopped after 3 steps, and that run resumed with ``--resume_path``;
   the resumed run must end with the uninterrupted run's bits
   (parameters, Adam's state, best/ and last/, the logged values after
   the resume point).
10. Print each phase's seconds, a ``{"resume_bit_equal": ...}`` line, and
   a ``{"kernels": [...]}`` line (launches: each kernel's main path -- the
   full-UMPR run for K1-K6, the long-history training for K7/K8, the
   input-gradient run for K9 -- and the other runs' beside them), then,
   as the last line, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero without the last line.  Without a
CUDA device the script exits 2.  Work files go to build/chip_smoke/ in
the checkout.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from umpr_tpu_torch import main as train_main
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import adam_to_jax
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.data.loader import BatchLoader, to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.models.visual_net import FUSED_POOL_MIN_H
from umpr_tpu_torch.ops import _build, attention, attention_cuda, gru_cuda, pool_cuda
from umpr_tpu_torch.ops.gru import BiGRU, bigru_split
from umpr_tpu_torch import serve
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.step import evaluate_mse, train_step

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FMA (non-tensor
# core) FLOP/s and dense TF32 tensor-core FLOP/s, at the full 700 W power
# limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

K1_TOL = 1e-5  # f32 sums of 50 products in another order
K2_TOL = 1e-5  # masked GRU tolerance of PARITY.md, f32 over 20 steps
E2E_TOL = 1e-4  # full forward tolerance of PARITY.md, card vs CPU
K3_DXG_TOL = 1e-5  # per-step gate grads: the masked-GRU tolerance
# dW and db are sums over all N*L = 51,200 rows (K3: 16-row tiles, K4:
# 1,024-row chunks), added in another order than the plain version's: f32
# rounding grows with the count, so they are held relative to their largest
# entry instead
SUM_RTOL = 1e-4
GRAD_RTOL = 1e-3  # gradient tolerance of PARITY.md, card vs CPU
GRAD_FLIP_FACTOR = 3  # VGG16 gradients: the card's distance from f64 over the
                      # CPU's, where f32 ReLU/max-pool decisions flip
MIN_SPREAD = 1e-3  # std of the served predictions: 10x E2E_TOL, so the
                   # card-vs-CPU check sees real, varied outputs
# the seeded checkpoint: with seed 0 the ReLU head's input is positive on
# this corpus, so predictions are not clamped to a constant 0
CKPT_SEED = 0


def write_corpus(root, seed=0, shards=3, users=12, items=12, per_user=8,
                 vocab=2000, dim=50, sent_tokens=(4, 26), review_sents=(2, 8)):
    """A seeded synthetic corpus in the training-CSV schema with enough
    history to fill S=L=20: `shards` groups of users and items that never
    meet, so each shard is a self-contained request.  A sentence has
    `sent_tokens` [low, high) words and a review `review_sents` [low, high)
    sentences.  Writes glove.txt (`vocab` words, `dim`-d), reviews.csv and
    photos.json (one item lacks a photo, so its rows are unscorable).
    Returns (glove path, csv path, list of row-index arrays per shard)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    vecs = rng.standard_normal((vocab, dim)).astype(np.float32) * 0.4
    with open(root / "glove.txt", "w") as f:
        for w, v in zip(words, vecs):
            f.write(w + " " + " ".join(f"{x:.6f}" for x in v) + "\n")

    def sentence():
        toks = list(rng.choice(words, size=rng.integers(*sent_tokens)))
        if rng.random() < 0.3:
            toks[rng.integers(len(toks))] = str(rng.integers(0, 1000))  # <NUM>
        if rng.random() < 0.3:
            toks[rng.integers(len(toks))] = "oov"  # <UNK>
        return " ".join(toks)

    rows, shard_rows, item_ids = [], [], []
    for s in range(shards):
        start = len(rows)
        for u in range(users):
            for it in rng.choice(items, size=per_user, replace=False):
                review = ". ".join(sentence() for _ in range(rng.integers(*review_sents))) + "."
                rows.append({"userID": f"U{s}_{u}", "itemID": f"I{s}_{it}",
                             "review": review, "rating": float(rng.integers(1, 6))})
        shard_rows.append(np.arange(start, len(rows)))
        item_ids += [f"I{s}_{it}" for it in range(items)]
    df = pd.DataFrame(rows)
    df["user_num"] = pd.factorize(df["userID"])[0]
    df["item_num"] = pd.factorize(df["itemID"])[0]
    df.to_csv(root / "reviews.csv", index=False)
    with open(root / "photos.json", "w") as f:
        for it in item_ids[1:]:  # item_ids[0] has no photo
            f.write(json.dumps({"business_id": it, "photo_id": f"p_{it}"}) + "\n")
    return root / "glove.txt", root / "reviews.csv", shard_rows


def write_splits(root, seed=1, shards=5, **kw):
    """write_corpus, then its shards split into train.csv (all but the last
    two shards), valid.csv and test.csv (one shard each): the files
    ``--data_dir`` names for training.  Shards share no user or item, so
    each split holds every history its samples need.  Returns the glove
    path."""
    glove, csv, shard_rows = write_corpus(root, seed=seed, shards=shards, **kw)
    df = pd.read_csv(csv)
    for name, rows in (("train", np.concatenate(shard_rows[:-2])),
                       ("valid", shard_rows[-2]), ("test", shard_rows[-1])):
        df.iloc[rows].to_csv(Path(root) / f"{name}.csv", index=False)
    return glove


def time_cuda(fn, iters=20, warmup=3):
    """Mean ms per call over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn, steps):
    """fn once to warm up, then `steps` calls under torch.profiler: (the
    kernels' key averages, host wall ms per call, all key averages).
    Device-side kernel events only: the CPU ops that launched them carry
    the same time again, and a user annotation's device span (the
    optimizer's "Optimizer.step#...") covers kernels counted already."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    # the tracer is already running through one traced-and-dropped call
    # when the window opens, so a short window's first launches are not
    # lost to its start-up (the step breakdowns count every K7 launch);
    # a window of one-kernel calls still loses one (see device_ms)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(steps):
            fn()
            if i == steps - 1:  # the window closes at this step(): all of it done
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / steps
            prof.step()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    return kernels, wall_ms, events


def device_split(fn, steps=20):
    """{kernel name: device ms per call} of fn under torch.profiler, {}
    where it recorded no device time.

    Each kernel counts its mean duration times its launches per call, its
    count over the window / `steps` rounded: every call of fn launches the
    same kernels, and a window of calls that launch one kernel each loses
    one launch's record (K7 timed 5 times read as 4 launches' time), which
    a total / `steps` would count as time the kernel did not take."""
    kernels, _, _ = profile_device(fn, steps)
    return {e.key: e.self_device_time_total / e.count / 1e3 * max(1, round(e.count / steps))
            for e in kernels}


def device_ms(fn, steps=20):
    """Device time per call of fn: its kernels' time under torch.profiler
    (``device_split`` summed), without the host's share that time_cuda's
    back-to-back calls may measure.  None where the profiler recorded no
    device time."""
    split = device_split(fn, steps)
    return sum(split.values()) if split else None


# K2's and K3's kernels by part, as csrc/bigru_*.cu* and csrc/row_order.cuh
# name them
K2_PARTS = (("row order", ("bigru_row_order",)),
            ("recurrence", ("bigru_recurrence_kernel", "bigru_recurrence_wide")))
K3_PARTS = (("hg pass", ("bigru_backward_hg",)), ("row order", ("bigru_row_order",)),
            ("sweep", ("bigru_backward_sweep", "bigru_backward_wide")),
            ("dW pass", ("bigru_backward_dw",)), ("reduce", ("bigru_backward_reduce",)))


def part_split(fn, parts, steps=10):
    """A kernel's device ms per call by part (K2_PARTS: row order,
    recurrence; K3_PARTS: hg pass, row order, sweep, dW pass, reduce);
    None for a part the profiler did not see."""
    split = device_split(fn, steps)
    out = {}
    for part, kernels in parts:
        ms = [t for name, t in split.items()
              if any(re.search(rf"\b{k}\s*[(<]", name) for k in kernels)]
        out[part] = sum(ms) if ms else None
    return out


def k2_bound(lengths, y_numel, H):
    """K2's bound at this run's lengths: both directions read xg only at
    valid steps and do one (H x 3H) product per valid step; y is written
    in full."""
    valid = int(lengths.sum())
    return bound(4 * (2 * valid * 3 * H + y_numel + 2 * H * 3 * H + 2 * 3 * H
                      + lengths.numel()),
                 2 * valid * 2 * H * 3 * H)


def k2_check(xg, lengths, w_hh, b_hh, where=""):
    """K2 against its plain version, exact zeros past each length and the
    same bits on a second launch; raises where one fails.  Returns (y, max
    abs error)."""
    y = gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (y - gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)).abs().max().item()
    past = torch.arange(xg.shape[1], device=xg.device)[None, :] >= lengths[:, None]
    zeros = bool((y[past] == 0).all())
    same = torch.equal(gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh), y)
    print(f"K2 bigru_recurrence{where}: max|kernel - plain| = {err:.3e} (tolerance "
          f"{K2_TOL:.0e}); zeros past each length {zeros}; second launch same bits {same}")
    if not (err <= K2_TOL and zeros and same):
        raise AssertionError(f"K2 disagrees with its plain version{where}")
    return y, err


def k3_bound(lengths, H, dxg_numel):
    """K3's bound at this run's lengths, both accountings: each direction
    reads xg, h_prev (y) and both cotangents only at valid steps, dxg is
    written in full, and three (H x 3H) products run per valid step and
    direction.  "bound_ms": the hg and dW products as 3xTF32 at the TF32
    tensor-core rate (three products each), the sweep's ghh @ W^T in f32;
    "bound_ms_f32": all three in f32 (PR 6's yardstick)."""
    valid = int(lengths.sum())
    n_bytes = 4 * (2 * valid * (3 * H + H + 2 * H) + dxg_numel + 2 * 2 * H * 3 * H
                   + 2 * 2 * 3 * H + lengths.numel())
    product = 2 * valid * 2 * H * 3 * H  # one (H x 3H) product, both directions
    t_bound, by = bound(n_bytes, product, tf32_flops=3 * 2 * product)
    t_f32, by_f32 = bound(n_bytes, 3 * product)
    return {"bound_ms": t_bound, "bound_by": by, "bound_ms_f32": t_f32,
            "bound_by_f32": by_f32,
            "bound_accounting": "bytes: xg, y, dy_sent, dy_pos at valid steps, dxg "
                                "written in full; operations: hg and dW products "
                                "3xTF32 at the TF32 rate, the sweep's in f32 "
                                "(bound_ms_f32: all three in f32)"}


def print_split(kernel, parts):
    print(f"{kernel} by kernel (device ms per call): "
          + ", ".join(f"{part} {_ms(ms)}" for part, ms in parts.items()))


def timed(kernel, plain, library, iters=20, plain_iters=20, lib_iters=20):
    """The timing keys of a kernel row: ms, plain_ms and library_ms (CUDA
    events over back-to-back calls), device_ms and library_device_ms
    (torch.profiler); library None where no one PyTorch call computes the
    same function."""
    out = {"ms": time_cuda(kernel, iters=iters),
           "plain_ms": time_cuda(plain, iters=plain_iters, warmup=3 if plain_iters >= 5 else 1),
           "device_ms": device_ms(kernel, steps=iters),
           "library_ms": None, "library_device_ms": None}
    if library is not None:
        out["library_ms"] = time_cuda(library, iters=lib_iters)
        out["library_device_ms"] = device_ms(library, steps=lib_iters)
    return out


def _ms(v):
    return "not measured" if v is None else f"{v:.4f}"


def bound(n_bytes, flops, tf32_flops=0):
    """Least time on the card in ms, and what sets it: `flops` f32
    operations on the CUDA cores, `tf32_flops` TF32 products on the tensor
    cores (3xTF32 counts its three)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / F32_FLOP_PER_S + tf32_flops / TF32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(device, N=2560, L=20, E=50, H=64):
    """Each kernel against its plain version at the UMPR-R shapes."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(N, L, E, generator=g) * 0.5).to(device)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    lengths[0], lengths[1] = 1, L
    lengths = lengths.to(device)
    gru = BiGRU(E, H, generator=g).to(device)
    w_ih, b_ih, w_hh, b_hh = gru.kernel_operands()
    x2 = x.reshape(N * L, E)
    rows = []

    xg = gru_cuda.gru_input_proj(x2, w_ih, b_ih)
    torch.cuda.synchronize()
    err = (xg - gru_cuda.gru_input_proj_ref(x2, w_ih, b_ih)).abs().max().item()
    same = torch.equal(gru_cuda.gru_input_proj(x2, w_ih, b_ih), xg)
    print(f"K1 gru_input_proj: max|kernel - plain| = {err:.3e} (tolerance {K1_TOL:.0e}); "
          f"second launch same bits {same}")
    if not (err <= K1_TOL and same):
        raise AssertionError("K1 disagrees with its plain version")
    # 3xTF32 products on the tensor cores, the bias adds on the CUDA cores
    M = x2.shape[0]
    t_bound, by = bound(4 * (x2.numel() + w_ih.numel() + b_ih.numel() + xg.numel()),
                        M * 6 * H, tf32_flops=3 * 2 * M * E * 6 * H)
    rows.append({
        "name": "gru_input_proj", "route": "cuda",
        "source": "umpr_tpu_torch/csrc/gru_input_proj.cu",
        "replaces": "umpr_tpu/ops/gru_pallas.py:319",
        "also_replaces": ["umpr_tpu/ops/gru_pallas.py:541"],
        "max_abs_err": err,
        **timed(lambda: gru_cuda.gru_input_proj(x2, w_ih, b_ih),
                lambda: gru_cuda.gru_input_proj_ref(x2, w_ih, b_ih),
                lambda: torch.addmm(b_ih, x2, w_ih)),
        "bound_ms": t_bound, "bound_by": by,
        "library_call": "torch.addmm"})

    xg = xg.view(N, L, 6 * H)
    y, err = k2_check(xg, lengths, w_hh, b_hh)
    # yardstick: cuDNN's bidirectional GRU over a packed batch (it projects
    # the input too); it also checks the masking semantics end to end
    lib = torch.nn.GRU(E, H, batch_first=True, bidirectional=True).to(device)
    lib.load_state_dict(gru.state_dict())
    lengths_cpu = lengths.cpu()
    pack = torch.nn.utils.rnn.pack_padded_sequence

    def library():
        return lib(pack(x, lengths_cpu, batch_first=True, enforce_sorted=False))[0]

    y_lib = torch.nn.utils.rnn.pad_packed_sequence(
        library(), batch_first=True, total_length=L)[0]
    print(f"K1+K2 vs cuDNN packed GRU: max abs diff {(y - y_lib).abs().max().item():.3e}")
    t_bound, by = k2_bound(lengths, y.numel(), H)
    k2 = lambda: gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)  # noqa: E731
    k2_parts = part_split(k2, K2_PARTS)
    print_split("K2 bigru_recurrence", k2_parts)
    rows.append({
        "name": "bigru_recurrence", "route": "cuda",
        "source": "umpr_tpu_torch/csrc/bigru_recurrence.cu",
        "replaces": "umpr_tpu/ops/gru_pallas.py:205",
        "also_replaces": ["umpr_tpu/ops/gru_pallas.py:463"],
        "max_abs_err": err,
        **timed(k2, lambda: gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh), library,
                plain_iters=5),
        "bound_ms": t_bound, "bound_by": by, "device_ms_by_kernel": k2_parts,
        "library_call": "torch.nn.GRU(bidirectional) on pack_padded_sequence"})
    rows += backward_kernel_phase(x, xg, y, lengths, gru, lib)
    for r in rows:
        print_row(r)
    return rows


def print_row(r, where=""):
    """A kernel row's times: CUDA events over back-to-back calls (ms) and
    the profiler's device time (device_ms), beside the bound."""
    share = (f", device time at {r['bound_ms'] / r['device_ms']:.1%} of the bound"
             if r["device_ms"] else "")
    print(f"{r['name']}{where}: {r['ms']:.4f} ms, device {_ms(r['device_ms'])} ms (plain "
          f"{r['plain_ms']:.4f}; {r['library_call']} {_ms(r['library_ms'])}, device "
          f"{_ms(r['library_device_ms'])}); bound {r['bound_ms']:.4f} by "
          f"{r['bound_by']}{share}")


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def backward_kernel_phase(x, xg, y, lengths, gru, lib, S=20):
    """K3 and K4 against their plain versions on K1/K2's outputs, with
    seeded cotangents for y_sent (N, L, 2H) and y_pos (N/S, S*L, 2H)."""
    N, L, E = x.shape
    H = gru.hidden
    _, _, w_hh, b_hh = gru.kernel_operands()
    g = torch.Generator().manual_seed(1)
    dy_sent = torch.randn(N, L, 2 * H, generator=g).to(x.device)
    dy_pos = torch.randn(N // S, S * L, 2 * H, generator=g).to(x.device)
    rows = []

    dxg, dw_hh, db_hh = gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths,
                                                 w_hh, b_hh)
    torch.cuda.synchronize()
    ref = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    err = (dxg - ref[0]).abs().max().item()
    rel = max(_rel_err(dw_hh, ref[1]), _rel_err(db_hh, ref[2]))
    print(f"K3 bigru_backward: dxg max|kernel - plain| = {err:.3e} (tolerance "
          f"{K3_DXG_TOL:.0e}); dW_hh, db_hh max relative {rel:.3e} (tolerance "
          f"{SUM_RTOL:.0e})")
    if not (err <= K3_DXG_TOL and rel <= SUM_RTOL):
        raise AssertionError("K3 disagrees with its plain version")
    again = gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    if not all(torch.equal(a, b) for a, b in zip(again, (dxg, dw_hh, db_hh))):
        raise AssertionError("K3 gave other bits on a second run")

    x2 = x.reshape(N * L, E)
    dxg2 = dxg.view(N * L, 6 * H)
    dw_ih, db_ih = gru_cuda.gru_input_proj_bwd(x2, dxg2)
    torch.cuda.synchronize()
    ref4 = gru_cuda.gru_input_proj_bwd_ref(x2, dxg2)
    err4 = max((dw_ih - ref4[0]).abs().max().item(),
               (db_ih - ref4[1]).abs().max().item())
    rel4 = max(_rel_err(dw_ih, ref4[0]), _rel_err(db_ih, ref4[1]))
    same4 = all(torch.equal(a, b) for a, b in zip(gru_cuda.gru_input_proj_bwd(x2, dxg2),
                                                  (dw_ih, db_ih)))
    print(f"K4 gru_input_proj_bwd: max|kernel - plain| = {err4:.3e}, relative "
          f"{rel4:.3e} (tolerance {SUM_RTOL:.0e}); second launch same bits {same4}")
    if not (rel4 <= SUM_RTOL and same4):
        raise AssertionError("K4 disagrees with its plain version")

    # yardstick: cuDNN's packed bidirectional GRU, gradient of its weights
    # for the same cotangent (dy_sent + dy_pos), the projection's included;
    # it also checks K3+K4's gradients against an independent backward
    lengths_cpu = lengths.cpu()
    pack = torch.nn.utils.rnn.pack_padded_sequence
    with torch.enable_grad():
        out = lib(pack(x, lengths_cpu, batch_first=True, enforce_sorted=False))[0]
        dy_packed = pack(dy_sent + dy_pos.view(N, L, 2 * H), lengths_cpu,
                         batch_first=True, enforce_sorted=False).data
        params = list(lib.parameters())

        def library():
            return torch.autograd.grad(out.data, params, dy_packed, retain_graph=True)

        lib_grads = dict(zip((n for n, _ in lib.named_parameters()), library()))
        ours = {}
        for d, sfx in ((0, ""), (1, "_reverse")):
            ours["weight_ih_l0" + sfx] = dw_ih[:, 3 * H * d:3 * H * (d + 1)].t()
            ours["bias_ih_l0" + sfx] = db_ih[3 * H * d:3 * H * (d + 1)]
            ours["weight_hh_l0" + sfx] = dw_hh[d].t()
            ours["bias_hh_l0" + sfx] = db_hh[d]
        cudnn_rel = max(_rel_err(ours[n], lib_grads[n]) for n in ours)
        print(f"K3+K4 vs cuDNN packed GRU weight gradients: max relative diff "
              f"{cudnn_rel:.3e}")
        lib_ms, lib_device_ms = time_cuda(library), device_ms(library)

    k3 = lambda: gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh,  # noqa: E731
                                         b_hh)
    parts = part_split(k3, K3_PARTS)
    print_split("K3 bigru_backward", parts)
    rows.append({
        "name": "bigru_backward", "route": "cuda",
        "source": "umpr_tpu_torch/csrc/bigru_backward.cu",
        "replaces": "umpr_tpu/ops/gru_pallas.py:698",
        "also_replaces": ["umpr_tpu/ops/gru_pallas.py:501"],
        "max_abs_err": err, "max_rel_err_dw_db": rel,
        **timed(k3, lambda: gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh,
                                                        b_hh), None, plain_iters=3),
        "library_ms": lib_ms, "library_device_ms": lib_device_ms,
        **k3_bound(lengths, H, dxg.numel()),
        "device_ms_by_kernel": parts,
        "partials": gru_cuda.bwd_chunks(N * L)[1],
        "library_call": "torch.autograd.grad of nn.GRU(bidirectional) on "
                        "pack_padded_sequence w.r.t. its weights (projection "
                        "backward included)"})
    M = N * L
    # 3xTF32 products on the tensor cores, db's adds on the CUDA cores
    t_bound, by = bound(4 * (x2.numel() + dxg2.numel() + dw_ih.numel() + db_ih.numel()),
                        M * 6 * H, tf32_flops=3 * 2 * M * E * 6 * H)
    rows.append({
        "name": "gru_input_proj_bwd", "route": "cuda",
        "source": "umpr_tpu_torch/csrc/gru_input_proj_bwd.cu",
        "replaces": "umpr_tpu/ops/gru_pallas.py:394",
        "max_abs_err": err4, "max_rel_err": rel4,
        **timed(lambda: gru_cuda.gru_input_proj_bwd(x2, dxg2),
                lambda: gru_cuda.gru_input_proj_bwd_ref(x2, dxg2),
                lambda: (x2.t() @ dxg2, dxg2.sum(0))),
        "bound_ms": t_bound, "bound_by": by,
        "partials": gru_cuda.proj_bwd_chunks(M)[1],
        "library_call": "x.T @ dxg and dxg.sum(0)"})
    return rows


K9_TOL = 1e-5  # dx: f32 sums of 6H = 384 products in another order, against its largest entry


def input_grad_kernel_phase(device, M=51200, E=50, H=64):
    """K9 against its plain version at the UMPR-R shapes (N*L = 51,200
    rows, 6H = 384, E = 50)."""
    g = torch.Generator(device=device).manual_seed(7)
    dxg = torch.randn(M, 6 * H, generator=g, device=device)
    w = torch.randn(E, 6 * H, generator=g, device=device) / (6 * H) ** 0.5
    dx = gru_cuda.gru_input_proj_dx(dxg, w)
    torch.cuda.synchronize()
    ref = gru_cuda.gru_input_proj_dx_ref(dxg, w)
    err, rel = (dx - ref).abs().max().item(), _rel_err(dx, ref)
    same = torch.equal(gru_cuda.gru_input_proj_dx(dxg, w), dx)
    print(f"K9 gru_input_proj_dx: max|kernel - plain| = {err:.3e}, relative {rel:.3e} "
          f"(tolerance {K9_TOL:.0e}); second launch same bits {same}")
    if not (rel <= K9_TOL and same):
        raise AssertionError("K9 disagrees with its plain version")
    # 3xTF32 products on the tensor cores, the two chains' adds on the CUDA cores
    t_bound, by = bound(4 * (dxg.numel() + w.numel() + dx.numel()), M * E,
                        tf32_flops=3 * 2 * M * 6 * H * E)
    row = {
        "name": "gru_input_proj_dx", "route": "cuda",
        "source": "umpr_tpu_torch/csrc/gru_input_proj_dx.cu",
        "replaces": "umpr_tpu/ops/gru_pallas.py:394",
        "replaces_branch": "emit_dxc=True",
        "max_abs_err": err, "max_rel_err": rel,
        **timed(lambda: gru_cuda.gru_input_proj_dx(dxg, w),
                lambda: gru_cuda.gru_input_proj_dx_ref(dxg, w),
                lambda: torch.mm(dxg, w.t())),
        "bound_ms": t_bound, "bound_by": by,
        "library_call": "torch.mm(dxg, w_ih.t())"}
    print_row(row)
    del dxg, dx, ref
    row["past_old_grid_cap"] = input_grad_past_cap(device, E, H)
    return [row]


K9_OLD_CAP = 65535 * 64  # rows: the grid cap of the SGEMM K9 replaced


def input_grad_past_cap(device, E=50, H=64):
    """K9 past the old kernel's grid cap (4,194,240 rows): sampled row
    slices, the cap's neighbourhood among them, against the plain version;
    a second launch the same bits.  Returns the largest relative error."""
    M = K9_OLD_CAP + 4103
    g = torch.Generator(device=device).manual_seed(12)
    dxg = torch.randn(M, 6 * H, generator=g, device=device)
    w = torch.randn(E, 6 * H, generator=g, device=device) / (6 * H) ** 0.5
    dx = gru_cuda.gru_input_proj_dx(dxg, w)
    torch.cuda.synchronize()
    rel = max(_rel_err(dx[lo:lo + 1500], gru_cuda.gru_input_proj_dx_ref(dxg[lo:lo + 1500], w))
              for lo in (0, M // 2, K9_OLD_CAP - 700, M - 1500))
    same = torch.equal(gru_cuda.gru_input_proj_dx(dxg, w), dx)
    print(f"K9 at {M} rows (past the old grid cap of {K9_OLD_CAP}): sampled slices "
          f"max relative {rel:.3e} (tolerance {K9_TOL:.0e}); second launch same bits {same}")
    if not (rel <= K9_TOL and same):
        raise AssertionError("K9 disagrees with its plain version past the old grid cap")
    del dxg, dx
    torch.cuda.empty_cache()
    return rel


GRU_WIDTHS = (8, 100, 256)  # --gru_size values off the default 64


def gru_width_phase(device, widths=GRU_WIDTHS, N=640, L=20, E=50):
    """K1-K4 and K9 against their plain versions at other --gru_size values
    (H = 8 and 100: the shared-memory K2 with a ragged block, K3's sweep
    at a runtime H; H = 256: both L2 routes), each launched twice for the
    same bits.  Returns {H: {kernel: device ms}} for K2 and K3, and K3's
    by kernel."""
    times = {}
    for H in widths:
        g = torch.Generator().manual_seed(H)
        x = (torch.randn(N, L, E, generator=g) * 0.5).to(device)
        lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
        lengths[0], lengths[1] = 1, L
        lengths = lengths.to(device)
        gru = BiGRU(E, H, generator=g).to(device)
        w_ih, b_ih, w_hh, b_hh = gru.kernel_operands()
        x2 = x.reshape(N * L, E)
        dy_sent = torch.randn(N, L, 2 * H, generator=g).to(device)
        dy_pos = torch.randn(N // 20, 20 * L, 2 * H, generator=g).to(device)
        xg = gru_cuda.gru_input_proj(x2, w_ih, b_ih)
        y = gru_cuda.bigru_recurrence(xg.view(N, L, 6 * H), lengths, w_hh, b_hh)
        dxg, dw_hh, db_hh = gru_cuda.bigru_backward(xg.view(N, L, 6 * H), y, dy_sent, dy_pos,
                                                     lengths, w_hh, b_hh)
        dw_ih, db_ih = gru_cuda.gru_input_proj_bwd(x2, dxg.view(N * L, 6 * H))
        dx = gru_cuda.gru_input_proj_dx(dxg.view(N * L, 6 * H), w_ih)
        torch.cuda.synchronize()
        outs = (xg, y, dxg, dw_hh, db_hh, dw_ih, db_ih, dx)
        again = (gru_cuda.gru_input_proj(x2, w_ih, b_ih),
                 gru_cuda.bigru_recurrence(xg.view(N, L, 6 * H), lengths, w_hh, b_hh),
                 *gru_cuda.bigru_backward(xg.view(N, L, 6 * H), y, dy_sent, dy_pos, lengths,
                                          w_hh, b_hh),
                 *gru_cuda.gru_input_proj_bwd(x2, dxg.view(N * L, 6 * H)),
                 gru_cuda.gru_input_proj_dx(dxg.view(N * L, 6 * H), w_ih))
        same = all(torch.equal(a, b) for a, b in zip(again, outs))
        del again
        # each kernel against its plain version on the kernels' own inputs
        ref_y = gru_cuda.bigru_recurrence_ref(xg.view(N, L, 6 * H), lengths, w_hh, b_hh)
        ref3 = gru_cuda.bigru_backward_ref(xg.view(N, L, 6 * H), y, dy_sent, dy_pos, lengths,
                                           w_hh, b_hh)
        ref4 = gru_cuda.gru_input_proj_bwd_ref(x2, dxg.view(N * L, 6 * H))
        errs = {
            "K1": (xg - gru_cuda.gru_input_proj_ref(x2, w_ih, b_ih)).abs().max().item(),
            "K2": (y - ref_y).abs().max().item(),
            "K3 dxg": (dxg - ref3[0]).abs().max().item(),
            "K3 dW/db": max(_rel_err(dw_hh, ref3[1]), _rel_err(db_hh, ref3[2])),
            "K4": max(_rel_err(dw_ih, ref4[0]), _rel_err(db_ih, ref4[1])),
            "K9": _rel_err(dx, gru_cuda.gru_input_proj_dx_ref(dxg.view(N * L, 6 * H), w_ih))}
        tols = {"K1": K1_TOL, "K2": K2_TOL, "K3 dxg": K3_DXG_TOL, "K3 dW/db": SUM_RTOL,
                "K4": SUM_RTOL, "K9": K9_TOL}
        xg3 = xg.view(N, L, 6 * H)
        times[H] = {
            "bigru_recurrence": device_ms(
                lambda: gru_cuda.bigru_recurrence(xg3, lengths, w_hh, b_hh), steps=5),
            "bigru_backward": device_ms(
                lambda: gru_cuda.bigru_backward(xg3, y, dy_sent, dy_pos, lengths, w_hh, b_hh),
                steps=5),
            "bigru_backward_by_kernel": part_split(
                lambda: gru_cuda.bigru_backward(xg3, y, dy_sent, dy_pos, lengths, w_hh, b_hh),
                K3_PARTS, steps=5)}
        print(f"bi-GRU kernels at H={H} (N={N}, L={L}, E={E}): max|kernel - plain| "
              + ", ".join(f"{k} {v:.3e} (tolerance {tols[k]:.0e})" for k, v in errs.items())
              + f"; second launches same bits {same}; device ms K2 "
              f"{_ms(times[H]['bigru_recurrence'])}, K3 {_ms(times[H]['bigru_backward'])}")
        print_split(f"K3 bigru_backward at H={H}", times[H]["bigru_backward_by_kernel"])
        if not (same and all(errs[k] <= tols[k] for k in errs)):
            raise AssertionError(f"a bi-GRU kernel disagrees with its plain version at H={H}")
        del outs, ref_y, ref3, ref4, xg, y, dxg, dx
        torch.cuda.empty_cache()
    return times


LONG_K3_SHAPE = (16384, 64, 50, 64)  # N = 2*B*S (user and item), L, E, H: 1,048,576 rows


def long_history_backward_phase(device, shape=LONG_K3_SHAPE):
    """K2 and K3 against their plain versions at the long-history shape
    (N*L = 1,048,576 token rows, two full rows side by side), a second
    launch the same bits, exact zeros past each length; their device times
    by kernel beside K2's bound.  Returns (K2's {device_ms, bound_ms, ...},
    K3's {part: device ms per call, "partials": chunk count, ...})."""
    N, L, E, H = shape
    g = torch.Generator().manual_seed(13)
    x = (torch.randn(N * L, E, generator=g) * 0.5).to(device)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    lengths[0], lengths[1] = L, L
    lengths = lengths.to(device)
    gru = BiGRU(E, H, generator=g).to(device)
    w_ih, b_ih, w_hh, b_hh = gru.kernel_operands()
    xg = gru_cuda.gru_input_proj(x, w_ih, b_ih).view(N, L, 6 * H)
    where = " at the long-history shape"
    y, k2_err = k2_check(xg, lengths, w_hh, b_hh, where)
    k2_parts = part_split(lambda: gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh),
                          K2_PARTS, steps=5)
    k2_bound_ms, k2_by = k2_bound(lengths, y.numel(), H)
    k2_long = {"shape": [N, L, H], "max_abs_err": k2_err,
               "device_ms": (sum(ms for ms in k2_parts.values() if ms is not None)
                             if any(k2_parts.values()) else None),
               "device_ms_by_kernel": k2_parts, "bound_ms": k2_bound_ms, "bound_by": k2_by}
    print(f"bigru_recurrence{where}: device {_ms(k2_long['device_ms'])} ms (row order "
          f"{_ms(k2_long['device_ms_by_kernel']['row order'])}); bound {k2_bound_ms:.4f} by "
          f"{k2_by}")
    dy_sent = torch.randn(N, L, 2 * H, generator=g).to(device)
    dy_pos = torch.randn(N // 128, 128 * L, 2 * H, generator=g).to(device)
    del x
    out = gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    ref = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    err = (out[0] - ref[0]).abs().max().item()
    rel = max(_rel_err(out[1], ref[1]), _rel_err(out[2], ref[2]))
    del ref
    past = torch.arange(L, device=device)[None, :] >= lengths[:, None]
    zeros = bool((out[0][past] == 0).all())
    again = gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    same = all(torch.equal(a, b) for a, b in zip(again, out))
    del again, out
    print(f"K3 bigru_backward at the long-history shape (N={N}, L={L}, H={H}, "
          f"{N * L} rows): dxg max|kernel - plain| = {err:.3e} (tolerance "
          f"{K3_DXG_TOL:.0e}); dW_hh, db_hh max relative {rel:.3e} (tolerance "
          f"{SUM_RTOL:.0e}); zeros past each length {zeros}; second launch same bits "
          f"{same}")
    if not (err <= K3_DXG_TOL and rel <= SUM_RTOL and zeros and same):
        raise AssertionError("K3 disagrees with its plain version at the long-history shape")
    parts = part_split(lambda: gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh,
                                                       b_hh), K3_PARTS, steps=5)
    print_split("K3 bigru_backward at the long-history shape", parts)
    del xg, y, dy_sent, dy_pos
    torch.cuda.empty_cache()
    return k2_long, {**parts, "partials": gru_cuda.bwd_chunks(N * L)[1], "max_abs_err": err,
                     "max_rel_err_dw_db": rel}


# xg loaded at the step, after the product, not ahead of it
K2_AFTER = [
    ("bigru_recurrence.cu", "  if (maxlen > 0) fetch(d == 0 ? 0 : maxlen - 1);\n", ""),
    ("bigru_recurrence.cu", "    if (s + 1 < maxlen) fetch(d == 0 ? t + 1 : t - 1);\n", ""),
    ("bigru_recurrence.cu", "    // the gates: a valid step",
     "    fetch(t);\n    // the gates: a valid step")]
# K2's redesign, one step at a time taken back out of the final source
# (csrc/bigru_recurrence.cu, csrc/row_order.cuh): (label, [(file, text,
# replacement), ...]); python3 chip_smoke.py --steps builds and times each
K2_STEPS = (
    ("final", []),
    ("rows in their own order", [("row_order.cuh", "row = k < N ? order[k] : -1;",
                                  "row = k < N ? k : -1;")]),
    ("W_hh copied a float at a time", [(
        "bigru_recurrence.cu",
        "for (int i = tid; i < H * G / 4; i += blockDim.x) smem4[i] = __ldg(src + i);",
        "for (int i = tid; i < H * G; i += blockDim.x) w_s[i] = W[i];")]),
    ("xg loaded after the product", K2_AFTER),
    ("a second barrier a step", [(
        "bigru_recurrence.cu",
        "      if (row[i] >= 0) store_y(i, t, out);\n    }\n",
        "      if (row[i] >= 0) store_y(i, t, out);\n    }\n    __syncthreads();\n")]),
    ("2 units x 4 rows a thread", [(
        "bigru_recurrence.cu",
        "Tile tile_shape(int H) { return 4 * H <= MAX_THREADS ? Tile{1, 4} : Tile{2, 4}; }",
        "Tile tile_shape(int H) { return Tile{2, 4}; }")]),
    ("2 units x 8 rows a thread", [
        ("bigru_recurrence.cu",
         "Tile tile_shape(int H) { return 4 * H <= MAX_THREADS ? Tile{1, 4} : Tile{2, 4}; }",
         "Tile tile_shape(int H) { return Tile{2, 8}; }"),
        ("bigru_recurrence.cu", ": bigru_recurrence_kernel<2, 4>;",
         ": bigru_recurrence_kernel<2, 8>;")]),
    ("k unrolled by 4", [("bigru_recurrence.cu",
                          "#pragma unroll 8\n    for (int k = 0; k < H; ++k) {",
                          "#pragma unroll 4\n    for (int k = 0; k < H; ++k) {")]),
    ("at most 85 registers (3 blocks an SM)", [
        ("bigru_recurrence.cu", "__launch_bounds__(MAX_THREADS)",
         "__launch_bounds__(MAX_THREADS, 3)")]),
)


def build_steps(name, steps, argtypes):
    """csrc/<name>.cu (and the headers) with each entry of `steps` (label,
    [(file, text, replacement), ...]) applied, built side by side into
    build/chip_smoke/steps/<name>/ (one nvcc each, all at once) and loaded.
    Prints each kernel's registers and spills.  Returns {label: the C
    function `name`}."""
    root = WORK / "steps" / name
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (label, edits) in enumerate(steps):
        src = root / str(i)
        src.mkdir(parents=True)
        for f in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / f"{name}.cu"]:
            text = f.read_text()
            for file, old, new in edits:
                if file == f.name:
                    if old not in text:
                        raise AssertionError(f"step {label!r}: {old!r} is not in {file}")
                    text = text.replace(old, new)
            (src / f.name).write_text(text)
        procs[label] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(src / "lib.so"),
             str(src / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for i, (label, proc) in enumerate(procs.items()):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"{name} step {label!r} did not build:\n{out}")
        lines = out.splitlines()
        report = [f"{lines[j].split('for')[-1].strip()[:60]}: {lines[j + 1].strip()}; "
                  f"{lines[j + 2].strip()}" for j, line in enumerate(lines[:-2])
                  if "Function properties" in line]
        print(f"{name} step {label!r}: built; " + " | ".join(report))
        fn = getattr(ctypes.CDLL(str(root / str(i) / "lib.so")), name)
        fn.argtypes = argtypes
        fns[label] = fn
    return fns


def k2_steps_phase(device, shapes=((2560, 20, 64), LONG_K3_SHAPE[:2] + LONG_K3_SHAPE[3:])):
    """K2's source with one step of its redesign taken back out at a time
    (K2_STEPS), each built beside the final one and timed (device ms under
    torch.profiler) at the UMPR-R and the long-history shapes, its output
    held against the final kernel's within K2_TOL.  Returns {label:
    {shape: device ms}}."""
    fns = build_steps("bigru_recurrence", K2_STEPS,
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    times = {label: {} for label in fns}
    for N, L, H in shapes:
        g = torch.Generator().manual_seed(N)
        xg = torch.randn(N, L, 6 * H, generator=g).to(device)
        lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32).to(device)
        w_hh = (torch.rand(2, H, 3 * H, generator=g) / H ** 0.5).to(device)
        b_hh = (torch.rand(2, 3 * H, generator=g) / H ** 0.5).to(device)
        order = torch.empty(N, device=device, dtype=torch.int32)
        stream = torch.cuda.current_stream().cuda_stream
        outs = {}
        for label, fn in fns.items():
            y = torch.empty(N, L, 2 * H, device=device)

            def call(fn=fn, y=y):
                err = fn(xg.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                         y.data_ptr(), order.data_ptr(), None, N, L, H, stream)
                if err:
                    raise AssertionError(f"K2 step {label!r} failed to launch: {err}")

            call()
            torch.cuda.synchronize()
            outs[label] = y
            times[label][f"{N}x{L}x{H}"] = device_ms(call, steps=10)
        err = max((y - outs["final"]).abs().max().item() for y in outs.values())
        print(f"K2 steps at (N, L, H) = {(N, L, H)}: device ms "
              + ", ".join(f"{label} {_ms(t[f'{N}x{L}x{H}'])}" for label, t in times.items())
              + f"; max|variant - final| {err:.3e}")
        if not err <= K2_TOL:
            raise AssertionError("a K2 step variant disagrees with the final kernel")
        del xg, outs
        torch.cuda.empty_cache()
    return times


# the VGG16 blocks that close with K5/K6 at B=64, 224 px (conv output H >=
# 56): x = the last conv's raw output, NHWC f32
POOL_SHAPES = ((64, 224, 224, 64), (64, 112, 112, 128), (64, 56, 56, 256))
DB_RTOL = 1e-5  # db: f32 sums of up to 802,816 terms against a float64 sum


def pool_kernel_phase(device, shapes=POOL_SHAPES):
    """K5 and K6 against their plain versions at the fused blocks' shapes,
    on inputs rounded to a coarse grid so that ties and all-negative
    windows occur: yp, idx and dx bit-equal, db against a float64 sum, a
    second launch the same bits.  Times each shape and adds them up: the
    kernel row's numbers are per train step."""
    import torch.nn.functional as F
    g = torch.Generator(device=device).manual_seed(5)
    per_shape = {"bias_relu_pool": [], "bias_relu_pool_bwd": []}
    errs = dict.fromkeys(per_shape, 0.0)  # max |kernel - plain| of yp, dx
    for shape in shapes:
        N, H, W, C = shape
        x = (torch.randn(shape, generator=g, device=device) * 2).round() / 2
        b = (torch.randn(C, generator=g, device=device) * 0.4).round() / 4
        dyp = torch.randn(N, H // 2, W // 2, C, generator=g, device=device)
        yp, idx = pool_cuda.bias_relu_pool(x, b)
        dx, db = pool_cuda.bias_relu_pool_bwd(dyp, idx, yp)
        torch.cuda.synchronize()
        ref_yp, ref_idx = pool_cuda.bias_relu_pool_ref(x, b)
        ref_dx, _ = pool_cuda.bias_relu_pool_bwd_ref(dyp, ref_idx, ref_yp)
        exact = (torch.equal(yp, ref_yp), torch.equal(idx, ref_idx), torch.equal(dx, ref_dx))
        errs["bias_relu_pool"] = max(errs["bias_relu_pool"],
                                     (yp - ref_yp).abs().max().item())
        errs["bias_relu_pool_bwd"] = max(errs["bias_relu_pool_bwd"],
                                         (dx - ref_dx).abs().max().item())
        db64 = torch.where(ref_yp > 0, dyp, 0.0).double().sum((0, 1, 2))
        db_rel = _rel_err(db.double(), db64)
        a = torch.where(x + b < 0, 0.0, x + b)
        hits = sum((a[:, i::2, j::2] == ref_yp).int() for i in (0, 1) for j in (0, 1))
        ties = ((hits > 1) & (ref_yp > 0)).float().mean().item()
        dead = (ref_yp == 0).float().mean().item()
        del a, hits
        del ref_yp, ref_idx, ref_dx
        again = (*pool_cuda.bias_relu_pool(x, b), *pool_cuda.bias_relu_pool_bwd(dyp, idx, yp))
        same = all(torch.equal(a, c) for a, c in zip(again, (yp, idx, dx, db)))
        del again
        print(f"K5/K6 at x {shape}: yp, idx, dx bit-equal to plain {exact}; db vs "
              f"float64 sum {db_rel:.3e} relative (tolerance {DB_RTOL:.0e}); second "
              f"launch same bits {same}; windows with a tie at a positive max "
              f"{ties:.1%}, pooled exactly 0 {dead:.1%}")
        if not (all(exact) and db_rel <= DB_RTOL and same):
            raise AssertionError(f"K5/K6 disagree with their plain versions at {shape}")

        # yardstick: ReLU then max_pool2d with indices on the NCHW view, and
        # its autograd backward
        xr = x.permute(0, 3, 1, 2).detach().requires_grad_()
        br = b.view(1, C, 1, 1).detach().requires_grad_()
        with torch.enable_grad():
            out, _ = F.max_pool2d(F.relu(xr + br), 2, return_indices=True)
        dout = dyp.permute(0, 3, 1, 2)
        n_in, n_out = x.numel(), yp.numel()
        rows = (("bias_relu_pool",
                 lambda: pool_cuda.bias_relu_pool(x, b),
                 lambda: pool_cuda.bias_relu_pool_ref(x, b),
                 lambda: F.max_pool2d(F.relu(xr.detach() + br.detach()), 2,
                                      return_indices=True),
                 bound(4 * (n_in + C + n_out) + n_out, 5 * n_in)),
                ("bias_relu_pool_bwd",
                 lambda: pool_cuda.bias_relu_pool_bwd(dyp, idx, yp),
                 lambda: pool_cuda.bias_relu_pool_bwd_ref(dyp, idx, yp),
                 lambda: torch.autograd.grad(out, (xr, br), dout, retain_graph=True),
                 bound(4 * (2 * n_out + n_in + C) + n_out, 8 * n_out)))
        for name, kernel, plain, library, (t_bound, by) in rows:
            per_shape[name].append({
                "x": list(shape),
                **timed(kernel, plain, library, iters=10, plain_iters=3, lib_iters=10),
                "bound_ms": t_bound, "bound_by": by})
        del x, dyp, yp, idx, dx, xr, br, out, dout
        torch.cuda.empty_cache()

    kernel_rows = []
    for name, src, replaces, call in (
            ("bias_relu_pool", "bias_relu_pool.cu", "umpr_tpu/ops/pool_pallas.py:127",
             "F.max_pool2d(F.relu(x + b), 2, return_indices=True) on the NCHW view"),
            ("bias_relu_pool_bwd", "bias_relu_pool_bwd.cu",
             "umpr_tpu/ops/pool_pallas.py:152",
             "torch.autograd.grad of that max_pool2d(relu(x + b)) w.r.t. x and b")):
        parts = per_shape[name]
        total = {k: None if any(p[k] is None for p in parts) else sum(p[k] for p in parts)
                 for k in ("ms", "plain_ms", "device_ms", "library_ms", "library_device_ms",
                           "bound_ms")}
        kernel_rows.append({
            "name": name, "route": "cuda", "source": f"umpr_tpu_torch/csrc/{src}",
            "replaces": replaces, "max_abs_err": errs[name], **total,
            "bound_by": "bytes" if all(p["bound_by"] == "bytes" for p in parts)
            else "operations",
            "library_call": call, "per_shape": parts})
        print_row(kernel_rows[-1], f" per train step over {len(parts)} shapes")
        print("  per shape " + ", ".join(
            f"{p['x']}: {p['ms']:.4f}, device {_ms(p['device_ms'])} vs bound "
            f"{p['bound_ms']:.4f}" for p in parts))
    return kernel_rows


# the long-history configuration: 128 sentences of up to 64 tokens (P =
# 8192), and a corpus whose histories and sentences reach both
LONG_FLAGS = ("--max_sent_count", "128", "--max_sent_length", "64")
LONG_CORPUS = dict(sent_tokens=(4, 80), review_sents=(18, 26))

ATT_TOL = 1e-5  # K7's maxima and K8's soft/atte: f32 sums in another order,
                # against each output's largest entry
TIE_GAP = 1e-6  # an argmax may differ from the plain version's only where
                # its two candidates' values lie this close
ATT_SHAPE = (64, 8192, 128)  # B, P = 128 sentences x 64 tokens, D = 2H
B10_SHAPE = (64, 400, 128)  # the reference P = 20 x 20, B10's route


def attention_case(device, B, P, D, seed, scale, frac=0.9):
    """Seeded gru_u, gru_i (B, P, D), M (D, D) and exists (P,) bool (the
    first frac of positions) on the device; T . U has a standard deviation
    of about 128 * scale (D = 128): 0.64 at scale 0.005, far from tanh's
    saturation; at scale 10 tanh is exactly +-1 almost everywhere."""
    g = torch.Generator(device=device).manual_seed(seed)
    U = torch.randn(B, P, D, generator=g, device=device)
    I = torch.randn(B, P, D, generator=g, device=device)
    M = torch.randn(D, D, generator=g, device=device) * scale
    return U, I, M, torch.arange(P, device=device) < int(P * frac)


def _argmax_gaps(T, U, got, want, col):
    """Where the kernel's argmax `got` differs from the plain version's
    `want`: (count, the largest value gap between the two candidates,
    from one more product).  col: the indices are rows p of a column's
    max (K7's partials, (B, R, P)), else columns q of a row's max (B, P)."""
    diff = (got != want).nonzero()
    if not len(diff):
        return 0, 0.0
    b, pos = diff[:, 0], diff[:, -1]
    gk, gw = got[tuple(diff.t())].long(), want[tuple(diff.t())].long()
    if col:
        vk, vw = ((T[b, i] * U[b, pos]).sum(-1) for i in (gk, gw))
    else:
        vk, vw = ((T[b, pos] * U[b, j]).sum(-1) for j in (gk, gw))
    return len(diff), (torch.tanh(vk) - torch.tanh(vw)).abs().max().item()


def _attention_check(U, I, M, exists, label, exact_argmax=False):
    """K7, then K8 on K7's partials, against their plain versions; a second
    launch must give the same bits.  Returns (T, K7's partials, K8's
    inputs' errors (K7 max abs, K8 max abs), near ties)."""
    B, P, D = U.shape
    T = (I.view(B * P, D) @ M).view(B, P, D)
    parts = attention_cuda.affinity_tiles(T, U, exists)
    out = attention_cuda.affinity_finish(*parts[:3], exists, U, I)
    torch.cuda.synchronize()
    want = attention_cuda.affinity_tiles_ref(T, U, exists)
    nan_same = all(torch.equal(a.isnan(), b.isnan()) for a, b in zip(parts[::2], want[::2]))
    err7 = max((a - b).nan_to_num().abs().max().item()
               for a, b in zip(parts[::2], want[::2]))
    n_col, gap_col = _argmax_gaps(T, U, parts[1], want[1], col=True)
    n_row, gap_row = _argmax_gaps(T, U, parts[3], want[3], col=False)
    del want
    ref = attention_cuda.affinity_finish_ref(*parts[:3], exists, U, I)
    rel8 = max(((a - b).nan_to_num().abs().max()
                / b.nan_to_num().abs().max().clamp(min=1e-30)).item()
               for a, b in zip(out[:4], ref[:4]))
    err8 = max((a - b).nan_to_num().abs().max().item() for a, b in zip(out[:4], ref[:4]))
    nan_same = nan_same and all(torch.equal(a.isnan(), b.isnan()) for a, b in zip(out, ref))
    exact8 = (torch.equal(out[4].nan_to_num(), ref[4].nan_to_num())
              and torch.equal(out[5], ref[5]))
    del ref
    again = attention_cuda.affinity_tiles(T, U, exists)
    again = (*again, *attention_cuda.affinity_finish(*again[:3], exists, U, I))
    same = all(torch.equal(a.nan_to_num(), b.nan_to_num()) and torch.equal(a.isnan(), b.isnan())
               for a, b in zip(again, (*parts, *out)))
    del again
    saturated = (parts[2] == 1.0).float().mean().item()
    print(f"K7/K8 {label} at (B, P, D) = {(B, P, D)}: K7 maxima max|kernel - plain| "
          f"{err7:.3e} (tolerance {ATT_TOL:.0e}); argmax differences {n_col} column, "
          f"{n_row} row, largest value gap {max(gap_col, gap_row):.3e} (allowed "
          f"{0 if exact_argmax else TIE_GAP:.0e}); K8 soft/atte max|kernel - plain| "
          f"{err8:.3e}, {rel8:.3e} of the largest entry (tolerance {ATT_TOL:.0e}); "
          f"colmax, amax_u exact {exact8}; NaN at the same places {nan_same}; second "
          f"launch same bits {same}; rows whose max is exactly 1.0: {saturated:.1%}")
    ties_ok = (n_col + n_row == 0) if exact_argmax else max(gap_col, gap_row) <= TIE_GAP
    if not (err7 <= ATT_TOL and ties_ok and rel8 <= ATT_TOL and exact8 and nan_same
            and same):
        raise AssertionError(f"K7/K8 disagree with their plain versions ({label})")
    return T, parts, (err7, err8), n_col + n_row


# small-B cases at other widths: D = 2 * gru_size 8, 100 and 256 (16: the
# wgmma kernel; 200, 512: the CUDA-core kernel), and a P that fills neither
# a 128-row nor a 64-column tile
ATT_WIDTH_CASES = ((4, 1000, 16), (4, 1000, 200), (2, 1000, 512), (4, 333, 128))


def k8_bound(B, P, D, R):
    """K8's bound: the partials, row_val, U and I read once, the (B, P)
    and (B, D) outputs written once; the merge's compares, the exps and the
    two attends' FMAs."""
    return bound(4 * (B * R * P * 2 + B * P + 2 * B * P * D + 4 * B * P + 2 * B * D) + P,
                 B * R * P + 2 * B * P * (2 * D + 4))


def attention_kernel_phase(device, shapes=(ATT_SHAPE, B10_SHAPE),
                           saturated=((8, 8192, 128), B10_SHAPE), nan=(4, 1000, 128),
                           widths=ATT_WIDTH_CASES, small_batch=(8, 8192, 128)):
    """K7 and K8 against their plain versions at the long-history shape
    (B=64, P=8192, D=128, 90% of positions existing) and at B10's
    (P=400); saturated inputs, where every max is an exact tie and the
    first index must win; NaN inputs; small-B cases at other widths and a
    ragged P.  Times both of `shapes`, and K8 at `small_batch` (a serving
    batch of 8 long histories: 64 blocks of K8's clusters)."""
    timing, errs, near = {}, [0.0, 0.0], 0
    for label, shape in zip(("long history", "B10 shape"), shapes):
        B, P, D = shape
        U, I, M, exists = attention_case(device, B, P, D, seed=P, scale=0.005)
        T, parts, err, n = _attention_check(U, I, M, exists, label)
        errs = [max(a, b) for a, b in zip(errs, err)]
        near += n
        n_ex = int(exists.sum())
        R = parts[0].shape[1]
        # every entry with its row or its column existing is needed (the
        # maxima of masked columns and rows are residuals too)
        needed = B * (P * P - (P - n_ex) ** 2)
        # 3xTF32 products on the tensor cores, the two chains' adds on the
        # CUDA cores
        k7_bound = bound(4 * (2 * B * P * D + B * R * P * 2 + B * P * 2) + P, needed,
                         tf32_flops=3 * 2 * needed * D)
        k8_b = k8_bound(B, P, D, R)
        out_buf = torch.empty(B, P, P, device=device)
        timing[label] = {
            "shape": list(shape),
            "affinity_tiles": {
                **timed(lambda: attention_cuda.affinity_tiles(T, U, exists),
                        lambda: attention_cuda.affinity_tiles_ref(T, U, exists),
                        lambda: torch.bmm(T, U.transpose(1, 2), out=out_buf),
                        iters=5, plain_iters=2, lib_iters=3),
                "bound_ms": k7_bound[0], "bound_by": k7_bound[1]},
            "affinity_finish": {
                **timed(lambda: attention_cuda.affinity_finish(*parts[:3], exists, U, I),
                        lambda: attention_cuda.affinity_finish_ref(*parts[:3], exists, U, I),
                        None, iters=10, plain_iters=5),
                "bound_ms": k8_b[0], "bound_by": k8_b[1]}}
        del out_buf, T, parts, U, I, M
        torch.cuda.empty_cache()
        for name, t in timing[label].items():
            if name == "shape":
                continue
            lib = ("none" if name == "affinity_finish" else
                   f"{_ms(t['library_ms'])}, device {_ms(t['library_device_ms'])}")
            print(f"{name} at {shape}: {t['ms']:.4f} ms, device {_ms(t['device_ms'])} (plain "
                  f"{t['plain_ms']:.4f}, library {lib}), bound {t['bound_ms']:.4f} by "
                  f"{t['bound_by']}")

    B, P, D = small_batch
    U, I, M, exists = attention_case(device, B, P, D, seed=P + 1, scale=0.005)
    _, parts, err, n = _attention_check(U, I, M, exists, "small batch")
    errs = [max(a, b) for a, b in zip(errs, err)]
    near += n
    k8_b = k8_bound(B, P, D, parts[0].shape[1])
    k8_small = {"shape": list(small_batch),
                **timed(lambda: attention_cuda.affinity_finish(*parts[:3], exists, U, I),
                        lambda: attention_cuda.affinity_finish_ref(*parts[:3], exists, U, I),
                        None, iters=10, plain_iters=5),
                "bound_ms": k8_b[0], "bound_by": k8_b[1]}
    print(f"affinity_finish at {small_batch}: {k8_small['ms']:.4f} ms, device "
          f"{_ms(k8_small['device_ms'])} (plain {k8_small['plain_ms']:.4f}), bound "
          f"{k8_small['bound_ms']:.4f} by {k8_small['bound_by']}")
    del U, I, M, parts

    for shape in saturated:
        U, I, M, exists = attention_case(device, *shape, seed=1, scale=10.0)
        _, parts, _, _ = _attention_check(U, I, M, exists, "saturated", exact_argmax=True)
        if not (parts[2] == 1.0).float().mean() > 0.99:
            raise AssertionError("the saturated case is not saturated")
        del U, I, M, parts
    U, I, M, exists = attention_case(device, *nan, seed=2, scale=0.005)
    I[0, 0, 0] = float("nan")   # row 0 of sample 0 (existing): NaN maxima
    U[-1, -1, 0] = float("nan")  # a masked column: its column max only
    _attention_check(U, I, M, exists, "NaN", exact_argmax=True)
    del U, I, M
    for shape in widths:
        U, I, M, exists = attention_case(device, *shape, seed=3, scale=0.005)
        _attention_check(U, I, M, exists, "width case")
        del U, I, M
    torch.cuda.empty_cache()

    main = timing["long history"]
    out = []
    for name, src, call, err in (
            ("affinity_tiles", "affinity_tiles.cu",
             "torch.bmm(T, U^T) in f32 into a preallocated (B, P, P) tensor: the "
             "product part only, no tanh, max or argmax", errs[0]),
            ("affinity_finish", "affinity_finish.cu", None, errs[1])):
        out.append({
            "name": name, "route": "cuda", "source": f"umpr_tpu_torch/csrc/{src}",
            "replaces": "umpr_tpu/ops/attention_pallas.py:415",
            "also_replaces": ["umpr_tpu/ops/attention_pallas.py:167"],
            "max_abs_err": err, **main[name], "library_call": call,
            "shape": main["shape"], "argmax_near_ties": near,
            "at_b10_shape": timing["B10 shape"][name]})
    out[1]["at_small_batch"] = k8_small
    return out


# K8's design with one choice changed at a time (csrc/affinity_finish.cu)
K8_STEPS = (
    ("final", []),
    ("256 threads a block", [("affinity_finish.cu", "constexpr int THREADS = 512;",
                              "constexpr int THREADS = 256;")]),
    ("merge loads 16 ahead", [("affinity_finish.cu", "constexpr int MERGE_AHEAD = 8;",
                               "constexpr int MERGE_AHEAD = 16;")]),
    ("a floor of 2 blocks an SM", [("affinity_finish.cu", "__launch_bounds__(THREADS)",
                                    "__launch_bounds__(THREADS, 2)")]),
    ("attends 8 rows in flight", [("affinity_finish.cu",
                                   "#pragma unroll 4\n          for (int j = warp; j < wn;",
                                   "#pragma unroll 8\n          for (int j = warp; j < wn;")]),
)


def k8_steps_phase(device, shapes=(ATT_SHAPE, (8, 8192, 128), B10_SHAPE)):
    """K8's design with one choice changed at a time (K8_STEPS), each built
    beside the final one and timed (device ms under torch.profiler) on K7's
    partials at the long-history shape, at B = 8 and at B10's, its outputs
    within ATT_TOL of the final kernel's.  Returns {label: {shape: device
    ms}}."""
    fns = build_steps("affinity_finish", K8_STEPS,
                      [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    times = {label: {} for label in fns}
    for B, P, D in shapes:
        U, I, M, exists = attention_case(device, B, P, D, seed=P, scale=0.005)
        T = (I.view(B * P, D) @ M).view(B, P, D)
        col_val, col_idx, row_val, _ = attention_cuda.affinity_tiles(T, U, exists)
        R = col_val.shape[1]
        outs = {}
        for label, fn in fns.items():
            out = [torch.empty(B, P, device=device) for _ in range(2)] + [
                torch.empty(B, D, device=device) for _ in range(2)] + [
                torch.empty(B, P, device=device), torch.empty(B, P, device=device,
                                                             dtype=torch.int32)]

            def call(fn=fn, out=out, label=label):
                err = fn(col_val.data_ptr(), col_idx.data_ptr(), row_val.data_ptr(),
                         exists.data_ptr(), U.data_ptr(), I.data_ptr(),
                         *(o.data_ptr() for o in out), B, R, P, D,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise AssertionError(f"K8 step {label!r} failed to launch: {err}")

            call()
            torch.cuda.synchronize()
            outs[label] = out
            times[label][f"{B}x{P}x{D}"] = device_ms(call, steps=10)
        err = max(max((a - b).abs().max().item() for a, b in zip(o[:4], outs["final"][:4]))
                  for o in outs.values())
        print(f"K8 steps at (B, P, D) = {(B, P, D)}: device ms "
              + ", ".join(f"{label} {_ms(t[f'{B}x{P}x{D}'])}" for label, t in times.items())
              + f"; max|variant - final| {err:.3e}")
        if not err <= ATT_TOL:
            raise AssertionError("a K8 step variant disagrees with the final kernel")
        del U, I, M, T, col_val, col_idx, row_val, outs
        torch.cuda.empty_cache()
    return times


def _post(base, rows):
    body = json.dumps({"rows": rows}).encode()
    req = urllib.request.Request(f"{base}/predict", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)["predictions"]


def _counting(fn, counter):
    def wrapped(t, *args):
        if t.device.type == "cuda":
            counter[0] += 1
        return fn(t, *args)
    return wrapped


FORWARD = ("gru_input_proj", "bigru_recurrence")  # K1, K2
GRU_BACKWARD = ("bigru_backward", "gru_input_proj_bwd")  # K3, K4
ATTENTION = ("affinity_tiles", "affinity_finish")  # K7, K8
MODULES = (gru_cuda, pool_cuda, attention_cuda)  # every kernel wrapper of the port
PLAIN = {gru_cuda: ("gru_input_proj_ref", "bigru_recurrence_ref",
                    "bigru_backward_ref", "gru_input_proj_bwd_ref",
                    "gru_input_proj_dx_ref"),
         pool_cuda: ("bias_relu_pool_ref", "bias_relu_pool_bwd_ref"),
         attention_cuda: ("affinity_tiles_ref", "affinity_finish_ref")}


@contextlib.contextmanager
def main_path_counts():
    """Zero every kernel's launch count, count the plain versions' calls on
    CUDA tensors, and on exit fill the yielded dict with the launches made
    inside the block: (launches dict, [plain calls])."""
    launches, plain_calls = {}, [0]
    saved = [(m, name, getattr(m, name)) for m in MODULES for name in PLAIN[m]]
    for m in MODULES:
        m.reset_launches()
    for m, name, fn in saved:
        setattr(m, name, _counting(fn, plain_calls))
    try:
        yield launches, plain_calls
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
        launches.update({k.__name__: k.launches for m in MODULES for k in m.KERNELS})


def pre_relu(predictor, ds):
    """The head's output before its ReLU over ds's samples, in order."""
    outs = []
    hook = predictor.model.linear_fusion.register_forward_hook(
        lambda module, args, out: outs.append(out[:, 0].cpu()))
    try:
        predictor.predict_dataset(ds)
    finally:
        hook.remove()
    return torch.cat(outs).numpy()[:len(ds)]  # dead rows pad the last batch


def subset(ds, n):
    """The first n samples of a packed dataset."""
    return dataclasses.replace(ds, **{f.name: getattr(ds, f.name)[:n]
                                      for f in dataclasses.fields(ds)})


def batch_maxima(data):
    """(largest sentence count, largest sentence length) over the user and
    item histories of a packed dataset or a batch; a batch's are the
    runtime maxima that set its exists mask in training."""
    get = data.__getitem__ if isinstance(data, dict) else lambda k: getattr(data, k)
    return (max(int(get("u_counts").max()), int(get("i_counts").max())),
            max(int(get("u_lengths").max()), int(get("i_lengths").max())))


def kernel_attention(cfg):
    """Does a batch of this config take the attention kernels K7/K8 (above
    ops/attention.py's (B, P, P) byte threshold)?"""
    P = cfg.max_sent_count * cfg.max_sent_length
    return cfg.batch_size * P * P * 4 > attention.TILED_BYTES_THRESHOLD


CPU_ROWS = 4  # rows held against the CPU where a full batch's composite would
              # not fit it (4 * 8192^2 f32 is 1 GiB)


def serve_phase(device_name, work=WORK, flags=(), corpus=None):
    """UMPR-R serving (B=64, reference widths): HTTP requests and a CSV
    pass on the card, then the same rows on the CPU with the plain
    versions.  flags: extra CLI flags (the long-history shape); corpus:
    write_corpus keyword arguments.  Where the card's batches take K7/K8,
    every batch must launch them, and the first CPU_ROWS samples are held
    against a CPU Predictor of that batch size, which takes the composite.
    Returns the launch counts of the main path (HTTP requests + CSV
    mode)."""
    if work.exists():
        shutil.rmtree(work)
    glove, csv, shard_rows = write_corpus(work, seed=0, **(corpus or {}))
    model_dir = work / "model"
    argv = ["--review_net_only", "True", "--data_dir", str(work), "--word2vec_file", str(glove),
            "--model_path", str(model_dir), *flags]
    cfg = Config(argv)  # default device: cuda
    long_history = kernel_attention(cfg)
    w2v = Word2vec(str(glove))
    model = UMPR(ModelDims.from_config(cfg), w2v.embedding,
                 torch.Generator().manual_seed(CKPT_SEED))
    ckpt.save_best(str(model_dir), model)
    predictor = serve.Predictor(cfg, w2v, str(model_dir))
    df = pd.read_csv(csv)
    requests = [df.iloc[r].to_dict("records") for r in shard_rows]

    server = serve.make_http_server(predictor, cfg, w2v, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        _post(base, requests[0])  # warm-up, before the counts are zeroed
        with main_path_counts() as (launches, plain_calls):
            t0 = time.perf_counter()
            answers = [_post(base, rows) for rows in requests]
            http_s = time.perf_counter() - t0
            repeat = _post(base, requests[0])
            out_csv = work / "predictions.csv"
            serve.main(argv + ["--input", str(csv), "--output", str(out_csv)])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    http = np.full(len(df), np.nan)
    for rows, preds in zip(shard_rows, answers):
        http[rows] = [np.nan if p is None else p for p in preds]
    scored = np.isfinite(http)
    n_batches = sum(-(-int(np.isfinite(np.asarray(a, float)).sum()) // cfg.batch_size)
                    for a in answers + [repeat])
    csv_pred = pd.read_csv(out_csv)["prediction"].to_numpy()
    n_batches += -(-int(np.isfinite(csv_pred).sum()) // cfg.batch_size)
    full_ds = build_dataset(str(csv), str(work / "photos.json"), str(work / "photos"),
                            w2v, cfg)
    print(f"HTTP: {len(requests)} /predict requests, {int(scored.sum())} of "
          f"{len(df)} rows scored at B={cfg.batch_size}, S={cfg.max_sent_count}, "
          f"L={cfg.max_sent_length} (P={cfg.max_sent_count * cfg.max_sent_length}), "
          f"in {http_s:.3f} s; the CSV's largest history and sentence: "
          f"{batch_maxima(full_ds)}")
    if scored.sum() <= cfg.batch_size:
        raise AssertionError("the requests did not span two batches")
    if not (http[scored] >= 0).all():
        raise AssertionError("negative prediction from a ReLU head")
    positive, spread = (http[scored] > 0).mean(), http[scored].std()
    print(f"predictions: {positive:.1%} > 0, std {spread:.3e}, range "
          f"[{http[scored].min():.6f}, {http[scored].max():.6f}]")
    if positive < 0.5 or not spread > MIN_SPREAD:
        raise AssertionError("the predictions are degenerate (mostly clamped "
                             "to 0 or constant): the checks below would see "
                             "nothing")
    if repeat != answers[0]:
        raise AssertionError("a repeated request scored differently")
    if not np.array_equal(np.isfinite(csv_pred), scored):
        raise AssertionError("CSV mode and HTTP scored different rows")
    diff = np.abs(csv_pred[scored] - http[scored]).max()
    print(f"CSV mode vs HTTP, same rows: max abs diff {diff:.3e}")
    if not diff <= 1e-6:
        raise AssertionError("CSV mode and HTTP disagree")

    print(f"serving path launches: {launches}; plain versions called on the "
          f"card: {plain_calls[0]}; batches dispatched: {n_batches}")
    if plain_calls[0]:
        raise AssertionError("a plain version ran on the card")
    want = (dict.fromkeys(launches, 0) | dict.fromkeys(FORWARD, n_batches)
            | dict.fromkeys(ATTENTION if long_history else (), n_batches))
    if launches != want:
        raise AssertionError(f"serving launches {launches}, expected {want}")

    # the same rows on the CPU, plain versions
    cpu_argv = argv + ["--device", "cpu"]
    ds = full_ds
    if long_history:
        cpu_argv += ["--batch_size", str(CPU_ROWS)]
        ds = subset(full_ds, CPU_ROWS)
    cpu = serve.Predictor(Config(cpu_argv), w2v, str(model_dir))
    cpu_pred, rows = cpu.predict_dataset(ds)
    err = np.abs(cpu_pred - csv_pred[rows]).max()
    print(f"card vs CPU plain versions (CPU batch {cpu.config.batch_size}): max abs "
          f"diff {err:.3e} (tolerance {E2E_TOL:.0e}) over {len(rows)} samples")
    if not err <= E2E_TOL:
        raise AssertionError("card and CPU predictions disagree")
    card_pre, cpu_pre = pre_relu(predictor, ds), pre_relu(cpu, ds)
    err = np.abs(card_pre - cpu_pre).max()
    print(f"card vs CPU before the head's ReLU: max abs diff {err:.3e} "
          f"(tolerance {E2E_TOL:.0e}), range [{cpu_pre.min():.6f}, "
          f"{cpu_pre.max():.6f}], std {cpu_pre.std():.3e}")
    if not err <= E2E_TOL:
        raise AssertionError("card and CPU disagree before the ReLU")

    # throughput on the card: the full host path, then the device forward
    predictor.predict_dataset(full_ds)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        predictor.predict_dataset(full_ds)
    wall = (time.perf_counter() - t0) / reps
    n_b = -(-len(full_ds) // cfg.batch_size)
    batch = to_device(next(iter(BatchLoader(full_ds, cfg.batch_size))),
                      predictor.device)
    batch["pad_maxima"] = (cfg.max_sent_count, cfg.max_sent_length,
                           cfg.max_ui_sent_count, cfg.max_sent_length)
    with torch.inference_mode():
        fwd_ms = time_cuda(lambda: predictor.model(batch))
    print(f"serving on {device_name}: predict_dataset {wall / n_b * 1e3:.3f} ms "
          f"per B={cfg.batch_size} batch ({len(full_ds) / wall:.1f} samples/s, host "
          f"clock, {len(full_ds)} samples); device forward {fwd_ms:.3f} ms per batch "
          f"({cfg.batch_size / fwd_ms * 1e3:.1f} samples/s, CUDA events)")
    with torch.inference_mode():
        device_breakdown(lambda: predictor.model(batch), "forward")
    return launches


def _watched_params(model):
    """R-Net's bi-GRU weights and its affinity form M."""
    return {n: p.detach().cpu() for n, p in model.named_parameters()
            if ".gru." in n or n.endswith("rnet.M")}


def train_phase(device_name, work="train", flags=(), corpus=None):
    """UMPR-R training at the reference widths through the port's CLI.
    flags, corpus: as serve_phase's.  Where the batches take K7/K8, every
    train step and evaluation batch must launch them, and the CPU's
    validation MSE (two more CPU forwards at that P) is not taken.
    Returns the launch counts of the main path (fit + test)."""
    root = WORK / work
    glove = write_splits(root, seed=1, shards=5, **(corpus or {}))
    argv = ["--review_net_only", "True", "--data_dir", str(root),
            "--word2vec_file", str(glove), "--train_epochs", "2",
            "--learning_rate", "1e-3", "--eval_every", "2",
            "--model_path", str(root / "model"), "--log_path", str(root / "train.log"),
            "--metrics_jsonl", str(root / "metrics.jsonl"), *flags]
    with main_path_counts() as (launches, plain_calls):
        t0 = time.perf_counter()
        trainer = train_main.main(argv)  # default device: cuda
        main_s = time.perf_counter() - t0
    cfg, B = trainer.config, trainer.config.batch_size
    long_history = kernel_attention(cfg)
    w2v = Word2vec(str(glove))
    photos = (str(root / "photos.json"), str(root / "photos"))
    ds = {s: build_dataset(str(root / f"{s}.csv"), *photos, w2v, cfg)
          for s in ("train", "valid", "test")}
    events = [json.loads(line) for line in open(root / "metrics.jsonl")]
    evals = [e for e in events if e["event"] == "eval"]
    steps = trainer.batch_counter
    n_batches = {s: -(-len(d) // B) for s, d in ds.items()}
    eval_batches = len(evals) * n_batches["valid"] + n_batches["test"]
    batch = next(iter(BatchLoader(ds["train"], B)))
    print(f"training: {steps} train steps over {len(ds['train'])} samples "
          f"(B={B}, S={cfg.max_sent_count}, L={cfg.max_sent_length}), "
          f"{len(evals)} validations of {len(ds['valid'])} samples, test on "
          f"{len(ds['test'])}, in {main_s:.1f} s (host clock, datasets built "
          f"inside); the first train batch's largest history and sentence "
          f"(its exists mask): {batch_maxima(batch)}")
    for e in events:
        print("  " + json.dumps({k: v for k, v in e.items() if k != "ts"}))
    print(f"training path launches: {launches}; plain versions called on the "
          f"card: {plain_calls[0]}; eval batches: {eval_batches}")
    if steps < 8:
        raise AssertionError(f"only {steps} train steps")
    values = [v for e in events for k, v in e.items()
              if k in ("train_loss", "valid_mse", "test_mse")]
    if not all(v is not None and np.isfinite(v) for v in values):
        raise AssertionError("a non-finite loss or MSE was logged")
    if plain_calls[0]:
        raise AssertionError("a plain version ran on the card")
    want = (dict.fromkeys(launches, 0) | dict.fromkeys(GRU_BACKWARD, steps)
            | dict.fromkeys(FORWARD, steps + eval_batches)
            | dict.fromkeys(ATTENTION if long_history else (), steps + eval_batches))
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")

    # the GRU and M moved, and one step's gradients agree with the CPU
    dims = ModelDims.from_config(cfg)
    init = UMPR(dims, w2v.embedding, torch.Generator().manual_seed(cfg.seed))
    before = _watched_params(init)
    moved = {n: (p - before[n]).abs().max().item()
             for n, p in _watched_params(trainer.model).items()}
    print(f"GRU weights and M moved by (max abs): {min(moved.values()):.3e} .. "
          f"{max(moved.values()):.3e} over {len(moved)} tensors")
    if len(moved) != 9 or not min(moved.values()) > 0:
        raise AssertionError("a GRU weight or M did not move")
    grads, losses = [], []
    for dev in ("cpu", trainer.device):
        model = UMPR(dims, w2v.embedding, torch.Generator().manual_seed(cfg.seed)).to(dev)
        loss = model(to_device(batch, dev))[1]
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None})
        del model, loss
    rel = {n: _rel_err(grads[1][n], g) for n, g in grads[0].items()}
    gru_rel = max(v for n, v in rel.items() if ".gru." in n)
    print(f"one train step, card vs CPU plain versions: loss {losses[1]:.6f} vs "
          f"{losses[0]:.6f}; GRU gradients max relative diff {gru_rel:.3e}, M "
          f"{rel['review_net.rnet.M']:.3e}, all {len(rel)} parameters "
          f"{max(rel.values()):.3e} (tolerance {GRAD_RTOL:.0e})")
    if (len(rel) != len(list(init.parameters())) - 1 or not max(rel.values()) <= GRAD_RTOL
            or not abs(losses[1] - losses[0]) <= E2E_TOL * max(1.0, abs(losses[0]))):
        raise AssertionError("card and CPU gradients disagree")
    if long_history:
        print("initial validation MSE against the CPU: not taken here (two more "
              "CPU forwards at this P); the gradient check's loss covers the forward")
    else:
        cpu_mse = evaluate_mse(init, (to_device(b, "cpu")
                                      for b in BatchLoader(ds["valid"], B)))
        err = abs(cpu_mse - evals[0]["valid_mse"])
        print(f"initial validation MSE: card {evals[0]['valid_mse']:.6f}, CPU "
              f"{cpu_mse:.6f}, diff {err:.3e} (tolerance {E2E_TOL:.0e})")
        if not err <= E2E_TOL:
            raise AssertionError("card and CPU validation MSEs disagree")

    # speed on the card: train steps back to back on one batch
    model, opt = trainer.model, trainer.opt
    dev_batch = to_device(batch, trainer.device)
    step_ms = time_cuda(lambda: train_step(model, opt, dev_batch, 1e-3),
                        iters=10 if long_history else 20)
    print(f"training on {device_name}: {step_ms:.3f} ms per B={B} train step "
          f"({B / step_ms * 1e3:.1f} samples/s, CUDA events, back to back); "
          f"fit + test {main_s / steps * 1e3:.1f} ms per train step, "
          f"evaluations and dataset builds included (host clock); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_breakdown(lambda: train_step(model, opt, dev_batch, 1e-3), "train step",
                     steps=5)
    return launches


def seeded_photo(path, resize=(224, 224)):
    """Stand-in for images.get_image on a machine without a JPEG decoder:
    uint8 pixels seeded by the photo's file name; zeros for an empty slot,
    as get_image gives."""
    if not path:
        return np.zeros((resize[1], resize[0], 3), dtype=np.uint8)
    rng = np.random.default_rng(zlib.crc32(Path(path).name.encode()))
    return rng.integers(0, 256, (resize[1], resize[0], 3), dtype=np.uint8)


def _l2_rel(got, want, floor):
    """||got - want|| / max(||want||, floor)."""
    return ((got - want).norm() / want.norm().clamp(min=floor)).item()


def use_seeded_photos():
    """Decode photos through seeded_photo from here on (said once)."""
    from umpr_tpu_torch.data import images
    if images.get_image is not seeded_photo:
        images.get_image = seeded_photo
        print("photos: this machine has no JPEG decoder, so "
              "umpr_tpu_torch.data.images.get_image is replaced by a uint8 source "
              "seeded by each photo's file name (zeros for an empty slot)")


def full_train_phase(device_name):
    """Full UMPR training at the reference widths and 224 px through the
    port's CLI (--vgg_fused_pool True).  Returns the launch counts of the
    main path (fit + test)."""
    root = WORK / "full"
    glove = write_splits(root, seed=1, shards=5)
    use_seeded_photos()
    # seed 2: at init the ReLU head is above 0 on this corpus (seed 0
    # clamps every prediction to 0, and the MSE then trains nothing)
    argv = ["--review_net_only", "False", "--vgg_fused_pool", "True", "--seed", "2",
            "--data_dir", str(root), "--word2vec_file", str(glove),
            "--train_epochs", "2", "--learning_rate", "1e-3", "--eval_every", "4",
            "--data_workers", "4", "--model_path", str(root / "model"),
            "--log_path", str(root / "train.log"),
            "--metrics_jsonl", str(root / "metrics.jsonl")]
    with main_path_counts() as (launches, plain_calls):
        t0 = time.perf_counter()
        trainer = train_main.main(argv)  # default device: cuda
        main_s = time.perf_counter() - t0
    cfg, B = trainer.config, trainer.config.batch_size
    fused = sum(1 for h in (cfg.photo_size >> k for k in range(5))
                if h >= FUSED_POOL_MIN_H and h % 2 == 0)
    w2v = Word2vec(str(glove))
    photos = (str(root / "photos.json"), str(root / "photos"))
    ds = {s: build_dataset(str(root / f"{s}.csv"), *photos, w2v, cfg)
          for s in ("train", "valid", "test")}
    events = [json.loads(line) for line in open(root / "metrics.jsonl")]
    evals = [e for e in events if e["event"] == "eval"]
    steps = trainer.batch_counter
    n_batches = {s: -(-len(d) // B) for s, d in ds.items()}
    eval_batches = len(evals) * n_batches["valid"] + n_batches["test"]
    print(f"full UMPR training: {steps} train steps over {len(ds['train'])} samples "
          f"(B={B}, S={cfg.max_sent_count}, L={cfg.max_sent_length}, "
          f"S_ui={cfg.max_ui_sent_count}, {cfg.photo_size} px, VGG blocks closed by "
          f"K5/K6: {fused}), {len(evals)} validations of {len(ds['valid'])} samples, "
          f"test on {len(ds['test'])}, in {main_s:.1f} s (host clock, datasets "
          f"built and checkpoints written inside); photo cache "
          f"{trainer.photo_cache.hits} hits, {trainer.photo_cache.misses} misses")
    for e in events:
        print("  " + json.dumps({k: v for k, v in e.items() if k != "ts"}))
    print(f"full UMPR path launches: {launches}; plain versions called on the card: "
          f"{plain_calls[0]}; eval batches: {eval_batches}")
    if steps < 8:
        raise AssertionError(f"only {steps} train steps")
    values = [v for e in events for k, v in e.items()
              if k in ("train_loss", "valid_mse", "test_mse")]
    if not all(v is not None and np.isfinite(v) for v in values):
        raise AssertionError("a non-finite loss or MSE was logged")
    zero_mse = float(np.mean(ds["valid"].ratings.astype(np.float64) ** 2))
    if not all(abs(e["valid_mse"] - zero_mse) > 1e-3 for e in evals):
        raise AssertionError(f"a validation MSE equals {zero_mse:.6f}, that of "
                             "predictions clamped to 0")
    if plain_calls[0]:
        raise AssertionError("a plain version ran on the card")
    # per train step: three bi-GRU calls (R-Net, C-Net on the ui review,
    # C-Net on the histories) and one fused pool per closed block
    want = (dict.fromkeys(launches, 0) | dict.fromkeys(FORWARD, 3 * (steps + eval_batches))
            | dict.fromkeys(GRU_BACKWARD, 3 * steps)
            | {"bias_relu_pool": fused * (steps + eval_batches),
               "bias_relu_pool_bwd": fused * steps})
    if not fused or launches != want:
        raise AssertionError(f"full UMPR launches {launches}, expected {want}")

    # the fused blocks' biases (K6's db) and C-Net's GRU moved
    dims = ModelDims.from_config(cfg)
    init = UMPR(dims, w2v.embedding, torch.Generator().manual_seed(cfg.seed))
    init_sd, trained = init.state_dict(), trainer.model.state_dict()
    closing = [f"visual_net.vgg16.features.{i}.bias" for i in (1, 3, 6)[:fused]]
    watched = closing + [n for n in init_sd if n.startswith("control_net.cnet.gru.")]
    moved = {n: (trained[n].cpu() - init_sd[n]).abs().max().item() for n in watched}
    print(f"moved by (max abs): fused blocks' biases "
          f"{[f'{moved[n]:.3e}' for n in closing]}, C-Net GRU "
          f"{min(moved[n] for n in watched[fused:]):.3e} .. "
          f"{max(moved[n] for n in watched[fused:]):.3e}")
    if not min(moved.values()) > 0:
        raise AssertionError("a fused block's bias or a C-Net GRU weight did not move")

    # one sub-batch of the trained model, dropout off: the card against the
    # CPU's plain versions in f32, and both against the CPU in f64
    sub = next(iter(BatchLoader(ds["train"], 8, ignore_photos=False,
                                resize=(cfg.photo_size, cfg.photo_size))))
    cpu32 = UMPR(dims, w2v.embedding)
    cpu32.load_state_dict({k: v.cpu() for k, v in trained.items()})
    # raise the head's bias until every row's prediction is > 0, so that
    # the ReLU head passes the MSE's gradient to every branch
    head = []
    hook = cpu32.linear_fusion.register_forward_hook(
        lambda module, args, out: head.append(out[:, 0]))
    with torch.no_grad():
        cpu32(to_device(sub, "cpu"))
        cpu32.linear_fusion.bias += 1.0 - head[0].min().clamp(max=1.0)
    hook.remove()
    runs = {}
    for name, model in (("card", copy.deepcopy(cpu32).to(trainer.device)),
                        ("cpu64", copy.deepcopy(cpu32).double()), ("cpu32", cpu32)):
        head = []
        hook = model.linear_fusion.register_forward_hook(
            lambda module, args, out: head.append(out[:, 0].detach().cpu().double()))
        pred, loss, _ = model(to_device(sub, next(model.parameters()).device))
        loss.backward()
        hook.remove()
        runs[name] = (pred.detach().cpu().double(), head[0], {
            n: p.grad.cpu().double() for n, p in model.named_parameters()
            if p.grad is not None})
        del model, pred, loss
    (card_pred, card_head, card_g), (cpu_pred, cpu_head, cpu_g) = runs["card"], runs["cpu32"]
    exact = runs["cpu64"][2]
    pred_err = max((card_pred - cpu_pred).abs().max().item(),
                   (card_head - cpu_head).abs().max().item())
    if set(card_g) != set(exact) or len(exact) != len(list(cpu32.parameters())) - 1:
        raise AssertionError("a parameter got no gradient")
    # a gradient below a thousandth of the largest gradient's norm is held
    # against that thousandth: the visual linear's bias cancels in eq. 11,
    # so its gradient is rounding alone
    floor = 1e-3 * max(g.norm() for g in exact.values())
    vs_cpu = {n: _l2_rel(card_g[n], cpu_g[n], floor) for n in exact}
    err_card = {n: _l2_rel(card_g[n], exact[n], floor) for n in exact}
    err_cpu = {n: _l2_rel(cpu_g[n], exact[n], floor) for n in exact}
    # a ReLU or max-pool decision within f32 rounding of its threshold can
    # flip, and a flip moves whole gradient terms: where the CPU's own f32
    # gradient is that far from f64, the card's may be as far, not farther
    # than GRAD_FLIP_FACTOR times
    bad = [n for n in exact
           if not err_card[n] <= max(GRAD_RTOL, GRAD_FLIP_FACTOR * err_cpu[n])]
    flipped = sorted((n for n in exact if err_cpu[n] > GRAD_RTOL), key=err_cpu.get)
    worst = max(vs_cpu, key=vs_cpu.get)
    calm = [n for n in exact if n not in flipped]
    print(f"8 rows of the trained model, dropout off: card vs CPU plain versions, "
          f"predictions and the head's pre-ReLU input max abs diff {pred_err:.3e} "
          f"(tolerance {E2E_TOL:.0e}; head range [{cpu_head.min():.4f}, "
          f"{cpu_head.max():.4f}]); gradients l2-relative, card vs CPU f32: worst "
          f"{vs_cpu[worst]:.3e} ({worst}); against the CPU in f64, {len(calm)} of "
          f"{len(exact)} parameters: card {max(err_card[n] for n in calm):.3e}, CPU "
          f"{max(err_cpu[n] for n in calm):.3e} (tolerance {GRAD_RTOL:.0e})")
    for n in flipped:
        print(f"  f32 decision flips: {n}: card {err_card[n]:.3e}, CPU {err_cpu[n]:.3e} "
              f"from f64 (card tolerance {GRAD_FLIP_FACTOR}x the CPU's)")
    if not (pred_err <= E2E_TOL and not bad and (cpu_head > 0).all()):
        raise AssertionError(f"card and CPU disagree on full UMPR: {bad}")

    # speed on the card: train steps back to back on one batch
    model, opt = trainer.model, trainer.opt
    batch = to_device(next(iter(BatchLoader(
        ds["train"], B, ignore_photos=False, resize=(cfg.photo_size, cfg.photo_size)))),
        trainer.device)
    step = lambda: train_step(model, opt, batch, 1e-3, trainer.dropout_generator(0))
    # the Trainer pins cuDNN to deterministic algorithms (bit-exact
    # resume); its cost, in turns within this call
    step_ms = time_cuda(step, iters=10)
    torch.backends.cudnn.deterministic = False
    free_ms = time_cuda(step, iters=10)
    torch.backends.cudnn.deterministic = True
    again_ms = time_cuda(step, iters=10)
    print(f"full UMPR training on {device_name}: {step_ms:.3f} ms per B={B} train step "
          f"({B / step_ms * 1e3:.1f} samples/s, CUDA events, back to back) with "
          f"cudnn.deterministic True, as the Trainer sets it (again after: "
          f"{again_ms:.3f} ms); {free_ms:.3f} ms with it False; fit + "
          f"test {main_s / steps * 1e3:.1f} ms per train step, evaluations, "
          f"checkpoints and dataset builds included (host clock); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_breakdown(step, "full UMPR train step", steps=5, top=14)
    return launches


# the full-UMPR serving checkpoint: with seed 2 the ReLU head is above 0
# on every row of write_corpus(seed=0) at 224 px (seeds 0 and 4 clamp
# every prediction to 0)
FULL_SERVE_SEED = 2


def _kernel_counts():
    return {k.__name__: k.launches for m in MODULES for k in m.KERNELS}


def full_serve_phase(device_name, work=WORK / "full_serve"):
    """Full UMPR serving (--review_net_only False --vgg_fused_pool True,
    224 px, B=64) with the resident photo bank: HTTP requests and a CSV
    pass on the card, the bank against streaming photos (--device_dataset
    off, the same bits), then CPU_ROWS rows against a CPU Predictor of
    that batch size.  cuDNN runs as a serving process has it: only the
    Trainer pins its algorithms (the forward is also timed pinned, in
    turns).  Returns the launch counts of the main path (HTTP requests +
    CSV mode)."""
    use_seeded_photos()
    torch.backends.cudnn.deterministic = False
    if work.exists():
        shutil.rmtree(work)
    glove, csv, shard_rows = write_corpus(work, seed=0)
    model_dir = work / "model"
    argv = ["--review_net_only", "False", "--vgg_fused_pool", "True",
            "--data_workers", "4", "--data_dir", str(work), "--word2vec_file", str(glove),
            "--model_path", str(model_dir)]
    cfg = Config(argv)  # default device: cuda; --device_dataset auto: the bank
    B = cfg.batch_size
    fused = sum(1 for h in (cfg.photo_size >> k for k in range(5))
                if h >= FUSED_POOL_MIN_H and h % 2 == 0)
    w2v = Word2vec(str(glove))
    model = UMPR(ModelDims.from_config(cfg), w2v.embedding,
                 torch.Generator().manual_seed(FULL_SERVE_SEED))
    ckpt.save_best(str(model_dir), model)
    predictor = serve.Predictor(cfg, w2v, str(model_dir))
    if not predictor._bank_enabled:
        raise AssertionError("the photo bank is off at --device_dataset auto")
    df = pd.read_csv(csv)
    requests = [df.iloc[r].to_dict("records") for r in shard_rows]
    full_ds = build_dataset(str(csv), str(work / "photos.json"), str(work / "photos"),
                            w2v, cfg)
    photos = set(full_ds.photo_paths.ravel()) - {""}

    server = serve.make_http_server(predictor, cfg, w2v, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    cache = predictor._photo_cache
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        _post(base, requests[0])  # warm-up, before the counts are zeroed
        answers, grown, per_request, walls = [], [], [], []
        with main_path_counts() as (launches, plain_calls):
            for rows in requests + [requests[0]]:  # the first again: nothing new
                held, misses, before = len(predictor._bank_rows), cache.misses, _kernel_counts()
                t0 = time.perf_counter()
                answers.append(_post(base, rows))
                walls.append(time.perf_counter() - t0)
                grown.append((len(predictor._bank_rows) - held, cache.misses - misses))
                per_request.append({k: v - before[k] for k, v in _kernel_counts().items()
                                    if v - before[k]})
            out_csv = work / "predictions.csv"
            serve.main(argv + ["--input", str(csv), "--output", str(out_csv)])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    answers, repeat = answers[:-1], answers[-1]

    http = np.full(len(df), np.nan)
    for rows, preds in zip(shard_rows, answers):
        http[rows] = [np.nan if p is None else p for p in preds]
    scored = np.isfinite(http)
    req_batches = [-(-int(np.isfinite(np.asarray(a, float)).sum()) // B)
                   for a in answers + [repeat]]
    csv_pred = pd.read_csv(out_csv)["prediction"].to_numpy()
    n_batches = sum(req_batches) + -(-int(np.isfinite(csv_pred).sum()) // B)
    print(f"full UMPR HTTP: {len(requests)} /predict requests and the first again, "
          f"{int(scored.sum())} of {len(df)} rows scored at B={B}, {cfg.photo_size} px, "
          f"VGG blocks closed by K5: {fused}; wall per request (host clock): "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms")
    print(f"photo bank: {len(predictor._bank_rows)} rows (capacity "
          f"{predictor._bank.shape[0]}) for {len(photos)} distinct photos; per request "
          f"(rows added, photos decoded): {grown}")
    positive, spread = (http[scored] > 0).mean(), http[scored].std()
    print(f"predictions: {positive:.1%} > 0, std {spread:.3e}, range "
          f"[{http[scored].min():.6f}, {http[scored].max():.6f}]")
    if positive < 0.5 or not spread > MIN_SPREAD:
        raise AssertionError("the predictions are degenerate (mostly clamped "
                             "to 0 or constant): the checks below would see nothing")
    # the warm-up decoded the first request's photos, each later request
    # only its own, and the first again nothing
    if grown[0] != (0, 0) or grown[-1] != (0, 0) \
            or not all(a == b > 0 for a, b in grown[1:-1]) \
            or len(predictor._bank_rows) != 1 + len(photos):
        raise AssertionError("the bank did not decode each photo once")
    if repeat != answers[0]:
        raise AssertionError("a repeated request scored differently")
    if not np.array_equal(np.isfinite(csv_pred), scored):
        raise AssertionError("CSV mode and HTTP scored different rows")
    diff = np.abs(csv_pred[scored] - http[scored]).max()
    print(f"CSV mode vs HTTP, same rows: max abs diff {diff:.3e}")
    if not diff <= 1e-6:
        raise AssertionError("CSV mode and HTTP disagree")

    print(f"full UMPR serving launches: {launches}; per request: {per_request}; plain "
          f"versions called on the card: {plain_calls[0]}; batches dispatched: "
          f"{n_batches}")
    want = (dict.fromkeys(launches, 0) | dict.fromkeys(FORWARD, 3 * n_batches)
            | {"bias_relu_pool": fused * n_batches})
    if plain_calls[0] or not fused or launches != want:
        raise AssertionError(f"full UMPR serving launches {launches}, expected {want}")
    for n, counts in zip(req_batches, per_request):
        if counts != {"gru_input_proj": 3 * n, "bigru_recurrence": 3 * n,
                      "bias_relu_pool": fused * n}:
            raise AssertionError(f"a request's launches {counts}, for {n} batches")

    # the bank against streaming photos: the same bytes, the same bits
    stream = serve.Predictor(Config(argv + ["--device_dataset", "off"]), w2v, str(model_dir))
    bank_pred, rows = predictor.predict_dataset(full_ds)
    stream_pred, _ = stream.predict_dataset(full_ds)
    print(f"bank vs streaming photos over {len(rows)} samples: "
          f"{int((bank_pred != stream_pred).sum())} predictions differ")
    if not np.array_equal(bank_pred, stream_pred):
        raise AssertionError("the photo bank and streaming photos disagree")

    # the first rows on the CPU, plain versions
    ds = subset(full_ds, CPU_ROWS)
    cpu = serve.Predictor(Config(argv + ["--device", "cpu", "--batch_size", str(CPU_ROWS)]),
                          w2v, str(model_dir))
    cpu_pred, rows = cpu.predict_dataset(ds)
    err = np.abs(cpu_pred - bank_pred[:CPU_ROWS]).max()
    card_pre, cpu_pre = pre_relu(predictor, ds), pre_relu(cpu, ds)
    pre_err = np.abs(card_pre - cpu_pre).max()
    print(f"card vs CPU plain versions (CPU batch {CPU_ROWS}): predictions max abs diff "
          f"{err:.3e}, before the head's ReLU {pre_err:.3e} (tolerance {E2E_TOL:.0e}; "
          f"range [{cpu_pre.min():.6f}, {cpu_pre.max():.6f}])")
    if not (err <= E2E_TOL and pre_err <= E2E_TOL):
        raise AssertionError("card and CPU full-UMPR predictions disagree")

    # throughput: the host path with the bank and with streaming photos,
    # then the device forward
    n_b = -(-len(full_ds) // B)
    walls = {}
    for name, p in (("bank", predictor), ("streaming", stream)):
        p.predict_dataset(full_ds)
        t0 = time.perf_counter()
        for _ in range(3):
            p.predict_dataset(full_ds)
        walls[name] = (time.perf_counter() - t0) / 3 / n_b * 1e3
    batch = to_device(next(iter(BatchLoader(full_ds, B, ignore_photos=False,
                                            resize=(cfg.photo_size, cfg.photo_size)))),
                      predictor.device)
    batch["pad_maxima"] = (cfg.max_sent_count, cfg.max_sent_length,
                           cfg.max_ui_sent_count, cfg.max_sent_length)
    forward = lambda: predictor.model(batch)
    with torch.inference_mode():
        fwd_ms = time_cuda(forward, iters=10)
        torch.backends.cudnn.deterministic = True
        pinned_ms = time_cuda(forward, iters=10)
        torch.backends.cudnn.deterministic = False
        again_ms = time_cuda(forward, iters=10)
    print(f"full UMPR serving on {device_name}: predict_dataset {walls['bank']:.3f} ms "
          f"per B={B} batch with the bank, {walls['streaming']:.3f} ms streaming photos "
          f"(host clock, {len(full_ds)} samples, photos decoded and cached); device "
          f"forward {fwd_ms:.3f} ms per batch ({B / fwd_ms * 1e3:.1f} samples/s, CUDA "
          f"events; again after: {again_ms:.3f}), {pinned_ms:.3f} ms with "
          f"cudnn.deterministic True")
    with torch.inference_mode():
        device_breakdown(forward, "full UMPR forward", steps=5, top=12)
    return launches


RESUME_STOP = 3  # the interrupted run stops after 3 steps; it saved at 2
RESUME_EVERY = 2


def after_resume(events, batch):
    """The --metrics_jsonl events that a run resumed at `batch` computes
    again: every one logged past it (and the test), less the train losses
    summed over the epoch that began before it, which the resumed run
    sums from its resume point on."""
    first_epoch = next(e["epoch"] for e in events if e.get("batch", -1) > batch)
    out = []
    for e in events:
        if e["event"] == "test" or e["batch"] > batch:
            e = {k: v for k, v in e.items() if k not in ("ts", "elapsed_s")}
            if e.get("epoch") == first_epoch:
                e.pop("train_loss", None)
            out.append(e)
    return out


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        return x.files == y.files and all(np.array_equal(x[k], y[k]) for k in x.files)


def resume_phase(device_name, work, flags=(), corpus=None):
    """Resume on the card: an uninterrupted run (``umpr_tpu_torch.main``,
    2 epochs), a run with --save_every_batches RESUME_EVERY stopped after
    RESUME_STOP steps (Trainer.fit's test hook), and that run resumed with
    --resume_path through the CLI.  The resumed run must end with the
    uninterrupted run's bits: parameters, Adam's state, best/ and last/,
    and every --metrics_jsonl value computed after the resume point."""
    from umpr_tpu_torch.train.trainer import Trainer
    from umpr_tpu_torch.utils.logging import get_logger
    root = WORK / work
    if root.exists():
        shutil.rmtree(root)
    glove = write_splits(root, seed=1, shards=5, **(corpus or {}))
    base = ["--data_dir", str(root), "--word2vec_file", str(glove), "--train_epochs", "2",
            "--learning_rate", "1e-3", "--eval_every", "4", *flags]
    if not Config(base).review_net_only:
        use_seeded_photos()

    def argv(run, model_dir, *extra):
        return base + ["--model_path", str(root / model_dir), "--log_path",
                       str(root / f"{run}.log"), "--metrics_jsonl",
                       str(root / f"{run}.jsonl"), *extra]

    every = ("--save_every_batches", str(RESUME_EVERY))
    t0 = time.perf_counter()
    with main_path_counts() as (launches, plain_calls):
        whole = train_main.main(argv("whole", "whole"))
        cfg = Config(argv("cut", "cut", *every))
        w2v = Word2vec(str(glove))
        photos = (str(root / "photos.json"), str(root / "photos"))
        train, valid = (build_dataset(str(root / f"{s}.csv"), *photos, w2v, cfg)
                        for s in ("train", "valid"))
        cut = Trainer(cfg, get_logger(str(root / "cut.log"), logger_name="resume-cut"), w2v)
        cut.fit(train, valid, str(root / "cut"), _stop_after_batches=RESUME_STOP)
        meta = json.load(open(root / "cut" / "last" / "meta.json"))
        resumed = train_main.main(argv("resumed", "cut", "--resume_path", str(root / "cut")))
    seconds = time.perf_counter() - t0
    at = meta["batch_counter"]
    steps, per_epoch = whole.batch_counter, -(-len(train) // cfg.batch_size)

    a, b = whole.model.state_dict(), resumed.model.state_dict()
    params_equal = sum(torch.equal(a[k], b[k]) for k in a)
    (ca, mua, nua), (cb, mub, nub) = (adam_to_jax(t.model, t.opt) for t in (whole, resumed))
    moments = [(x, y) for ta, tb in ((mua, mub), (nua, nub))
               for (_, x), (_, y) in zip(ckpt.leaves_with_path(ta), ckpt.leaves_with_path(tb))]
    adam_equal = sum(np.array_equal(x, y) for x, y in moments)
    files_equal = all(_npz_equal(root / "whole" / name / "arrays.npz",
                                 root / "cut" / name / "arrays.npz")
                      for name in ("best", "last"))
    want = after_resume([json.loads(line) for line in open(root / "whole.jsonl")], at)
    got = after_resume([json.loads(line) for line in open(root / "resumed.jsonl")], at)
    n_values = sum(k in e for e in want for k in ("train_loss", "valid_mse", "test_mse"))
    print(f"resume {work} on {device_name}: {steps} steps uninterrupted ({per_epoch} a epoch), the other "
          f"run stopped after {RESUME_STOP} with last/ at batch {at} ({meta}), resumed to "
          f"{resumed.batch_counter}, in {seconds:.1f} s (host clock, 3 runs); bit-equal: "
          f"{params_equal} of {len(a)} parameter tensors, {adam_equal} of {len(moments)} "
          f"Adam moments (count {ca} and {cb}), best/ and last/ files {files_equal}, "
          f"{len(got)} of {len(want)} events after batch {at} ({n_values} values) "
          f"{got == want}; launches over the three runs {launches}, plain versions on "
          f"the card {plain_calls[0]}")
    if not (0 < meta["batch_in_epoch"] < per_epoch and meta["epoch"] == 0):
        raise AssertionError("the interrupted run did not save mid-epoch")
    if plain_calls[0] or (kernel_attention(cfg) and not launches["affinity_tiles"]):
        raise AssertionError("the resume runs did not take the kernels")
    if not (resumed.batch_counter == steps and params_equal == len(a) and ca == cb
            and adam_equal == len(moments) and files_equal and got == want
            and len(want) >= 3):
        raise AssertionError(f"the resumed run {work} differs from the uninterrupted one")
    return {"steps": steps, "resumed_at": at, "stopped_after": RESUME_STOP,
            "parameter_tensors": len(a), "adam_moments": len(moments),
            "events_compared": len(want), "seconds": round(seconds, 1)}


def input_grad_phase(device_name, device="cuda", N=2560, L=20, E=50, H=64, S=20):
    """A gradient through ``bigru_split`` with x requiring grad, at the
    UMPR-R shapes, on the card (K1-K4 and K9) and on the CPU (plain
    versions).  Returns the card run's launch counts."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(N, L, E, generator=g) * 0.5
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    c_pos = torch.randn(N // S, S * L, 2 * H, generator=g)
    c_sent = torch.randn(N, L, 2 * H, generator=g)
    grads = {}
    for dev in ("cpu", device):
        gru = BiGRU(E, H, generator=torch.Generator().manual_seed(9)).to(dev)
        xd = x.to(dev).detach().requires_grad_()  # a leaf on either device
        with main_path_counts() as (launches, plain_calls):
            pos, sent = bigru_split(gru, xd, lengths.to(dev), S)
            ((pos * c_pos.to(dev)).sum() + (sent * c_sent.to(dev)).sum()).backward()
            torch.cuda.synchronize()
        grads[dev] = (xd.grad.cpu(), {n: p.grad.cpu() for n, p in gru.named_parameters()})
    (card_dx, card_w), (cpu_dx, cpu_w) = grads[device], grads["cpu"]
    dx_rel = _rel_err(card_dx, cpu_dx)
    w_rel = max(_rel_err(card_w[n], w) for n, w in cpu_w.items())
    print(f"bigru_split with x requiring grad (N={N}, L={L}, E={E}, H={H}) on "
          f"{device_name}: dx card vs "
          f"CPU max relative diff {dx_rel:.3e}, weights {w_rel:.3e} (tolerance "
          f"{SUM_RTOL:.0e}); launches {launches}; plain versions on the card "
          f"{plain_calls[0]}")
    want = (dict.fromkeys(launches, 0)
            | dict.fromkeys(FORWARD + GRU_BACKWARD + ("gru_input_proj_dx",), 1))
    if plain_calls[0] or launches != want:
        raise AssertionError(f"input-gradient launches {launches}, expected {want}")
    if not (dx_rel <= SUM_RTOL and w_rel <= SUM_RTOL):
        raise AssertionError("card and CPU input gradients disagree")
    return launches


def port_kernel_names():
    """The names of the port's CUDA kernels, read from csrc/*.cu."""
    pattern = re.compile(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(")
    return {name for src in _build.CSRC.glob("*.cu*")
            for name in pattern.findall(src.read_text())}


def device_breakdown(fn, what, steps=10, top=10):
    """Device time by kernel over `steps` calls of fn (torch.profiler), and
    the device's busy share of the host wall time of those calls: the
    `top` kernels, then the port's own kernels wherever they rank."""
    from torch.autograd import DeviceType
    kernels, wall_ms, events = profile_device(fn, steps)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps) for e in kernels),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    if not kernels:
        print("device breakdown: torch.profiler recorded no device time "
              f"(not measured); wall {wall_ms:.3f} ms per {what}")
        return
    print(f"device breakdown (torch.profiler, {steps} x {what}): busy "
          f"{busy:.3f} ms of {wall_ms:.3f} ms wall per {what} (idle share "
          f"{1 - busy / wall_ms:.1%}), {len(kernels)} kernels")
    for name, ms in kernels[:top]:
        print(f"  {ms:8.4f} ms  {ms / busy:6.1%}  {name[:90]}")
    ours = port_kernel_names()
    for name, ms in kernels[top:]:
        if any(k in name for k in ours):
            print(f"  {ms:8.4f} ms  {ms / busy:6.1%}  {name[:90]}")
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps, e.count // steps)
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda kv: -kv[1])
    print(f"host ops by self time per {what} (under the profiler):")
    for name, ms, n in host[:top]:
        print(f"  {ms:8.4f} ms  x{n:<4d} {name[:80]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    if sys.argv[1:] == ["--steps"]:  # K2's and K8's designs choice by choice, then stop
        _build.build(("affinity_tiles",))
        with torch.no_grad():
            print(json.dumps({"k2_steps": k2_steps_phase(torch.device("cuda")),
                              "k8_steps": k8_steps_phase(torch.device("cuda"))}))
        return 0
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    serve.set_f32_parity()
    print("numerics: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)}, sm_90a)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    device = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    card = f"{device_name} ({smi})"
    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        print(f"phase {name}: {seconds[name]} s")
        return out

    with torch.no_grad():
        kernels = phase("gru kernels", kernel_phase, device)
        widths = phase("gru kernels at other widths", gru_width_phase, device)
        k2_long, k3_long = phase("K2 and K3 at the long-history shape",
                                 long_history_backward_phase, device)
        kernels += phase("input-gradient kernel", input_grad_kernel_phase, device)
        kernels += phase("pool kernels", pool_kernel_phase, device)
        kernels += phase("attention kernels", attention_kernel_phase, device)
    served = phase("UMPR-R serving", serve_phase, card)
    trained = phase("UMPR-R training", train_phase, card)
    full = phase("full UMPR training", full_train_phase, card)
    full_served = phase("full UMPR serving", full_serve_phase, card)
    input_grad = phase("bigru_split input gradient", input_grad_phase, card)
    long_served = phase("long-history UMPR-R serving", serve_phase, card,
                        WORK / "long_serve", LONG_FLAGS, LONG_CORPUS)
    long_trained = phase("long-history UMPR-R training", train_phase, card,
                         "long_train", LONG_FLAGS, LONG_CORPUS)
    # seed 5: at init the ReLU head is above 0 on this corpus at gru_size
    # 100 (the default seed clamps every prediction to 0: nothing trains)
    gru100 = phase("UMPR-R training at --gru_size 100", train_phase, card, "gru100",
                   ("--gru_size", "100", "--seed", "5"))
    resumed = {
        "umpr_r": phase("resume, UMPR-R", resume_phase, card, "resume_r",
                        ("--review_net_only", "True")),
        # seed 2 as in the full UMPR training: a head above 0 trains
        "full_umpr": phase("resume, full UMPR", resume_phase, card, "resume_full",
                           ("--review_net_only", "False", "--vgg_fused_pool", "True",
                            "--seed", "2", "--data_workers", "4")),
        "long_history": phase("resume, long-history UMPR-R", resume_phase, card,
                              "resume_long", ("--review_net_only", "True") + LONG_FLAGS,
                              LONG_CORPUS)}
    # each kernel's launches come from the main path that runs it
    main_path = {"gru_input_proj_dx": input_grad, "affinity_tiles": long_trained,
                 "affinity_finish": long_trained}
    for k in kernels:
        k["launches"] = main_path.get(k["name"], full)[k["name"]]
        for run, counts in (("umpr_r_training", trained), ("serving", served),
                            ("long_history_serving", long_served),
                            ("long_history_training", long_trained),
                            ("gru_size_100_training", gru100),
                            ("full_umpr_serving", full_served)):
            k[f"launches_{run}"] = counts[k["name"]]
        if k["name"] in ("bigru_recurrence", "bigru_backward"):
            k["device_ms_at_gru_size"] = {H: t[k["name"]] for H, t in widths.items()}
        if k["name"] == "bigru_recurrence":
            k["at_long_history_shape"] = k2_long
        if k["name"] == "bigru_backward":
            k["device_ms_by_kernel_at_gru_size"] = {
                H: t["bigru_backward_by_kernel"] for H, t in widths.items()}
            k["at_long_history_shape"] = k3_long
    print(f"phase seconds: {seconds}")
    print(json.dumps({"resume_bit_equal": resumed}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
