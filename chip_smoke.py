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
   4,194,240 rows; K7/K8 at D = 16, 200 and 512 and a ragged P; f32 K1
   at E = 100, 200 and 300 (``K1_F32_WIDTHS``: its wgmma and transposed
   kernels) beside f32 torch.addmm, with both their values past 1e-5 of
   the plain version in f64.
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
10. ``--steps_per_dispatch`` (CUDA graphs of k steps): UMPR-R training
   through ``umpr_tpu_torch.main.main``, 20 steps at k = 1 and k = 4 with
   ``--profile_dir`` (parameters and logged values within rtol 1e-5, atol
   1e-6, bits equal or not printed; launches on the card, replays x the
   launches captured, equal to k = 1's; the k = 1 trace names K1's and
   K2's kernels; ms per step and idle share at both k); full UMPR at 224
   px, 4 steps at k = 1 and 2 (the same dropout masks, parameters within
   the same tolerance); UMPR-R serving at k = 4 (the same bits as k = 1,
   one HTTP request, ms per batch and idle share).  Phases 4 and 8 also
   time a graph of 4 train steps.  Before them the port's Adam step alone
   beside torch.optim.Adam's foreach step (a yardstick), then
   ``--adam_moment_dtype bfloat16
   --adam_factored_nu True``: 6 steps card vs CPU within 1e-5, and a
   resume from last/ bit-exact on the card; and ``--rnet_pretrained``:
   the card's predictions against the CPU's.
11. ROADMAP A5's training runtime (``a5_runtime_phase``): UMPR-R through
   ``umpr_tpu_torch.main.main`` on the dispatch corpus, streaming
   (``--device_dataset off``) and resident (the default) at k = 1 and 4:
   the same parameters, logged values and best/ bits; the first run
   caches the splits and every later one loads them (its log says so),
   so the resident upload reads memmaps; fit wall per step, and ms per
   step and idle share of both steps at k = 1 and as a graph of 4.  Full
   UMPR at 224 px, 4 steps, streaming and resident with the training
   photo bank: the same bits, each distinct photo decoded once.  On one
   full-UMPR model: ``--grad_accum_steps 4`` against the single step
   (loss, gradients, parameters after an Adam step at lr 1e-6, a lower
   peak memory) and ``--remat_vgg`` against without (the same bits, a
   peak within 1% and less memory held for the backward, K5 twice per
   fused block, ms per step), then remat as a
   graph of 2 steps against 2 single steps (the same bits).  Phases 4, 5,
   9 and 10 pass ``--device_dataset off`` (and ``--cache_dataset False``
   through the CLI), so that their numbers compare with earlier runs.
12. ROADMAP A5's streaming build: the dispatch corpus's splits built with
   ``--build_chunk_rows 7`` (into a memmap cache) and 0 (full memory):
   the same arrays, the cache loads, and the native tokenizer and the
   streaming build ran (``data.dataset.PATHS``); each build's seconds.
13. ``--compute_dtype bfloat16``: K1-K4's bf16 variants against their
   plain bf16 versions (one bf16 ulp; dW/db within 1e-4 of their l2
   norms; the same bits twice) at the UMPR-R shapes and K1/K4 at
   ``BF16_WIDTHS`` (the edges of K1's bf16 routes and of K4's whole-row
   copy), timed beside the bf16 library calls (K4's computing its whole
   function: f32 dW and db; K1's at each width beside its bound), with K1's,
   K2's, K3's and K4's ptxas report, K2 and K3 by kernel, bf16 K2 also
   at H = 128 and at (16,385, 64, 64) and bf16 K3 at H = 128 and 192
   (``K2_BF16_AT``, ``K3_BF16_WIDTHS``); UMPR-R trained in bf16
   through main (every K1-K4 launch bf16, no plain version, no other
   kernel), its train step (k = 1 and a graph of 4) and serving forward
   against f32 in turns; full UMPR at 224 px, one train step and the
   serving forward against f32 (loss within 0.05, predictions within
   0.08); a bf16 UMPR-R resume, bit-equal.
14. The rest of ``--compute_dtype bfloat16`` and export: K5/K6's bf16
   variants at the three fused VGG blocks (yp, idx, dx bit-equal, db
   within one ulp) and K9's at the UMPR-R shape and ``K9_BF16_AT``
   (within one ulp), timed beside the bf16 library calls and their
   bounds; a bf16 x's gradient through
   ``bigru_split`` (K9 bf16, card against CPU); then through
   ``umpr_tpu_torch.main.main``, one epoch each in bf16: full UMPR at 224
   px with ``--vgg_fused_pool True`` (every K5/K6 launch bf16; fused
   against the composite pool in turns: step, forward, peak memory),
   long-history UMPR-R (every K7/K8 launch on f32-widened inputs; step
   and forward against f32) and ``--gru_size 100`` (the bf16 scan, no
   kernel; step at k = 1 and as a graph of 4 against f32, predictions
   within 0.08); then ``python -m umpr_tpu_torch.export`` on the card for
   UMPR-R and full UMPR at 224 px, f32 and bf16, each artifact against
   the Predictor's model (1e-4 in f32, 0.08 in bf16) and timed beside
   it, and a UMPR-R artifact traced on the CPU moved to the card (1e-5);
   then long-history UMPR-R (P = 8192; ``export_long_history``), f32 at
   B = 64 and bf16 at B = 32: K7/K8 as custom ops in the graph, launched
   once each by the artifact's forward (no plain version, no other
   kernel), against the Predictor's model on the kernel path and timed
   beside it, the f32 forward by kernel; the attention through the custom
   ops against the ctypes wrappers (the same bits, in turns); the f32
   artifact traced on the CPU, moved to the card (1e-5).
14a. ROADMAP A9, data prep (``data_prep_phase``): a seeded raw Amazon
   dump (``.json.gz``) and metadata through ``python -m
   umpr_tpu_torch.text.preprocess`` and the manifest's photos through
   ``python -m umpr_tpu_torch.data.download`` from a local HTTP server
   (subprocesses: this machine has neither sklearn nor nltk), the
   prepared files built by build_dataset and one batch scored by a
   full-UMPR Predictor at 224 px on the card.
14b. ROADMAP A7, data parallelism (``parallel_phase``): UMPR-R through
   ``umpr_tpu_torch.main`` as two gloo ranks sharing the card (each rank a
   ``chip_smoke.py --rank_run`` process writing to files, every wait
   bounded) against one rank: ranks bit-equal, within 1e-5 of one rank,
   best/ and last/ written by rank 0 alone, K1-K4 in each rank, ms per
   step of both (correctness, not scaling); then a world of one on NCCL at
   ``--steps_per_dispatch 4``: its all-reduce captured in the graph, the
   bits of the run without a process group.
14c. ROADMAP A8, pretraining (``pretraining_phase``): on a seeded corpus
   of 3,200 sentences, ``python -m umpr_tpu_torch.train_embeddings``,
   ``-m umpr_tpu_torch.pretrain.abae`` and ``-m
   umpr_tpu_torch.pretrain.rnet`` through their mains at their default
   widths with 2 epochs (the R-Net CLI's steps: 1,024 pairs, K1-K4 once a
   step, no plain version, no K9); one epoch of the R-Net pretrainer card
   against CPU (losses and R-Net leaves within 1e-4); the saved R-Net into
   a UMPR-R Trainer through ``--rnet_pretrained`` (the "Loaded" line, the
   bits); ms of an R-Net, an ABAE and a skip-gram step.
15. Print each phase's seconds, a ``{"resume_bit_equal": ...}`` line, a
   ``{"steps_per_dispatch": ...}`` line, an ``{"a5_runtime": ...}`` line,
   ``{"streaming_build": ...}``, ``{"bf16": ...}``, ``{"bf16_paths":
   ...}``, ``{"export": ...}``, ``{"data_prep": ...}``, ``{"parallel":
   ...}``, ``{"pretraining": ...}`` and a ``{"kernels": [...]}`` line
   (launches: each kernel's main path -- the full-UMPR run for K1-K6, the
   long-history training for K7/K8, the input-gradient run for K9, bf16
   UMPR-R training for the bf16 K1-K4 rows, bf16 full UMPR with the fused
   pool for the bf16 K5/K6 rows, the bf16 input gradient for K9's -- and
   the other runs' beside them, the remat step's, the R-Net pretraining
   CLI's, ``launches_rnet_pretraining``, and for K7/K8 the long-history
   f32 artifact's forward, ``launches_long_history_export``, among them),
   then, as
   the last line, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero without the last line.  Without a
CUDA device the script exits 2.  Work files go to build/chip_smoke/ in
the checkout.

    python3 chip_smoke.py --steps

builds K2, K8, the bf16 K4, K3, K2, K1 and K9 and the f32 K1 with one
design choice changed at a time (``K2_STEPS``, ``K8_STEPS``,
``K4_STEPS``, ``K3_STEPS``, ``K2_BF16_STEPS``, ``K1_BF16_STEPS``,
``K9_BF16_STEPS``, ``K1_F32_STEPS``: text edits of the final sources,
which tests/test_torch_chip_steps.py holds to today's sources on the
CPU) and times each beside the final kernel, K4's at each E of
``K4_WIDTHS`` and at ``K4_ROWS`` rows per chunk, bf16 K1's at
``K1_BF16_STEP_WIDTHS``, K9's at ``K9_BF16_STEP_SHAPES``, f32 K1's at
``K1_F32_STEP_WIDTHS``, bf16 K3's, K2's, K1's and K9's and f32 K1's with
their agreement with the plain version; then stops.

    python3 chip_smoke.py --turns <parent checkout>

builds the parent checkout's K1 and K9 sources beside this tree's and
times them on the same inputs in turns (parent, change, change, parent):
bf16 K1 at each ``BF16_WIDTHS`` E, bf16 K9 at each ``K9_BF16_AT`` shape,
f32 K1 at each ``K1_F32_TURN_WIDTHS`` E, each beside its library call and
its bound, and f32 UMPR-R's train step with a 300-d word table as a graph
of 4 steps with either K1; then f32 K4 and K9 of this tree at
``K49_F32_WIDTHS`` beside their library calls and bounds; then stops.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import itertools
import json
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F

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
from umpr_tpu_torch.train.optim import BETA2, make_optimizer
from umpr_tpu_torch.train.step import evaluate_mse, train_step

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FMA (non-tensor
# core) FLOP/s and dense TF32 tensor-core FLOP/s, at the full 700 W power
# limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12

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
# the training phases of PRs 1-11 stream every batch and build every split,
# as they did when their numbers were first taken (the resident corpus and
# the dataset cache have their own phase, a5_runtime_phase)
STREAMING = ("--device_dataset", "off", "--cache_dataset", "False")


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


PTXAS = {}  # source name -> ptxas_report of its build in this run (main fills it)


def _demangle(symbols):
    """The kernels' names without their namespace and parameters, through
    the toolkit's cu++filt (or c++filt); the mangled names where neither
    is at hand."""
    tool = Path(_build._nvcc()).with_name("cu++filt")
    tool = str(tool) if tool.exists() else shutil.which("c++filt")
    if tool is None or not symbols:
        return list(symbols)
    out = subprocess.run([tool], input="\n".join(symbols), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    if len(out) != len(symbols):
        return list(symbols)
    # "void <unnamed>::name<(bool)1>(args)" (cu++filt) or "(anonymous
    # namespace)::name(args)" (c++filt) -> "name<(bool)1>", "name"
    names = [re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "", n) for n in out]
    return [n[:n.index(">(") + 1] if ">(" in n else n.split("(")[0] for n in names]


def ptxas_report(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of each
    kernel in nvcc's -Xptxas=-v output."""
    lines, found = log.splitlines(), []
    for j, line in enumerate(lines[:-2]):
        m = re.search(r"Function properties for (\S+)", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", lines[j + 1])
        regs = re.search(r"Used (\d+) registers", lines[j + 2])
        if m and spill and regs:
            found.append((m.group(1), int(regs.group(1)), int(spill.group(1)),
                          int(spill.group(2))))
    names = _demangle([f[0] for f in found])
    return [(n,) + f[1:] for n, f in zip(names, found)]


def print_ptxas(source, report):
    for kernel, regs, stores, loads in report:
        print(f"  {source}: {kernel}: {regs} registers, {stores} bytes spill stores, "
              f"{loads} bytes spill loads")


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
# name them; a part's third entry names the kernel it is fused into on a
# route that launches no kernel of its own for it (K3's hg pass in the bf16
# sweep up to H = 128)
K2_PARTS = (("row order", ("bigru_row_order",)),
            ("recurrence", ("bigru_recurrence_kernel", "bigru_recurrence_bf16_kernel",
                            "bigru_recurrence_wide")))
K3_PARTS = (("hg pass", ("bigru_backward_hg",), "bigru_backward_bf16_sweep"),
            ("row order", ("bigru_row_order",)),
            ("sweep", ("bigru_backward_sweep", "bigru_backward_wide",
                       "bigru_backward_bf16_sweep")),
            ("dW pass", ("bigru_backward_dw",)), ("reduce", ("bigru_backward_reduce",)))


def part_split(fn, parts, steps=10):
    """A kernel's device ms per call by part (K2_PARTS: row order,
    recurrence; K3_PARTS: hg pass, row order, sweep, dW pass, reduce);
    "fused into <kernel>" for a part whose work ran inside that kernel,
    None for a part the profiler did not see."""
    split = device_split(fn, steps)

    def ms_of(kernels):
        return [t for name, t in split.items()
                if any(re.search(rf"\b{k}\s*[(<]", name) for k in kernels)]

    out = {}
    for part, kernels, *fused in parts:
        ms = ms_of(kernels)
        out[part] = sum(ms) if ms else None
        if not ms and fused and ms_of(fused):
            out[part] = f"fused into {fused[0]}"
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
    if isinstance(v, str):  # a part fused into another kernel
        return v
    return "not measured" if v is None else f"{v:.4f}"


def bound(n_bytes, flops, tf32_flops=0, bf16_flops=0):
    """Least time on the card in ms, and what sets it: `flops` f32
    operations on the CUDA cores, `tf32_flops` TF32 products on the tensor
    cores (3xTF32 counts its three), `bf16_flops` products of bf16
    operands at the bf16 tensor-core rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / F32_FLOP_PER_S + tf32_flops / TF32_FLOP_PER_S
             + bf16_flops / BF16_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(M, E, G, size):
    """K1's bound at (M, E, 6H = G) for `size`-byte IO: x, W, b read and
    xg written once, the bias adds on the CUDA cores, the products at the
    3xTF32 (f32) or bf16 tensor-core rate."""
    flops = 2 * M * E * G
    return bound(size * (M * E + E * G + G + M * G), M * G,
                 **({"tf32_flops": 3 * flops} if size == 4 else {"bf16_flops": flops}))


K1_F32_WIDTHS = (100, 200, 300)  # f32 K1 at GloVe's and word2vec's widths


def _past_f64(y, exact):
    """y's values past rtol = atol = 1e-5 of `exact` (the card tests'
    tolerance), and the largest |y - exact| / (1e-5 + 1e-5 |exact|)."""
    ratio = (y.double() - exact).abs() / (1e-5 + 1e-5 * exact.abs())
    return int((ratio > 1).sum()), ratio.max().item()


def k1_f32_widths(device, M, G, widths=K1_F32_WIDTHS):
    """f32 K1 at (M, E, G) for each E of `widths` (w scaled by sqrt(50 /
    E)), held against its plain version (max abs error within K1_TOL of
    the largest |xg|) and timed beside torch.addmm in f32 (TF32 off, as
    set_f32_parity leaves it) and its bound; "kernels" names the kernels
    the profiler saw (the route: gru_input_proj_wgmma up to E = 112,
    gru_input_proj_xt<vec> up to 352); "past_1e-5_f64" counts the kernel's and the f32 plain version's
    (cuBLAS's) values past rtol = atol = 1e-5 of the plain version in f64,
    beside the largest share of that bound.  Returns {E: {...}}."""
    out = {}
    for e in widths:
        g = torch.Generator(device=device).manual_seed(e)
        x = torch.randn(M, e, generator=g, device=device)
        w = torch.randn(e, G, generator=g, device=device) * (50 / e) ** 0.5
        b = torch.randn(G, generator=g, device=device)
        k1 = lambda: gru_cuda.gru_input_proj(x, w, b)  # noqa: E731
        xg = k1()
        torch.cuda.synchronize()
        want = gru_cuda.gru_input_proj_ref(x, w, b)
        err = (xg - want).abs().max().item()
        if not (err <= K1_TOL * want.abs().max().item() and torch.equal(k1(), xg)):
            raise AssertionError(f"f32 K1 at E = {e} disagrees with its plain version")
        exact = gru_cuda.gru_input_proj_ref(x.double(), w.double(), b.double())
        past = {"kernel": _past_f64(xg, exact), "plain_f32": _past_f64(want, exact)}
        del exact
        t_bound, by = k1_bound(M, e, G, 4)
        split = device_split(k1)
        out[e] = {"device_ms": sum(split.values()) if split else None,
                  "kernels": sorted(split), "bound_ms": t_bound, "bound_by": by,
                  "past_1e-5_f64": past,
                  "addmm_device_ms": device_ms(lambda: torch.addmm(b, x, w)),
                  "max_abs_err": err, "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        print(f"K1 f32 at E = {e}: device ms {_ms(out[e]['device_ms'])} ({out[e]['kernels']}), "
              f"torch.addmm {_ms(out[e]['addmm_device_ms'])} (TF32 {out[e]['allow_tf32']}), "
              f"bound {t_bound:.4f} ({by}); past 1e-5 of f64 (count, largest share): "
              f"kernel {past['kernel']}, plain f32 {past['plain_f32']}")
        del x, xg, want
        torch.cuda.empty_cache()
    return out


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
        "library_call": "torch.addmm", "at_E": k1_f32_widths(device, M, 6 * H)})

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


def step_sources(name, label, edits):
    """{file name: text} of csrc/<name>.cu and the headers with the step's
    edits [(file, text, replacement), ...] applied in order; raises where
    an edit's text is not in its file (the source moved on)."""
    out = {}
    for f in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / f"{name}.cu"]:
        text = f.read_text()
        for file, old, new in edits:
            if file == f.name:
                if old not in text:
                    raise AssertionError(f"step {label!r}: {old!r} is not in {file}")
                text = text.replace(old, new)
        out[f.name] = text
    return out


def build_steps(name, steps, argtypes, symbol=None):
    """csrc/<name>.cu (and the headers) with each entry of `steps` (label,
    [(file, text, replacement), ...]) applied (step_sources), built side
    by side into build/chip_smoke/steps/<symbol>/ (one nvcc each, all at
    once) and loaded.  Prints each kernel's registers and spills.  Returns
    {label: the C function `symbol` (default `name`)}.  Each symbol has a
    directory of its own: a second list of steps of the same source built
    into the same paths would load the libraries already loaded there."""
    root = WORK / "steps" / (symbol or name)
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (label, edits) in enumerate(steps):
        src = root / str(i)
        src.mkdir(parents=True)
        for file, text in step_sources(name, label, edits).items():
            (src / file).write_text(text)
        procs[label] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(src / "lib.so"),
             str(src / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for i, (label, proc) in enumerate(procs.items()):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"{name} step {label!r} did not build:\n{out}")
        print(f"{name} step {label!r}: built")
        print_ptxas(name, ptxas_report(out))
        fn = getattr(ctypes.CDLL(str(root / str(i) / "lib.so")), symbol or name)
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

    return pool_rows(per_shape, errs)


POOL_ROWS = (("bias_relu_pool", "bias_relu_pool.cu", "umpr_tpu/ops/pool_pallas.py:127",
              "F.max_pool2d(F.relu(x + b), 2, return_indices=True) on the NCHW view"),
             ("bias_relu_pool_bwd", "bias_relu_pool_bwd.cu", "umpr_tpu/ops/pool_pallas.py:152",
              "torch.autograd.grad of that max_pool2d(relu(x + b)) w.r.t. x and b"))


def pool_rows(per_shape, errs, suffix="", **extra):
    """K5's and K6's kernel rows: each timing summed over the shapes (the
    numbers of one train step), the shapes' own beside them."""
    kernel_rows = []
    for base, src, replaces, call in POOL_ROWS:
        name = base + suffix
        parts = per_shape[name]
        total = {k: None if any(p[k] is None for p in parts) else sum(p[k] for p in parts)
                 for k in ("ms", "plain_ms", "device_ms", "library_ms", "library_device_ms",
                           "bound_ms")}
        kernel_rows.append({
            "name": name, "route": "cuda", "source": f"umpr_tpu_torch/csrc/{src}",
            "replaces": replaces, **extra, "max_abs_err": errs[name], **total,
            "bound_by": "bytes" if all(p["bound_by"] == "bytes" for p in parts)
            else "operations",
            "library_call": call + (" (bf16)" if suffix else ""), "per_shape": parts})
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


# K4's bf16 kernel (csrc/gru_input_proj_bwd.cu) with one design choice
# changed at a time, text edits of the final source: the stage depths, and
# up to which E x's rows are copied whole (each block copies its E tile
# past that)
K4_STAGES = "constexpr int B16_STAGES = 4;"
K4_FEW = "constexpr int B16_FEW_STAGES = 2;"
K4_FOUR = "constexpr int B16_FOUR_STAGES_MAX_E = 52;"
K4_WHOLE = "  if (E <= B16_FOUR_STAGES_MAX_E)"
K4_XS = "  const int XS = E <= EW ? E : EW;"
K4_STEPS = (
    ("final", []),
    ("3 stages", [("gru_input_proj_bwd.cu", K4_STAGES, "constexpr int B16_STAGES = 3;")]),
    ("3 stages past E = 52", [("gru_input_proj_bwd.cu", K4_FEW,
                               "constexpr int B16_FEW_STAGES = 3;")]),
    ("4 stages past E = 52", [("gru_input_proj_bwd.cu", K4_FEW,
                               "constexpr int B16_FEW_STAGES = 4;")]),
    ("4 stages to E = 58", [("gru_input_proj_bwd.cu", K4_FOUR,
                             "constexpr int B16_FOUR_STAGES_MAX_E = 58;")]),
    ("whole rows, 4 stages, to E = 286",
     [("gru_input_proj_bwd.cu", K4_WHOLE, "  if (bf16_smem<B16_STAGES>(E) <= SMEM_LIMIT)")]),
    ("whole rows, 2 stages, to E = 708",
     [("gru_input_proj_bwd.cu", K4_XS,
       "  const int XS = bf16_smem<B16_FEW_STAGES>(E) <= SMEM_LIMIT ? E : EW;")]))
K4_ROWS = (384, 512, 640, 768, 1216, 2432)  # rows per chunk the final kernel is timed at
K4_WIDTHS = (50, 52, 53, 58, 64, 65, 256, 300, 521, 709, 1617)  # E each step is timed at
K4_PARTS = (("main", ("gru_input_proj_bwd_bf16_kernel",)),
            ("reduce", ("gru_input_proj_bwd_reduce",)))


def k4_steps_phase(device, M=51200, G=384, widths=K4_WIDTHS):
    """K4's bf16 kernel: each step of K4_STEPS at proj_bwd_bf16_chunks(M)
    and each E of `widths`, and the final kernel at K4_ROWS rows per chunk
    (E = 50), each timed (device ms under torch.profiler, main and reduce
    kernel) and held against the plain version within SUM_RTOL.  Returns
    {label: {E: {"main": ms, "reduce": ms}}}."""
    fns = build_steps("gru_input_proj_bwd", K4_STEPS,
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                      "gru_input_proj_bwd_bf16")
    rows_m = gru_cuda.proj_bwd_bf16_chunks(M)[0]
    times = {}
    for E in widths:
        g = torch.Generator(device=device).manual_seed(E)
        x = (torch.randn(M, E, generator=g, device=device) * 0.5).to(torch.bfloat16)
        dxg = torch.randn(M, G, generator=g, device=device).to(torch.bfloat16)
        want = gru_cuda.gru_input_proj_bwd_ref(x, dxg)
        runs = [(label, fn, rows_m) for label, fn in fns.items()]
        if E == 50:
            runs += [(f"final at {rows} rows a chunk", fns["final"], rows) for rows in K4_ROWS]
        for label, fn, rows in runs:
            chunks = -(-M // rows)
            part = torch.empty((E * G + G) * chunks, device=device)
            out = torch.empty(E * G + G, device=device)

            def call(fn=fn, rows=rows, chunks=chunks, part=part, out=out, label=label, E=E):
                err = fn(x.data_ptr(), dxg.data_ptr(), part.data_ptr(),
                         part.data_ptr() + 4 * E * G * chunks, out.data_ptr(),
                         out.data_ptr() + 4 * E * G, M, E, G, rows,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise AssertionError(f"K4 step {label!r} failed to launch: {err}")

            call()
            torch.cuda.synchronize()
            _l2_check(out[:E * G].view(E, G), want[0], f"K4 step {label!r} dW at E = {E}")
            _l2_check(out[E * G:], want[1], f"K4 step {label!r} db at E = {E}")
            times.setdefault(label, {})[E] = part_split(call, K4_PARTS, steps=20)
            print(f"K4 bf16 step {label!r} at E = {E} ({chunks} chunks of {rows}): device ms "
                  + ", ".join(f"{k} {_ms(v)}" for k, v in times[label][E].items()))
        del x, dxg, want, part, out
        torch.cuda.empty_cache()
    return times


# bf16 K3's sweep (csrc/bigru_backward.cu bigru_backward_bf16_sweep), each
# design choice taken back out of the final source at a time: (label,
# [(file, text, replacement), ...]); python3 chip_smoke.py --steps builds
# and times each.  "hg pass and Z read back": the hg pass writes Z and the
# sweep reads it at tp (a step ahead, as xg), in place of the fused
# product; "product on the CUDA cores": ghh W^T as f32 FMAs from the same
# shared tiles; "two barriers a step": one ghh tile, a barrier after its
# reads; "outputs stored from the gate phase's registers": each lane
# stores its own (row, unit) pairs (4 or 8 bytes, 8 rows a warp store)
# in place of the staged 16-byte row pieces; "sum started at g z": the
# product's k-steps added to g z, not g z to their sum; "accumulators
# chained": each product's k-steps summed in the mma's accumulators, not
# each k-step's added in f32
K3_HG_ADDS = """        float p0[4] = {}, p1[4] = {};
        mma_bf16(p0, a, w4[0], w4[1]);
        mma_bf16(p1, a, w4[2], w4[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hg[gate][0][i] += p0[i];
          hg[gate][1][i] += p1[i];
        }
"""
K3_MMA_HG = """#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        uint32_t w4[4];
        ldsm_x4_trans(w4, ws + (16 * kk + 8 * (mat & 1) + mr) * WS + gate * HP + u0 + 8 * (mat >> 1));
""" + K3_HG_ADDS + """      }
"""
K3_FETCH = "        dyp[q][h] = ld_pair(dy_pos + at * ys + d * H + u, lo, hi, pairs);\n"
K3_GATES = "    // the gates; ghh rounded into this step's tile\n"
K3_G_ADDS = """      float p0[4] = {}, p1[4] = {};
      mma_bf16(p0, a, w4[0], w4[1]);
      mma_bf16(p1, a, w4[2], w4[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[0][i] += p0[i];
        acc[1][i] += p1[i];
      }
"""
K3_MMA_PRODUCT = """#pragma unroll 4
    for (int kk = 0; kk < 3 * KH; ++kk) {
      uint32_t a[4], w4[4];
      ldsm_x4(a, ght + (8 * (mat & 1) + mr) * GS + 16 * kk + 8 * (mat >> 1));
      ldsm_x4(w4, ws + (u0 + 8 * (mat >> 1) + mr) * WS + 16 * kk + 8 * (mat & 1));
""" + K3_G_ADDS + """    }
"""
K3_CUDA_CORE_PRODUCT = """#pragma unroll 4
    for (int c = 0; c < 3 * HP; c += 2) {
      float a2[2][2], w2[2][2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(ght + (gq + 8 * q) * GS + c);
        a2[q][0] = lo_f(v);
        a2[q][1] = hi_f(v);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t v =
              *reinterpret_cast<const uint32_t*>(ws + (u0 + 8 * h + 2 * tq + e) * WS + c);
          w2[h][e][0] = lo_f(v);
          w2[h][e][1] = hi_f(v);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[h][2 * q + e] = fmaf(a2[q][1], w2[h][e][1],
                                     fmaf(a2[q][0], w2[h][e][0], acc[h][2 * q + e]));
    }
"""
K3_EMIT = "    emit(t, s & 1, false);\n"
K3_LAST = "          if (t < len[q]) g[q][h][e] = gz[q][h][e] + acc[h][2 * q + e];\n"
K3_STAGED = """        const int at = (gq + 8 * q) * GS + u0 + 8 * h + 2 * tq;
        *reinterpret_cast<uint32_t*>(ght + at) = round_pair(dr[0], dr[1]);
        *reinterpret_cast<uint32_t*>(ght + at + HP) = round_pair(dz[0], dz[1]);
        *reinterpret_cast<uint32_t*>(ght + at + 2 * HP) = round_pair(dhn[0], dhn[1]);
        *reinterpret_cast<uint32_t*>(ght + at + 3 * HP) = round_pair(dn[0], dn[1]);
        float* o = ob + (s & 1) * ROWS * OS + (gq + 8 * q) * OS + u0 + 8 * h + 2 * tq;
        *reinterpret_cast<float2*>(o) = make_float2(dr[0], dr[1]);
        *reinterpret_cast<float2*>(o + HP) = make_float2(dz[0], dz[1]);
        *reinterpret_cast<float2*>(o + 2 * HP) = make_float2(dhn[0], dhn[1]);
"""
K3_ZERO_STEPS = "  for (int t = maxlen; t < L; ++t) emit(t, 0, true);\n"
K3_REGISTER_STORES = [
    ("bigru_backward.cu", K3_ZERO_STEPS, """  auto store = [&](int q, int h, int t, const float (&dr)[2], const float (&dz)[2],
                   const float (&dn)[2], const float (&dhn)[2]) {
    if (row[q] < 0 || !ok[h][0]) return;
    const size_t at = (size_t)row[q] * L + t;
    const int u = u0 + 8 * h + 2 * tq;
    bf16* o = dxg + at * xs + d * G + u;
    float* zo = zbuf + at * xs + d * G + u;
    float* go = ghn + at * ys + d * H + u;
    if (pairs) {
      *reinterpret_cast<uint32_t*>(o) = round_pair(dr[0], dr[1]);
      *reinterpret_cast<uint32_t*>(o + H) = round_pair(dz[0], dz[1]);
      *reinterpret_cast<uint32_t*>(o + 2 * H) = round_pair(dn[0], dn[1]);
      *reinterpret_cast<float2*>(zo) = make_float2(dr[0], dr[1]);
      *reinterpret_cast<float2*>(zo + H) = make_float2(dz[0], dz[1]);
      *reinterpret_cast<float2*>(go) = make_float2(dhn[0], dhn[1]);
      return;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (ok[h][e]) {
        o[e] = io_from<bf16>(dr[e]);
        o[H + e] = io_from<bf16>(dz[e]);
        o[2 * H + e] = io_from<bf16>(dn[e]);
        zo[e] = dr[e];
        zo[H + e] = dz[e];
        go[e] = dhn[e];
      }
  };
  {
    const float z2[2] = {0.f, 0.f};
    for (int t = maxlen; t < L; ++t)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) store(q, h, t, z2, z2, z2, z2);
  }
"""),
    ("bigru_backward.cu", K3_STAGED, """        store(q, h, t, dr, dz, dn, dhn);
        const int at = (gq + 8 * q) * GS + u0 + 8 * h + 2 * tq;
        *reinterpret_cast<uint32_t*>(ght + at) = round_pair(dr[0], dr[1]);
        *reinterpret_cast<uint32_t*>(ght + at + HP) = round_pair(dz[0], dz[1]);
        *reinterpret_cast<uint32_t*>(ght + at + 2 * HP) = round_pair(dhn[0], dhn[1]);
"""),
    ("bigru_backward.cu", K3_EMIT, "")]
K3_STEPS = (
    ("final", []),
    ("hg pass and Z read back", [
        ("bigru_backward.cu", "    if (!is_bf16<T> || H > SWEEP_MAX_H) {", "    if (true) {"),
        ("bigru_backward.cu", "  uint32_t xin[2][3][2], dys[2][2], dyp[2][2];\n",
         "  uint32_t xin[2][3][2], dys[2][2], dyp[2][2];\n  float zin[2][3][2][2];\n"),
        ("bigru_backward.cu", K3_FETCH, K3_FETCH + """        const int tp = d == 0 ? t - 1 : t + 1;
        const bool pv = live && tp >= 0 && tp < len[q];
        const float* zp = zbuf + (pv ? ((size_t)row[q] * L + tp) * xs : 0) + d * G + u;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            zin[q][gate][h][e] = pv && ok[h][e] ? zp[gate * H + e] : 0.f;
"""),
        ("bigru_backward.cu", K3_MMA_HG, ""),
        ("bigru_backward.cu", K3_GATES, """#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) hg[gate][h][2 * q + e] = zin[q][gate][h][e];
""" + K3_GATES)]),
    ("product on the CUDA cores", [("bigru_backward.cu", K3_MMA_PRODUCT, K3_CUDA_CORE_PRODUCT)]),
    ("two barriers a step", [
        ("bigru_backward.cu", "    bf16* ght = gh + (s & 1) * ROWS * GS;", "    bf16* ght = gh;"),
        ("bigru_backward.cu", "    const bf16* gt = gh + buf * ROWS * GS;", "    const bf16* gt = gh;"),
        ("bigru_backward.cu", K3_EMIT, K3_EMIT + "    __syncthreads();\n")]),
    ("outputs stored from the gate phase's registers", K3_REGISTER_STORES),
    ("sum started at g z", [
        ("bigru_backward.cu", "    float acc[2][4] = {};\n", """    float acc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[h][2 * q + e] = gz[q][h][e];
"""),
        ("bigru_backward.cu", K3_LAST, K3_LAST.replace("gz[q][h][e] + ", ""))]),
    ("accumulators chained", [
        ("bigru_backward.cu", K3_HG_ADDS, """        mma_bf16(hg[gate][0], a, w4[0], w4[1]);
        mma_bf16(hg[gate][1], a, w4[2], w4[3]);
"""),
        ("bigru_backward.cu", K3_G_ADDS, """      mma_bf16(acc[0], a, w4[0], w4[1]);
      mma_bf16(acc[1], a, w4[2], w4[3]);
""")]))
K3_STEP_WIDTHS = (64, 128)  # H each K3 step is timed at (N = 2560, L = 20)


def _k2_bf16_operands(device, N, L, H, E=50):
    """bf16 K2 inputs at (N, L, H) as bf16_kernel_phase makes them at H =
    64: x ~ N(0, 0.25) through K1 with a BiGRU's initial weights (seeded
    by H), lengths uniform in 1 .. L.  Returns (xg, lengths, w_hh, b_hh)."""
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(H)
    x = (torch.randn(N * L, E, generator=g) * 0.5).to(device).to(bf)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32).to(device)
    gru = BiGRU(E, H, generator=g).to(device)
    w_ih, b_ih, w_hh, b_hh = (t.detach().to(bf) for t in gru.kernel_operands())
    xg = gru_cuda.gru_input_proj(x, w_ih, b_ih).view(N, L, 6 * H)
    return xg, lengths, w_hh, b_hh


def _k3_bf16_operands(device, N, L, H, E=50):
    """bf16 K3 inputs at (N, L, H): _k2_bf16_operands, y from K2,
    cotangents N(0, 1)."""
    bf = torch.bfloat16
    xg, lengths, w_hh, b_hh = _k2_bf16_operands(device, N, L, H, E)
    y = gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)
    gd = torch.Generator(device=device).manual_seed(H + 1)
    dy_sent, dy_pos = (torch.randn(N, L, 2 * H, generator=gd, device=device).to(bf)
                       for _ in range(2))
    return xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh


def k3_steps_phase(device, widths=K3_STEP_WIDTHS, N=2560, L=20):
    """bf16 K3 with one design choice of its sweep taken back at a time
    (K3_STEPS), each built beside the final source, held against the plain
    version (dxg within one bf16 ulp but for a BF16_PAST_ULP share, dW /
    db within SUM_RTOL) and timed by part (device ms under torch.profiler)
    at each H of `widths`.  A step that misses the tolerance is reported
    (its agreement is part of what the step measures); the final source
    raises.  Returns {label: {H: parts and agreement}}."""
    fns = build_steps("bigru_backward", K3_STEPS,
                      [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                      "bigru_backward_bf16")
    times = {label: {} for label in fns}
    for H in widths:
        xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh = _k3_bf16_operands(device, N, L, H)
        want = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
        rows, chunks = gru_cuda.bwd_chunks(N * L)
        n_dw = 2 * H * 3 * H
        for label, fn in fns.items():
            dxg = torch.empty(N, L, 6 * H, device=device, dtype=torch.bfloat16)
            zbuf = torch.empty(N, L, 6 * H, device=device)
            ghn = torch.empty(N, L, 2 * H, device=device)
            order = torch.empty(N, device=device, dtype=torch.int32)
            part = torch.empty(chunks * (n_dw + 2 * 3 * H), device=device)
            out = torch.empty(n_dw + 2 * 3 * H, device=device)

            def call(fn=fn, dxg=dxg, zbuf=zbuf, ghn=ghn, order=order, part=part, out=out,
                     label=label):
                err = fn(xg.data_ptr(), y.data_ptr(), dy_sent.data_ptr(), dy_pos.data_ptr(),
                         lengths.data_ptr(), w_hh.data_ptr(), None, b_hh.data_ptr(),
                         dxg.data_ptr(), zbuf.data_ptr(), ghn.data_ptr(), order.data_ptr(),
                         None, part.data_ptr(), part.data_ptr() + 4 * n_dw * chunks,
                         out.data_ptr(), out.data_ptr() + 4 * n_dw, N, L, H, rows,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise AssertionError(f"K3 step {label!r} failed to launch: {err}")

            call()
            torch.cuda.synchronize()
            where = f"K3 bf16 step {label!r} at H = {H}"
            past, within = _bf16_agreement(dxg, want[0], f"{where}: dxg")
            rel = {k: ((got - ref).norm() / ref.norm()).item() for k, got, ref in (
                ("dw_rel", out[:n_dw].view(2, H, 3 * H), want[1]),
                ("db_rel", out[n_dw:].view(2, 3 * H), want[2]))}
            within = within and max(rel.values()) <= SUM_RTOL
            print(f"{where}: dW, db relative to their norms {rel['dw_rel']:.3e}, "
                  f"{rel['db_rel']:.3e} (tolerance {SUM_RTOL:.0e}); within tolerance {within}")
            if label == "final" and not within:
                raise AssertionError("K3's final bf16 source disagrees with its plain version")
            parts = part_split(call, K3_PARTS)
            print_split(where, parts)
            times[label][H] = {**parts, "dxg_past_ulp": past, **rel, "within_tolerance": within}
        del xg, y, want, dxg, zbuf, ghn, part, out
        torch.cuda.empty_cache()
    return times


# bf16 K2 timed beside the UMPR-R shape: H = 128 (the last H of its mma.sync
# kernel) and the bf16 long-history shape (N = 2 B S + 1, maxlen 64)
K2_BF16_AT = ((2560, 20, 128), (16385, 64, 64))


# bf16 K2's kernel (csrc/bigru_recurrence.cu bigru_recurrence_bf16_kernel),
# each design choice taken back out of the final source at a time: (label,
# [(file, text, replacement), ...]); python3 chip_smoke.py --steps builds
# and times each.  "product on the CUDA cores": round(h) W_hh as f32 FMAs
# from the same shared tiles; "accumulators chained": the k-steps summed in
# the mma's accumulators, not each added in f32; "sum started at b": b_hh
# first, the k-steps added to it; "no register cap": __launch_bounds__
# without a minimum of blocks an SM; "W_hh's fragments in registers":
# held for the whole sweep in place of an ldmatrix.trans per k-step and
# gate, without the cap (it spills under it); "y stored from the gate
# phase's registers": each lane stores its own (row, unit) pairs in place
# of the staged 16-byte row pieces; "xg loaded after the product": at the
# step, not a step ahead
K2B_MMA_ADDS = """        float p0[4] = {}, p1[4] = {};
        mma_bf16(p0, a, w4[0], w4[1]);
        mma_bf16(p1, a, w4[2], w4[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hg[gate][0][i] += p0[i];
          hg[gate][1][i] += p1[i];
        }
"""
K2B_MMA = """#pragma unroll
    for (int kk = 0; kk < KH; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, hc + (8 * (mat & 1) + mr) * SS + 16 * kk + 8 * (mat >> 1));
"""
K2B_W_FRAGMENTS = """        ldsm_x4_trans(w4, ws + (16 * kk + 8 * (mat & 1) + mr) * WS + gate * HP + u0 +
                              8 * (mat >> 1));
"""
K2B_PRODUCT = K2B_MMA + """#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        uint32_t w4[4];  // b0, b1 of the warp's two n8 tiles
""" + K2B_W_FRAGMENTS + K2B_MMA_ADDS + """      }
    }
"""
K2B_BOUNDS = "__launch_bounds__(32 * KH, KH <= 4 ? 3 : 2)"
K2B_NO_CAP = ("bigru_recurrence.cu", K2B_BOUNDS, "__launch_bounds__(256)")
K2B_CUDA_CORES = """#pragma unroll 4
    for (int k = 0; k < HP; k += 2) {
      float a2[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(hc + (gq + 8 * q) * SS + k);
        a2[q][0] = lo_f(v);
        a2[q][1] = hi_f(v);
      }
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(
                ws + (k + j) * WS + gate * HP + u0 + 8 * h + 2 * tq);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              hg[gate][h][2 * q] = fmaf(a2[q][j], lo_f(v), hg[gate][h][2 * q]);
              hg[gate][h][2 * q + 1] = fmaf(a2[q][j], hi_f(v), hg[gate][h][2 * q + 1]);
            }
          }
    }
"""
K2B_HG_INIT = "    float hg[3][2][4] = {};\n"
K2B_EMIT = "    if (s > 0) emit(d == 0 ? t - 1 : t + 1, hc, false);  // the step before, from its tile\n"
K2B_LAST_EMIT = ("  if (maxlen > 0) emit(d == 0 ? maxlen - 1 : 0, hb + (maxlen & 1) * ROWS * SS, "
                 "false);\n")
K2B_STATE_STORE = ("        *reinterpret_cast<uint32_t*>(hn + (gq + 8 * q) * SS + u0 + 8 * h + 2 * tq)"
                   " =\n")
K2B_FIRST_FETCH = "  if (maxlen > 0) fetch(d == 0 ? 0 : maxlen - 1);  // the first step's xg\n"
K2B_NEXT_FETCH = "    if (s + 1 < maxlen) fetch(d == 0 ? t + 1 : t - 1);  // the next step's, ahead\n"
K2B_GATES = "    // the gates at valid steps (an invalid one leaves the state frozen);\n"
K2_BF16_STEPS = (
    ("final", []),
    ("product on the CUDA cores", [("bigru_recurrence.cu", K2B_PRODUCT, K2B_CUDA_CORES)]),
    ("accumulators chained", [("bigru_recurrence.cu", K2B_MMA_ADDS, """\
        mma_bf16(hg[gate][0], a, w4[0], w4[1]);
        mma_bf16(hg[gate][1], a, w4[2], w4[3]);
""")]),
    ("sum started at b", [
        ("bigru_recurrence.cu", K2B_HG_INIT, """    float hg[3][2][4];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) hg[gate][h][i] = b[gate][h][i & 1];
"""),
        ("bigru_recurrence.cu", " + b[0][h][e];", ";"),
        ("bigru_recurrence.cu", " + b[1][h][e];", ";"),
        ("bigru_recurrence.cu", " + b[2][h][e];", ";")]),
    ("no register cap (two blocks an SM at H = 64)", [K2B_NO_CAP]),
    ("W_hh's fragments in registers, no register cap", [
        K2B_NO_CAP,
        ("bigru_recurrence.cu", "  const size_t xs = 6 * (size_t)H, ys = 2 * (size_t)H;\n", """\
  uint32_t wf[KH][3][4];
#pragma unroll
  for (int kk = 0; kk < KH; ++kk)
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
      ldsm_x4_trans(wf[kk][gate],
                    ws + (16 * kk + 8 * (mat & 1) + mr) * WS + gate * HP + u0 + 8 * (mat >> 1));
  const size_t xs = 6 * (size_t)H, ys = 2 * (size_t)H;
"""),
        ("bigru_recurrence.cu", K2B_W_FRAGMENTS, """\
#pragma unroll
        for (int i = 0; i < 4; ++i) w4[i] = wf[kk][gate][i];
""")]),
    ("y stored from the gate phase's registers", [
        ("bigru_recurrence.cu", K2B_EMIT, ""),
        ("bigru_recurrence.cu", K2B_LAST_EMIT, ""),
        ("bigru_recurrence.cu", K2B_STATE_STORE, """\
        if (row[q] >= 0) {
          bf16* o = y + ((size_t)row[q] * L + t) * ys + d * H + u0 + 8 * h + 2 * tq;
          const bool live = t < len[q];
          if (pairs) {
            if (ok[h][0])
              *reinterpret_cast<uint32_t*>(o) = live ? round_pair(st[q][h][0], st[q][h][1]) : 0u;
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (ok[h][e]) o[e] = live ? __float2bfloat16(st[q][h][e]) : zero;
          }
        }
""" + K2B_STATE_STORE)]),
    ("xg loaded after the product", [
        ("bigru_recurrence.cu", K2B_FIRST_FETCH, ""),
        ("bigru_recurrence.cu", K2B_NEXT_FETCH, ""),
        ("bigru_recurrence.cu", K2B_GATES, "    fetch(t);\n" + K2B_GATES)]),
)
# (N, L, H) each K2 bf16 step is timed at
K2_BF16_STEP_SHAPES = ((2560, 20, 64),) + K2_BF16_AT


def k2_bf16_steps_phase(device, shapes=K2_BF16_STEP_SHAPES):
    """bf16 K2 with one design choice taken back at a time (K2_BF16_STEPS),
    each built beside the final source, held against the plain version
    (y within one bf16 ulp but for a BF16_PAST_ULP share) and timed by
    part (device ms under torch.profiler) at each shape.  A step that
    misses the tolerance is reported (its agreement is part of what the
    step measures); the final source raises.  Returns {label: {"NxLxH":
    parts and agreement}}."""
    fns = build_steps("bigru_recurrence", K2_BF16_STEPS,
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                      "bigru_recurrence_bf16")
    times = {label: {} for label in fns}
    for N, L, H in shapes:
        xg, lengths, w_hh, b_hh = _k2_bf16_operands(device, N, L, H)
        want = gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
        order = torch.empty(N, device=device, dtype=torch.int32)
        for label, fn in fns.items():
            y = torch.empty(N, L, 2 * H, device=device, dtype=torch.bfloat16)

            def call(fn=fn, y=y, label=label):
                err = fn(xg.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                         y.data_ptr(), order.data_ptr(), None, N, L, H,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise AssertionError(f"K2 bf16 step {label!r} failed to launch: {err}")

            call()
            torch.cuda.synchronize()
            where = f"K2 bf16 step {label!r} at (N, L, H) = {(N, L, H)}"
            past, within = _bf16_agreement(y, want, where)
            if label == "final" and not within:
                raise AssertionError("K2's final bf16 source disagrees with its plain version")
            parts = part_split(call, K2_PARTS)
            print_split(where, parts)
            times[label][f"{N}x{L}x{H}"] = {**parts, "y_past_ulp": past,
                                            "within_tolerance": within}
        del xg, want, y
        torch.cuda.empty_cache()
    return times


# bf16 K1's streaming kernel (csrc/gru_input_proj.cu
# gru_input_proj_bf16_stream, 256 < E <= 544) and bf16 K9's wgmma kernel
# (csrc/gru_input_proj_dx.cu gru_input_proj_dx_bf16_wgmma), each design
# choice taken back at a time: (label, [(file, text, replacement), ...]).
# "one k16 step a group": each step's wgmma issued alone behind a wait for
# the step before, in a branch past the last step (ptxas then serialises
# every wgmma, its C7520 warning); "W in order": every block reads K1's W
# slice from its first item; "scalar W loads": K1's W slice as 2-byte
# loads (the E <= 256 kernel's loader too); stages, chunk width and
# warpgroups a block as named; "grid of one block an SM": K9's walkers
# unbalanced (a few warpgroups take one tile more than the rest); the
# "timing only" steps leave out a part of the work (their results are
# wrong) to show what the rest costs.
K1S_GROUPS = """    uint32_t a[KSC][4];
    for (int c = 0; c < NC; ++c) {
      cp_async_wait<STAGES - 2>();  // chunk g has landed ...
      named_barrier(1 + wg, WG);    // ... for the warpgroup, which has read chunk g - 1
      fetch(g + STAGES - 1);        // into chunk g - 1's stage
      const bf16* chunk = ring + g % STAGES * BM * XS;
      ++g;
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < KSC; ++j)
        chunk_a<U>(a[j], chunk, XS, 16 * j, K - c * KC, warp, lane, sh0, sh8);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSC; ++j)
        WgmmaBf16<BN>::run(acc, a[j], desc(wt + min(c * KSC + j, KS - 1) * B16_WT),
                           c * KSC + j > 0);
      wgmma_commit();
    }
"""
K1S_STEPWISE = """    uint32_t a0[4], a1[4];
    const bf16* chunk = ring;
    auto step = [&](int ks, uint32_t(&a)[4]) {
      if (ks % KSC == 0) {
        cp_async_wait<STAGES - 2>();
        named_barrier(1 + wg, WG);
        fetch(g + STAGES - 1);
        chunk = ring + g % STAGES * BM * XS;
        ++g;
      }
      chunk_a<U>(a, chunk, XS, ks % KSC * 16, K - ks / KSC * KC, warp, lane, sh0, sh8);
      wgmma_fence();
      WgmmaBf16<BN>::run(acc, a, desc(wt + ks * B16_WT), ks > 0);
      wgmma_commit();
      wgmma_wait<1>();
    };
    for (int ks = 0; ks < KS; ks += 2) {
      step(ks, a0);
      if (ks + 1 < KS) step(ks + 1, a1);
    }
"""
K1S_PRODUCT = """        WgmmaBf16<BN>::run(acc, a[j], desc(wt + min(c * KSC + j, KS - 1) * B16_WT),
                           c * KSC + j > 0);"""
K1_BF16_STEPS = (
    ("final", []),
    ("one k16 step a group", [("gru_input_proj.cu", K1S_GROUPS, K1S_STEPWISE)]),
    ("W in order", [("gru_input_proj.cu", "  const int rot = blockIdx.y * threads;",
                     "  const int rot = 0;")]),
    ("scalar W loads", [("gru_input_proj.cu",
                         "  if (N % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {",
                         "  if (K < 0) {")]),
    ("2 stages", [("gru_input_proj.cu", "constexpr int STAGES = 3;", "constexpr int STAGES = 2;")]),
    ("4 stages (to E = 480)", [("gru_input_proj.cu", "constexpr int STAGES = 3;",
                                "constexpr int STAGES = 4;")]),
    ("3 warpgroups (to E = 368)", [("gru_input_proj.cu", "constexpr int S_WGS = 2;",
                                    "constexpr int S_WGS = 3;")]),
    ("chunks of 128 (to E = 352)", [("gru_input_proj.cu", "constexpr int KC = 64; ",
                                     "constexpr int KC = 128;")]),
    ("no x copies (timing only)", [("gru_input_proj.cu", "      copy_rows<U, KC>(",
                                    "      if (M < 0) copy_rows<U, KC>(")]),
    ("no products (timing only)", [("gru_input_proj.cu", K1S_PRODUCT, "        ;")]),
    ("no stores (timing only)", [("gru_input_proj.cu", "    store_tile(acc, bias, stage, out",
                                  "    if (M < 0) store_tile(acc, bias, stage, out")]))
K1_BF16_STEP_WIDTHS = (256, 257, 300, 400, 520)  # E each K1 step is timed at (M = 51,200)
K9S_GROUPS = """      uint32_t a[D_KSC][4];
      for (int c = 0; c < NC3; ++c) {
        cp_async_wait<D_STAGES - 2>();  // chunk g has landed ...
        named_barrier(1 + wg, WG);      // ... for the warpgroup, which has read chunk g - 1
        fetch(g + D_STAGES - 1);        // into chunk g - 1's stage
        const bf16* chunk = ring + g % D_STAGES * BM * D_XS;
        ++g;
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < D_KSC; ++j)
          chunk_a<U>(a[j], chunk, D_XS, 16 * j, K3 - c * D_KC, warp, lane, sh0, sh8);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < D_KSC; ++j)
          WgmmaBf16<BN>::run(acc, a[j], desc(wt + (d * KS3 + min(c * D_KSC + j, KS3 - 1)) * WT),
                             c * D_KSC + j > 0);
        wgmma_commit();
      }
"""
K9S_STEPWISE = """      uint32_t a0[4], a1[4];
      const bf16* chunk = ring;
      auto step = [&](int s, uint32_t(&a)[4]) {
        if (s % D_KSC == 0) {
          cp_async_wait<D_STAGES - 2>();
          named_barrier(1 + wg, WG);
          fetch(g + D_STAGES - 1);
          chunk = ring + g % D_STAGES * BM * D_XS;
          ++g;
        }
        chunk_a<U>(a, chunk, D_XS, s % D_KSC * 16, K3 - s / D_KSC * D_KC, warp, lane, sh0, sh8);
        wgmma_fence();
        WgmmaBf16<BN>::run(acc, a, desc(wt + (d * KS3 + s) * WT), s > 0);
        wgmma_commit();
        wgmma_wait<1>();
      };
      for (int s = 0; s < KS3; s += 2) {
        step(s, a0);
        if (s + 1 < KS3) step(s + 1, a1);
      }
      wgmma_wait<0>();
"""
K9S_NO_COPIES = ("gru_input_proj_dx.cu", "      copy_rows<U, D_KC>(",
                 "      if (M < 0) copy_rows<U, D_KC>(")
K9S_NO_PRODUCTS = ("gru_input_proj_dx.cu", """          WgmmaBf16<BN>::run(acc, a[j], desc(wt + (d * KS3 + min(c * D_KSC + j, KS3 - 1)) * WT),
                             c * D_KSC + j > 0);""", "          ;")
K9S_NO_W = ("gru_input_proj_dx.cu", "  for (int i = tid; i < 2 * KS3 * BN * 2; i += WG * D_WGS) {",
            "  for (int i = tid; i < 2 * KS3 * BN * 2 * (M < 0); i += WG * D_WGS) {")
K9_BF16_STEPS = (
    ("final", []),
    ("one k16 step a group", [("gru_input_proj_dx.cu", K9S_GROUPS, K9S_STEPWISE)]),
    ("grid of one block an SM", [("gru_input_proj_dx.cu", """  const int walkers = std::max(1, (m_tiles + each * D_WGS - 1) / (each * D_WGS));""",
                                  """  const int walkers = std::max(1, std::min((m_tiles + D_WGS - 1) / D_WGS, per_col));""")]),
    ("2 stages", [("gru_input_proj_dx.cu", "constexpr int D_STAGES = 3;", "constexpr int D_STAGES = 2;")]),
    ("4 stages", [("gru_input_proj_dx.cu", "constexpr int D_STAGES = 3;", "constexpr int D_STAGES = 4;")]),
    ("2 warpgroups", [("gru_input_proj_dx.cu", "constexpr int D_WGS = 3;", "constexpr int D_WGS = 2;")]),
    ("2 warpgroups, 4 stages", [("gru_input_proj_dx.cu", "constexpr int D_WGS = 3;", "constexpr int D_WGS = 2;"),
                                ("gru_input_proj_dx.cu", "constexpr int D_STAGES = 3;", "constexpr int D_STAGES = 4;")]),
    ("chunks of 128", [("gru_input_proj_dx.cu", "constexpr int D_KC = 64; ", "constexpr int D_KC = 128;")]),
    ("no dxg copies (timing only)", [K9S_NO_COPIES]),
    ("no products (timing only)", [K9S_NO_PRODUCTS]),
    ("no W load (timing only)", [K9S_NO_W]),
    ("no copies, products or W load (timing only)", [K9S_NO_COPIES, K9S_NO_PRODUCTS, K9S_NO_W]))
K9_BF16_STEP_SHAPES = ((51200, 384, 50), (51200, 384, 64), (51200, 102, 50), (51200, 384, 300))


# f32 K1's kernel past E = 112 (gru_input_proj_xt in
# csrc/gru_input_proj.cu, E <= 352), each design choice changed at a time:
# "3xTF32": its products as 3xTF32 (x's chunk split into TF32 big and
# small B tiles, W's fragments into big and small in registers, three
# wgmma m64n128k8 a k8 step: the same tensor-core time as six bf16
# m64n128k16 a k16 step, x's parts 8 bytes an element against 6);
# "accumulators chained over the tile": no f32 sum a chunk, the tensor
# core accumulates over the whole depth; "64-column tiles": a block holds
# 64 columns of W (x read 6 times at 6H = 384, not 3), each warpgroup's
# wgmma m64n64k16 on its half of the x tile's rows (a third warpgroup,
# 192 columns, would not fit W's f32 slice at E = 300); "one B buffer":
# the next chunk's B tiles are
# stored once the products are done, not while they run; "next chunk's A
# split while the products run": W's fragments for chunk g + 1 split
# before chunk g's wait (24 registers more).  "timing only" steps leave a
# part of the work out.
K1X_A_TOP = """    uint32_t a1[2][4], a2[2][4], a3[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4* f = reinterpret_cast<const float4*>(
          wf + ((size_t)min(2 * c + j, KS - 1) * X_THREADS + tid) * 8);
      const float4 lo4 = f[0], hi4 = f[1];
      split3(lo4.x, lo4.y, a1[j][0], a2[j][0], a3[j][0]);
      split3(lo4.z, lo4.w, a1[j][1], a2[j][1], a3[j][1]);
      split3(hi4.x, hi4.y, a1[j][2], a2[j][2], a3[j][2]);
      split3(hi4.z, hi4.w, a1[j][3], a2[j][3], a3[j][3]);
    }
    wgmma_fence();
"""
K1X_A_DECL = """  float acc[X_BX / 2], sum[X_BX / 2];
  for (int g = 0; g < chunks; ++g) {
"""
K1X_A_AHEAD = """  float acc[X_BX / 2], sum[X_BX / 2];
  uint32_t a1[2][4], a2[2][4], a3[2][4], n1[2][4], n2[2][4], n3[2][4];
  auto split_w = [&](int c, uint32_t (&b1)[2][4], uint32_t (&b2)[2][4], uint32_t (&b3)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4* f = reinterpret_cast<const float4*>(
          wf + ((size_t)min(2 * c + j, KS - 1) * X_THREADS + tid) * 8);
      const float4 lo4 = f[0], hi4 = f[1];
      split3(lo4.x, lo4.y, b1[j][0], b2[j][0], b3[j][0]);
      split3(lo4.z, lo4.w, b1[j][1], b2[j][1], b3[j][1]);
      split3(hi4.x, hi4.y, b1[j][2], b2[j][2], b3[j][2]);
      split3(hi4.z, hi4.w, b1[j][3], b2[j][3], b3[j][3]);
    }
  };
  split_w(0, a1, a2, a3);
  for (int g = 0; g < chunks; ++g) {
"""
K1X_A_NEXT = """      load(g + 2);
    }
    split_w((g + 1) % NC, n1, n2, n3);
"""
K1X_A_COPY = """    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a1[j][i] = n1[j][i];
        a2[j][i] = n2[j][i];
        a3[j][i] = n3[j][i];
      }
    // the chunk's sum, added in f32"""
K1X_NO_LOADS = ("gru_input_proj.cu", "    const bool in = g < chunks && r < M;",
                "    const bool in = M < 0;")
K1X_NO_B = ("gru_input_proj.cu", "      store(g + 1);\n", "      if (M < 0) store(g + 1);\n")
K1X_NO_XG = ("gru_input_proj.cu", "    if (c == NC - 1) {", "    if (M < 0) {")
K1X_NO_W = ("gru_input_proj.cu", "  for (int i = tid; i < KS * 16 * X_BM; i += X_THREADS) {",
            "  for (int i = tid; i < KS * 16 * X_BM * (M < 0); i += X_THREADS) {")
K1X_PRODUCTS = """      WgmmaBf16<X_BX>::run(acc, a3[j], desc(q1), j > 0);
      WgmmaBf16<X_BX>::run(acc, a1[j], desc(q3), 1);
      WgmmaBf16<X_BX>::run(acc, a2[j], desc(q2), 1);
      WgmmaBf16<X_BX>::run(acc, a2[j], desc(q1), 1);
      WgmmaBf16<X_BX>::run(acc, a1[j], desc(q2), 1);
      WgmmaBf16<X_BX>::run(acc, a1[j], desc(q1), 1);"""
K1X_B_LOOP = """#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* q1 = bt + (g & 1) * X_BUF + j * 3 * X_BT;
      const bf16* q2 = q1 + X_BT;
      const bf16* q3 = q2 + X_BT;
""" + K1X_PRODUCTS + "\n    }\n"
K1X_TF32_PRODUCTS = """    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = reinterpret_cast<const float4*>(
          wf + ((size_t)min(2 * c + j / 2, KS - 1) * X_THREADS + tid) * 8)[j % 2];
      tf32x3::split(f.x, ah[j][0], al[j][0]);
      tf32x3::split(f.y, ah[j][1], al[j][1]);
      tf32x3::split(f.z, ah[j][2], al[j][2]);
      tf32x3::split(f.w, ah[j][3], al[j][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* qb = reinterpret_cast<const float*>(bt + (g & 1) * X_BUF) + j * X_BT;
      tf32x3::Wgmma<X_BX>::run(acc, al[j], tf32x3::b_desc(qb), j > 0);
      tf32x3::Wgmma<X_BX>::run(acc, ah[j], tf32x3::b_desc(qb + X_BT / 2), 1);
      tf32x3::Wgmma<X_BX>::run(acc, ah[j], tf32x3::b_desc(qb), 1);
    }
"""
K1X_STORE = """  auto store = [&](int g) {
    bf16* dst = bt + (g & 1) * X_BUF + xh * 3 * X_BT;
    uint32_t p1[8], p2[8], p3[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      split3(xv[q].x, xv[q].y, p1[2 * q], p2[2 * q], p3[2 * q]);
      split3(xv[q].z, xv[q].w, p1[2 * q + 1], p2[2 * q + 1], p3[2 * q + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = tile_offset(xr, 8 * h);
      *reinterpret_cast<uint4*>(dst + at) =
          make_uint4(p1[4 * h], p1[4 * h + 1], p1[4 * h + 2], p1[4 * h + 3]);
      *reinterpret_cast<uint4*>(dst + X_BT + at) =
          make_uint4(p2[4 * h], p2[4 * h + 1], p2[4 * h + 2], p2[4 * h + 3]);
      *reinterpret_cast<uint4*>(dst + 2 * X_BT + at) =
          make_uint4(p3[4 * h], p3[4 * h + 1], p3[4 * h + 2], p3[4 * h + 3]);
    }
  };
"""
# a k8 step's B tiles [big | small], TF32's K-major layout (tf32x3.cuh
# b_offset), four k8 steps a chunk
K1X_TF32_STORE = """  auto store = [&](int g) {
    float* dst = reinterpret_cast<float*>(bt + (g & 1) * X_BUF + xh * 4 * X_BT);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t big[4], small[4];
      tf32x3::split(xv[q].x, big[0], small[0]);
      tf32x3::split(xv[q].y, big[1], small[1]);
      tf32x3::split(xv[q].z, big[2], small[2]);
      tf32x3::split(xv[q].w, big[3], small[3]);
      float* tb = dst + (q >> 1) * X_BT + tf32x3::b_offset(xr, 4 * (q & 1));
      *reinterpret_cast<uint4*>(tb) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(tb + X_BT / 2) = make_uint4(small[0], small[1], small[2],
                                                            small[3]);
    }
  };
"""
# W's fragments in TF32's register order: float 4 h + r of k16 step s
# holds k8 step h's a[r], m = gid + 8 (r & 1), k = 16 s + 8 h + tig + 4 (r >> 1)
K1X_W_ORDER = """    const int owner = m / 64 * WG + mw / 16 * 32 + mw % 8 * 4 + kk % 8 / 2;
    const int q = mw % 16 / 8 + 2 * (kk / 8);
    wf[((size_t)(k / 16) * X_THREADS + owner) * 8 + 2 * q + kk % 2] ="""
K1X_TF32_W_ORDER = """    const int owner = m / 64 * WG + mw / 16 * 32 + mw % 8 * 4 + kk % 4;
    const int q = mw % 16 / 8 + 2 * (kk % 8 / 4);
    wf[((size_t)(k / 16) * X_THREADS + owner) * 8 + 4 * (kk / 8) + q] ="""
K1X_OVERLAP = """    if (g + 1 < chunks) {
      store(g + 1);
      load(g + 2);
    }
    wgmma_wait<0>();
"""
K1X_FOLD = "sum[i] = (c == 0 ? 0.f : sum[i]) + acc[i];"
K1_F32_STEPS = (
    ("final", []),
    ("3xTF32 (wgmma m64n128k8)", [
        ("gru_input_proj.cu", "constexpr int X_BUF = X_KC / 16 * 3 * X_BT;",
         "constexpr int X_BUF = X_KC / 16 * 4 * X_BT;"),
        ("gru_input_proj.cu", K1X_W_ORDER, K1X_TF32_W_ORDER),
        ("gru_input_proj.cu", K1X_STORE, K1X_TF32_STORE),
        ("gru_input_proj.cu", K1X_A_TOP + K1X_B_LOOP, K1X_TF32_PRODUCTS)]),
    ("accumulators chained over the tile", [
        ("gru_input_proj.cu", "WgmmaBf16<X_BX>::run(acc, a3[j], desc(q1), j > 0);",
         "WgmmaBf16<X_BX>::run(acc, a3[j], desc(q1), c > 0 || j > 0);"),
        ("gru_input_proj.cu", K1X_FOLD, "sum[i] = acc[i];")]),
    ("64-column tiles", [
        ("gru_input_proj.cu", "constexpr int X_BM = 128;", "constexpr int X_BM = 64;"),
        ("gru_input_proj.cu", "* X_THREADS + tid) * 8);", "* X_THREADS + t) * 8);"),
        ("gru_input_proj.cu", "const bf16* q1 = bt + (g & 1) * X_BUF + j * 3 * X_BT;",
         "const bf16* q1 = bt + (g & 1) * X_BUF + j * 3 * X_BT + wg * tile_offset(64, 0);"),
        ("gru_input_proj.cu", "WgmmaBf16<X_BX>::run(", "WgmmaBf16<X_BX / 2>::run("),
        ("gru_input_proj.cu", "float acc[X_BX / 2], sum[X_BX / 2];",
         "float acc[X_BX / 4], sum[X_BX / 4];"),
        ("gru_input_proj.cu", "for (int i = 0; i < X_BX / 2; ++i) sum[i] = (c == 0",
         "for (int i = 0; i < X_BX / 4; ++i) sum[i] = (c == 0"),
        ("gru_input_proj.cu", "for (int j = 0; j < X_BX / 8; ++j) {",
         "for (int j = 0; j < X_BX / 16; ++j) {"),
        ("gru_input_proj.cu", "const int r = tile * X_BX + 8 * j + 2 * tig + e;",
         "const int r = tile * X_BX + wg * 64 + 8 * j + 2 * tig + e;"),
        ("gru_input_proj.cu", "const int cA = wg * 64 + warp * 16 + gid;",
         "const int cA = warp * 16 + gid;")]),
    ("one B buffer", [
        ("gru_input_proj.cu", "bt + (g & 1) * X_BUF", "bt"),
        ("gru_input_proj.cu", K1X_OVERLAP,
         "    wgmma_wait<0>();\n    __syncthreads();  // every warpgroup is done with the buffer\n"
         "    if (g + 1 < chunks) {\n      store(g + 1);\n      load(g + 2);\n    }\n")]),
    ("next chunk's A split while the products run", [
        ("gru_input_proj.cu", K1X_A_TOP, "    wgmma_fence();\n"),
        ("gru_input_proj.cu", K1X_A_DECL, K1X_A_AHEAD),
        ("gru_input_proj.cu", "      load(g + 2);\n    }\n", K1X_A_NEXT),
        ("gru_input_proj.cu", "    fence_regs(acc);\n    // the chunk's sum, added in f32", K1X_A_COPY)]),
    ("no x loads (timing only)", [K1X_NO_LOADS]),
    ("no B tile stores (timing only)", [K1X_NO_B]),
    ("no products (timing only)", [("gru_input_proj.cu", K1X_PRODUCTS, "      ;")]),
    ("no xg stores (timing only)", [K1X_NO_XG]),
    ("no W load (timing only)", [K1X_NO_W]),
    ("products only (timing only)", [K1X_NO_LOADS, K1X_NO_B, K1X_NO_XG, K1X_NO_W]))
K1_F32_STEP_WIDTHS = (113, 300)  # E each f32 K1 step is timed at (M = 51,200)


def k1_f32_steps_phase(device, M=51200, G=384, widths=K1_F32_STEP_WIDTHS):
    """f32 K1 with one design choice of its transposed kernel changed at a
    time (K1_F32_STEPS), each built beside the final source, held against
    the plain version in f64 (max abs error; "past_1e-5": the values
    outside rtol = atol = 1e-5, the card tests' tolerance; the final source
    must keep K1_TOL of the largest |xg|) and timed (device ms under
    torch.profiler) at (M, E, G) for each E of `widths`.  Returns {label:
    {E: {"device_ms", "max_abs_err", "past_1e-5"}}}."""
    fns = build_steps("gru_input_proj", K1_F32_STEPS,
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = {label: {} for label in fns}
    for e in widths:
        g = torch.Generator(device=device).manual_seed(e)
        x = torch.randn(M, e, generator=g, device=device)
        w = torch.randn(e, G, generator=g, device=device) * (50 / e) ** 0.5
        b = torch.randn(G, generator=g, device=device)
        want = gru_cuda.gru_input_proj_ref(x.double(), w.double(), b.double())
        xg = torch.empty(M, G, device=device)
        for label, fn in fns.items():
            def call(fn=fn, label=label):
                if fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), xg.data_ptr(), M, e, G,
                      torch.cuda.current_stream().cuda_stream):
                    raise AssertionError(f"K1 f32 step {label!r} failed to launch")

            call()
            torch.cuda.synchronize()
            diff = (xg.double() - want).abs()
            err = diff.max().item()
            if label == "final" and not err <= K1_TOL * want.abs().max().item():
                raise AssertionError("K1's final f32 source disagrees with its plain version")
            r = out[label][e] = {"device_ms": device_ms(call), "max_abs_err": err,
                                 "past_1e-5": int((diff > 1e-5 + 1e-5 * want.abs()).sum())}
            print(f"K1 f32 step {label!r} at E = {e}: device ms {_ms(r['device_ms'])}, "
                  f"max abs err {err:.3e}, past 1e-5 {r['past_1e-5']}")
        del x, want, xg
        torch.cuda.empty_cache()
    return out


def k1_bf16_steps_phase(device, M=51200, G=384, widths=K1_BF16_STEP_WIDTHS):
    """bf16 K1 with one design choice of its streaming kernel taken back at
    a time (K1_BF16_STEPS), each built beside the final source, held
    against the plain version (_bf16_agreement; the final source raises)
    and timed (device ms under torch.profiler) at (M, E, G) for each E of
    `widths`.  A step whose shared memory no longer fits a width runs the
    kernel the final source routes past it.  Returns {label: {E: ms}}."""
    fns = build_steps("gru_input_proj", K1_BF16_STEPS,
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                      "gru_input_proj_bf16")
    times = {label: {} for label in fns}
    for e in widths:
        g = torch.Generator(device=device).manual_seed(e)
        x = torch.randn(M, e, generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn(e, G, generator=g, device=device) * (50 / e) ** 0.5).to(torch.bfloat16)
        b = torch.randn(G, generator=g, device=device).to(torch.bfloat16)
        want = gru_cuda.gru_input_proj_ref(x, w, b)
        out = torch.empty(M, G, device=device, dtype=torch.bfloat16)
        for label, fn in fns.items():
            def call(fn=fn, label=label):
                if fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, e, G,
                      torch.cuda.current_stream().cuda_stream):
                    raise AssertionError(f"K1 bf16 step {label!r} failed to launch")

            call()
            torch.cuda.synchronize()
            where = f"K1 bf16 step {label!r} at E = {e}"
            _, within = _bf16_agreement(out, want, where)
            if label == "final" and not within:
                raise AssertionError("K1's final bf16 source disagrees with its plain version")
            times[label][e] = device_ms(call)
            print(f"{where}: device ms {_ms(times[label][e])}")
        del x, want, out
        torch.cuda.empty_cache()
    return times


def k9_bf16_steps_phase(device, shapes=K9_BF16_STEP_SHAPES):
    """bf16 K9 with one design choice of its wgmma kernel taken back at a
    time (K9_BF16_STEPS), each built beside the final source, held against
    the plain version (the final source raises) and timed (device ms
    under torch.profiler) at each (M, 6H, E) of `shapes`.  Returns
    {label: {"MxGxE": ms}}."""
    fns = build_steps("gru_input_proj_dx", K9_BF16_STEPS,
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                      "gru_input_proj_dx_bf16")
    times = {label: {} for label in fns}
    for M, G, E in shapes:
        g = torch.Generator(device=device).manual_seed(M + G + E)
        dxg = torch.randn(M, G, generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn(E, G, generator=g, device=device) / G ** 0.5).to(torch.bfloat16)
        want = gru_cuda.gru_input_proj_dx_ref(dxg, w)
        dx = torch.empty(M, E, device=device, dtype=torch.bfloat16)
        for label, fn in fns.items():
            def call(fn=fn, label=label):
                if fn(dxg.data_ptr(), w.data_ptr(), dx.data_ptr(), M, G, E,
                      torch.cuda.current_stream().cuda_stream):
                    raise AssertionError(f"K9 bf16 step {label!r} failed to launch")

            call()
            torch.cuda.synchronize()
            where = f"K9 bf16 step {label!r} at (M, 6H, E) = {(M, G, E)}"
            _, within = _bf16_agreement(dx, want, where)
            if label == "final" and not within:
                raise AssertionError("K9's final bf16 source disagrees with its plain version")
            times[label][f"{M}x{G}x{E}"] = device_ms(call)
            print(f"{where}: device ms {_ms(times[label][f'{M}x{G}x{E}'])}")
        del dxg, want, dx
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
        fwd_ms = time_cuda(lambda: predictor.model(batch), iters=10)
    print(f"serving on {device_name}: predict_dataset {wall / n_b * 1e3:.3f} ms "
          f"per B={cfg.batch_size} batch ({len(full_ds) / wall:.1f} samples/s, host "
          f"clock, {len(full_ds)} samples); device forward {fwd_ms:.3f} ms per batch "
          f"({cfg.batch_size / fwd_ms * 1e3:.1f} samples/s, CUDA events)")
    with torch.inference_mode():
        device_breakdown(lambda: predictor.model(batch), "forward", steps=5)
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
            "--metrics_jsonl", str(root / "metrics.jsonl"), *STREAMING, *flags]
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
                        iters=5 if long_history else 10)
    print(f"training on {device_name}: {step_ms:.3f} ms per B={B} train step "
          f"({B / step_ms * 1e3:.1f} samples/s, CUDA events, back to back); "
          f"fit + test {main_s / steps * 1e3:.1f} ms per train step, "
          f"evaluations and dataset builds included (host clock); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_breakdown(lambda: train_step(model, opt, dev_batch, 1e-3), "train step",
                     steps=5)
    if not long_history:
        ms, busy, wall = graph_step_ms(trainer, ds["train"])
        print(f"training on {device_name} at --steps_per_dispatch {DISPATCH_K}: {ms:.3f} ms "
              f"per train step (one CUDA graph replay of {DISPATCH_K} steps, CUDA events); "
              f"idle {_idle(busy, wall)} (torch.profiler)")
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
            "--metrics_jsonl", str(root / "metrics.jsonl"), *STREAMING]
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
    step_ms = time_cuda(step, iters=5)
    torch.backends.cudnn.deterministic = False
    free_ms = time_cuda(step, iters=5)
    torch.backends.cudnn.deterministic = True
    again_ms = time_cuda(step, iters=5)
    print(f"full UMPR training on {device_name}: {step_ms:.3f} ms per B={B} train step "
          f"({B / step_ms * 1e3:.1f} samples/s, CUDA events, back to back) with "
          f"cudnn.deterministic True, as the Trainer sets it (again after: "
          f"{again_ms:.3f} ms); {free_ms:.3f} ms with it False; fit + "
          f"test {main_s / steps * 1e3:.1f} ms per train step, evaluations, "
          f"checkpoints and dataset builds included (host clock); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_breakdown(step, "full UMPR train step", steps=3, top=14)
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
        fwd_ms = time_cuda(forward, iters=5)
        torch.backends.cudnn.deterministic = True
        pinned_ms = time_cuda(forward, iters=5)
        torch.backends.cudnn.deterministic = False
        again_ms = time_cuda(forward, iters=5)
    print(f"full UMPR serving on {device_name}: predict_dataset {walls['bank']:.3f} ms "
          f"per B={B} batch with the bank, {walls['streaming']:.3f} ms streaming photos "
          f"(host clock, {len(full_ds)} samples, photos decoded and cached); device "
          f"forward {fwd_ms:.3f} ms per batch ({B / fwd_ms * 1e3:.1f} samples/s, CUDA "
          f"events; again after: {again_ms:.3f}), {pinned_ms:.3f} ms with "
          f"cudnn.deterministic True")
    with torch.inference_mode():
        device_breakdown(forward, "full UMPR forward", steps=3, top=12)
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
            "--learning_rate", "1e-3", "--eval_every", "4", *STREAMING, *flags]
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


DISPATCH_K = 4
# 3 train shards of 424 rows: 20 B=64 batches, 5 chunks of 4; valid and
# test 7 batches each, a chunk of 4 and 3 singles
DISPATCH_CORPUS = dict(users=53)
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6  # tests/test_e2e_train.py's k = 4 vs k = 1


def run_graphs(trainer):
    """The DispatchGraphs of a Trainer's --steps_per_dispatch run."""
    if trainer.k_dispatch == 1:
        return []
    graphs = trainer.multi_eval_step.dispatch_graphs()
    if trainer.multi_train_step.graph is not None:
        graphs.append(trainer.multi_train_step.graph)
    return graphs


def device_launches(counts, graphs):
    """(launches on the card, the graphs' warm-up launches) of a run whose
    wrapper counts are `counts`: a wrapper counts its kernel where it is
    called, so at a graph's capture once and at its replays never; on the
    card the captured launches ran once per replay."""
    out, warm = dict(counts), dict.fromkeys(counts, 0)
    for g in graphs:
        for k in out:
            out[k] += (g.replays - 1) * g.captured[k]
            warm[k] += g.warmup_launches[k]
    return out, warm


def idle_share(fn, steps=5):
    """(device busy ms, host wall ms) per call of fn under torch.profiler;
    busy None where it recorded no device time."""
    kernels, wall_ms, _ = profile_device(fn, steps)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    return (busy if kernels else None), wall_ms


def _idle(busy, wall):
    return "not measured" if busy is None else f"{1 - busy / wall:.1%}"


def _state_bits_equal(a, b):
    """Two models' state dicts, bit for bit."""
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _params_close(a, b):
    """(bits equal?, max abs diff, all within PARAM_RTOL/ATOL?) over two
    state dicts."""
    equal = _state_bits_equal(a, b)
    diff = max((a[k].float() - b[k].float()).abs().max().item() for k in a)
    close = all(torch.allclose(a[k].float(), b[k].float(), rtol=PARAM_RTOL, atol=PARAM_ATOL)
                for k in a)
    return equal, diff, close


def _stack(batches, device):
    return to_device({key: np.stack([b[key] for b in batches]) for key in batches[0]},
                     device)


def dispatch_phase(device_name):
    """--steps_per_dispatch on UMPR-R at P = 400, B = 64 through
    ``umpr_tpu_torch.main.main``: one epoch of 20 steps at k = 1 and at
    k = DISPATCH_K (CUDA graphs of k train steps and of k eval steps),
    eval_every 20, each with --profile_dir.  The parameters and logged
    values agree, the launches on the card (replays x the launches
    captured, plus the remainders' and the warm-ups') equal the k = 1
    run's, the k = 1 trace names K1's and K2's kernels; then ms per train
    step and the idle share at both k.  Returns a summary."""
    root = WORK / "dispatch"
    if root.exists():
        shutil.rmtree(root)
    glove = write_splits(root, seed=1, shards=5, **DISPATCH_CORPUS)
    base = ["--review_net_only", "True", "--data_dir", str(root), "--word2vec_file",
            str(glove), "--train_epochs", "1", "--learning_rate", "1e-3", "--eval_every", "20",
            *STREAMING]
    runs = {}
    for k in (1, DISPATCH_K):
        argv = base + ["--steps_per_dispatch", str(k), "--model_path", str(root / f"k{k}"),
                       "--log_path", str(root / f"k{k}.log"),
                       "--metrics_jsonl", str(root / f"k{k}.jsonl"),
                       "--profile_dir", str(root / f"trace_k{k}")]
        with main_path_counts() as (launches, plain_calls):
            t0 = time.perf_counter()
            trainer = train_main.main(argv)
            wall = time.perf_counter() - t0
        graphs = run_graphs(trainer)
        on_card, warm = device_launches(launches, graphs)
        events = [{k2: v for k2, v in json.loads(line).items() if k2 not in ("ts", "elapsed_s")}
                  for line in open(root / f"k{k}.jsonl")]
        runs[k] = dict(trainer=trainer, launches=launches, on_card=on_card, warm=warm,
                       plain=plain_calls[0], graphs=graphs, wall=wall, events=events)
    one, many = runs[1], runs[DISPATCH_K]
    t1, tk = one["trainer"], many["trainer"]
    steps = t1.batch_counter
    equal, diff, close = _params_close(t1.model.state_dict(), tk.model.state_dict())
    values = lambda ev: [e.get(key) for e in ev for key in ("train_loss", "valid_mse", "test_mse")
                         if key in e]
    v1, vk = values(one["events"]), values(many["events"])
    train_graph = tk.multi_train_step.graph
    print(f"steps per dispatch on {device_name}: {steps} UMPR-R steps at k = 1 and "
          f"{tk.batch_counter} at k = {DISPATCH_K} (B=64, P=400, one epoch, eval_every 20); "
          f"fit + test {one['wall']:.1f} s and {many['wall']:.1f} s (host clock, datasets "
          f"built inside); parameters bit-equal {equal}, max abs diff {diff:.3e} (rtol "
          f"{PARAM_RTOL:.0e}, atol {PARAM_ATOL:.0e}: {close}); logged values {v1} and {vk}")
    print(f"  k = {DISPATCH_K}: {len(many['graphs'])} graphs (train: {train_graph.replays} "
          f"replays of {train_graph.captured}; eval: "
          f"{[(g.replays, g.captured['gru_input_proj']) for g in many['graphs'][:-1]]} "
          f"replays and K1 launches captured); wrapper counts {many['launches']}; on the card "
          f"{many['on_card']}, of them warm-ups {many['warm']}; k = 1: {one['launches']}; "
          f"plain versions on the card {one['plain']} and {many['plain']}")
    if steps < 16 or tk.batch_counter != steps or not close:
        raise AssertionError("k = 4 and k = 1 training disagree")
    if len(v1) != len(vk) or not np.allclose(vk, v1, rtol=PARAM_RTOL, atol=PARAM_ATOL):
        raise AssertionError("k = 4 and k = 1 logged different losses or MSEs")
    replayed = {key: many["on_card"][key] - many["warm"][key] for key in many["on_card"]}
    if (one["plain"] or many["plain"] or train_graph.replays < 4
            or any(train_graph.captured[key] != DISPATCH_K for key in FORWARD + GRU_BACKWARD)
            or len(many["graphs"]) < 2 or replayed != one["launches"]
            or not all(one["launches"][key] for key in FORWARD + GRU_BACKWARD)):
        raise AssertionError("the k = 4 run's launches are not the k = 1 run's")

    traces = {k: sorted((root / f"trace_k{k}").glob("*.pt.trace.json")) for k in runs}
    text = {k: "".join(p.read_text() for p in v) for k, v in traces.items()}
    names = {src: port_kernel_names(src) for src in ("gru_input_proj.cu", "bigru_recurrence.cu")}
    seen = {k: {src: sorted(n for n in ns if n in text[k]) for src, ns in names.items()}
            for k in runs}
    print(f"--profile_dir: traces {[p.name for v in traces.values() for p in v]}; K1's and "
          f"K2's kernels named at k = 1: {seen[1]}; at k = {DISPATCH_K} (graph replays): "
          f"{seen[DISPATCH_K]}")
    if not traces[1] or not all(seen[1].values()):
        raise AssertionError("the k = 1 profile trace does not name K1's and K2's kernels")

    # ms per train step, back to back on the trained models
    train = build_dataset(str(root / "train.csv"), str(root / "photos.json"),
                          str(root / "photos"), Word2vec(str(glove)), tk.config)
    loader = iter(BatchLoader(train, tk.config.batch_size))
    host = [next(loader) for _ in range(DISPATCH_K)]
    batch, chunk = to_device(host[0], tk.device), _stack(host, tk.device)
    step1 = lambda: train_step(t1.model, t1.opt, batch)
    stepk = lambda: tk.multi_train_step(chunk, [None] * DISPATCH_K)
    ms1, msk = time_cuda(step1), time_cuda(stepk) / DISPATCH_K
    (b1, w1), (bk, wk) = idle_share(step1), idle_share(stepk)
    bk, wk = (None if bk is None else bk / DISPATCH_K), wk / DISPATCH_K
    print(f"UMPR-R train step on {device_name}: k = 1 {ms1:.3f} ms, k = {DISPATCH_K} "
          f"{msk:.3f} ms per step (CUDA events, back to back); under torch.profiler busy "
          f"{b1 if b1 is None else round(b1, 3)} of {w1:.3f} ms (idle {_idle(b1, w1)}) and "
          f"{bk if bk is None else round(bk, 3)} of {wk:.3f} ms (idle {_idle(bk, wk)})")
    return {"steps": steps, "bit_equal": equal, "max_abs_diff": diff,
            "ms_per_step": {"1": ms1, str(DISPATCH_K): msk},
            "idle_share": {"1": _idle(b1, w1), str(DISPATCH_K): _idle(bk, wk)},
            "launches_on_card": many["on_card"], "warmup_launches": many["warm"]}


def optimizer_phase(device_name):
    """The port's Adam step alone (train/optim.py, every train step's
    optimizer) on UMPR-R's parameters at the reference widths, beside
    torch.optim.Adam's foreach step on the same gradients (a yardstick:
    the port never calls it): device ms (torch.profiler), ms per step
    (CUDA events, back to back) and the port's kernels by name."""
    from umpr_tpu_torch.train.optim import make_optimizer, param_groups
    cfg = Config(["--review_net_only", "True"])
    model = UMPR(ModelDims.from_config(cfg), np.zeros((2000, 50), np.float32),
                 torch.Generator().manual_seed(0)).to("cuda")
    g = torch.Generator().manual_seed(1)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.randn(p.shape, generator=g).to("cuda")
    ours = make_optimizer(model, 1e-3, 1e-3)
    theirs = torch.optim.Adam(param_groups(model, 1e-3), lr=1e-3, foreach=True)
    n = sum(p.numel() for p in ours.params)
    out = {}
    for name, opt in (("port", ours), ("torch_foreach", theirs)):
        out[name] = (time_cuda(opt.step), device_ms(opt.step))
    split = sorted(device_split(ours.step).items(), key=lambda kv: -kv[1])
    print(f"Adam step on {device_name} over UMPR-R's {len(ours.params)} trainable tensors "
          f"({n} values): the port's {out['port'][0]:.4f} ms (CUDA events, back to back), "
          f"device {out['port'][1]:.4f} ms; torch.optim.Adam(foreach=True) "
          f"{out['torch_foreach'][0]:.4f} ms, device {out['torch_foreach'][1]:.4f} ms; the "
          f"port's {len(split)} kernels by device ms per step:")
    for name, ms in split[:12]:
        print(f"  {ms:8.4f} ms  {name[:100]}")
    return {k: {"ms": v[0], "device_ms": v[1]} for k, v in out.items()}


def graph_step_ms(trainer, ds, k=DISPATCH_K):
    """ms per step of k train steps as one graph replay, and the idle
    share, on a trainer's model (a chunk of its first k batches)."""
    from umpr_tpu_torch.train.step import MultiTrainStep
    loader = iter(BatchLoader(ds, trainer.config.batch_size))
    chunk = _stack([next(loader) for _ in range(k)], trainer.device)
    multi = MultiTrainStep(trainer.model, trainer.opt)
    fn = lambda: multi(chunk, [None] * k)
    ms = time_cuda(fn, iters=5) / k
    busy, wall = idle_share(fn)
    return ms, (None if busy is None else busy / k), wall / k


def full_dispatch_phase(device_name):
    """Full UMPR at 224 px, 4 train steps at k = 1 and at k = 2 (the
    initial validation's 2 batches one chunk): the dropout masks drawn for
    each step, the parameters and the launches on the card agree."""
    from umpr_tpu_torch.models import visual_net
    from umpr_tpu_torch.train.trainer import Trainer
    from umpr_tpu_torch.utils.logging import get_logger
    root = WORK / "dispatch_full"
    if root.exists():
        shutil.rmtree(root)
    glove = write_splits(root, seed=1, shards=5)
    use_seeded_photos()
    argv = ["--review_net_only", "False", "--vgg_fused_pool", "True", "--seed", "2",
            "--data_dir", str(root), "--word2vec_file", str(glove), "--learning_rate", "1e-3",
            "--eval_every", "4", "--data_workers", "4", "--device_dataset", "off"]
    w2v = Word2vec(str(glove))
    real = visual_net.keep_mask
    runs = {}
    try:
        for k in (1, 2):
            masks = []
            visual_net.keep_mask = lambda *a, m=masks: m.append(real(*a)) or m[-1]
            cfg = Config(argv + ["--steps_per_dispatch", str(k)])
            train, valid = (build_dataset(str(root / f"{s}.csv"), str(root / "photos.json"),
                                          str(root / "photos"), w2v, cfg)
                            for s in ("train", "valid"))
            trainer = Trainer(cfg, get_logger(logger_name=f"dispatch-full-{k}"), w2v)
            with main_path_counts() as (launches, plain_calls):
                trainer.fit(train, valid, str(root / f"k{k}"), _stop_after_batches=4)
            on_card, warm = device_launches(launches, run_graphs(trainer))
            runs[k] = (trainer, masks, launches, on_card, warm, plain_calls[0])
    finally:
        visual_net.keep_mask = real
    (t1, m1, l1, _, _, p1), (t2, m2, l2, c2, w2, p2) = runs[1], runs[2]
    masks_equal = len(m1) == len(m2) == 8 and all(torch.equal(a, b) for a, b in zip(m1, m2))
    equal, diff, close = _params_close(t1.model.state_dict(), t2.model.state_dict())
    replayed = {key: c2[key] - w2[key] for key in c2}
    print(f"full UMPR, 4 steps at 224 px on {device_name}, k = 1 and k = 2: dropout masks "
          f"{len(m1)} and {len(m2)}, equal {masks_equal}; parameters bit-equal {equal}, max "
          f"abs diff {diff:.3e} (within rtol {PARAM_RTOL:.0e}, atol {PARAM_ATOL:.0e}: {close}); "
          f"launches k = 1 {l1}, k = 2 on the card {c2} (warm-ups {w2}); plain versions on "
          f"the card {p1} and {p2}")
    if not (masks_equal and close and t2.batch_counter == 4 and not p1 and not p2
            and replayed == l1 and t2.multi_train_step.graph.replays == 2):
        raise AssertionError("full UMPR at k = 2 disagrees with k = 1")
    return {"bit_equal": equal, "max_abs_diff": diff, "launches_on_card": c2}


def serve_dispatch_phase(device_name):
    """UMPR-R serving at k = DISPATCH_K against k = 1 (B = 64, P = 400): the
    same bits over the corpus (a chunk and a remainder) and over one HTTP
    request of all of it, the launches on the card, and the device ms per
    batch with the idle share."""
    work = WORK / "dispatch_serve"
    if work.exists():
        shutil.rmtree(work)
    glove, csv, _ = write_corpus(work, seed=0)
    model_dir = work / "model"
    argv = ["--review_net_only", "True", "--data_dir", str(work), "--word2vec_file", str(glove),
            "--model_path", str(model_dir)]
    cfg = Config(argv)
    w2v = Word2vec(str(glove))
    ckpt.save_best(str(model_dir), UMPR(ModelDims.from_config(cfg), w2v.embedding,
                                       torch.Generator().manual_seed(CKPT_SEED)))
    one = serve.Predictor(cfg, w2v, str(model_dir))
    many = serve.Predictor(Config(argv + ["--steps_per_dispatch", str(DISPATCH_K)]), w2v,
                           str(model_dir))
    ds = build_dataset(str(csv), str(work / "photos.json"), str(work / "photos"), w2v, cfg)
    n_batches = -(-len(ds) // cfg.batch_size)
    with main_path_counts() as (launches, plain_calls):
        pk, rows = many.predict_dataset(ds)
    p1, rows1 = one.predict_dataset(ds)
    on_card, warm = device_launches(launches, [many._graph])
    replayed = {key: on_card[key] - warm[key] for key in on_card}
    rows_all = pd.read_csv(csv).to_dict("records")
    answers = []
    for predictor in (one, many):
        server = serve.make_http_server(predictor, cfg, w2v, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            answers.append(_post(f"http://127.0.0.1:{server.server_address[1]}", rows_all))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    print(f"serving at k = {DISPATCH_K} on {device_name}: {len(ds)} samples, {n_batches} "
          f"batches ({many._graph.replays} graph replays); predictions bit-equal to k = 1 "
          f"{np.array_equal(pk, p1)}; one HTTP request of {len(rows_all)} rows bit-equal "
          f"{answers[0] == answers[1]}; launches on the card {on_card} (warm-ups {warm}); "
          f"plain versions on the card {plain_calls[0]}")
    want = dict.fromkeys(launches, 0) | dict.fromkeys(FORWARD, n_batches)
    if not (np.array_equal(pk, p1) and np.array_equal(rows, rows1) and answers[0] == answers[1]
            and replayed == want and not plain_calls[0] and many._graph.replays >= 2):
        raise AssertionError("serving at k = 4 disagrees with k = 1")

    loader = iter(BatchLoader(ds, cfg.batch_size))
    host = [next(loader) for _ in range(DISPATCH_K)]
    batch, chunk = to_device(host[0], one.device), _stack(host, many.device)
    with torch.inference_mode():
        fwd1 = lambda: one._forward(batch)
        fwdk = lambda: many._forward_chunk(chunk)
        ms1, msk = time_cuda(fwd1), time_cuda(fwdk) / DISPATCH_K
        (b1, w1), (bk, wk) = idle_share(fwd1), idle_share(fwdk)
    bk, wk = (None if bk is None else bk / DISPATCH_K), wk / DISPATCH_K
    print(f"serving forward on {device_name}: k = 1 {ms1:.3f} ms, k = {DISPATCH_K} {msk:.3f} ms "
          f"per B=64 batch (CUDA events, back to back); idle {_idle(b1, w1)} and "
          f"{_idle(bk, wk)} (torch.profiler)")
    return {"bit_equal": True, "ms_per_batch": {"1": ms1, str(DISPATCH_K): msk},
            "idle_share": {"1": _idle(b1, w1), str(DISPATCH_K): _idle(bk, wk)},
            "launches_on_card": on_card}


ADAM_MODE_FLAGS = ("--adam_moment_dtype", "bfloat16", "--adam_factored_nu", "True")


def adam_modes_phase(device_name):
    """bf16 mu with factored nu on UMPR-R (B = 64, P = 400): 6 steps on the
    card against 6 on the CPU (plain versions) within 1e-5, at lr 1e-4
    (Adam turns a gradient's rounding into an update difference of up to
    lr where the gradient is near 0); then a run saved at step 3, stopped,
    and resumed from last/ to step 6 ends with the card run's bits."""
    from umpr_tpu_torch.train.trainer import Trainer
    from umpr_tpu_torch.utils.logging import get_logger
    root = WORK / "adam_modes"
    if root.exists():
        shutil.rmtree(root)
    glove = write_splits(root, seed=1, shards=5)
    base = ["--review_net_only", "True", "--data_dir", str(root), "--word2vec_file", str(glove),
            "--train_epochs", "2", "--learning_rate", "1e-4", "--eval_every", "100",
            "--save_every_batches", "3", "--device_dataset", "off", *ADAM_MODE_FLAGS]
    w2v = Word2vec(str(glove))
    cfg = Config(base)
    train, valid = (build_dataset(str(root / f"{s}.csv"), str(root / "photos.json"),
                                  str(root / "photos"), w2v, cfg) for s in ("train", "valid"))

    def fit(name, *flags, stop=6):
        t = Trainer(Config(base + list(flags)), get_logger(logger_name=f"adam-{name}"), w2v)
        t.fit(train, valid, str(root / name), _stop_after_batches=stop)
        return t

    t0 = time.perf_counter()
    card = fit("card")
    cpu = fit("cpu", "--device", "cpu")
    fit("cut", stop=3)
    resumed = fit("cut", "--resume_path", str(root / "cut"), stop=3)
    seconds = time.perf_counter() - t0
    a = {k: v.cpu() for k, v in card.model.state_dict().items()}
    b = {k: v.cpu() for k, v in cpu.model.state_dict().items()}
    init = UMPR(ModelDims.from_config(cfg), w2v.embedding,
                torch.Generator().manual_seed(cfg.seed)).state_dict()
    moved = max((a[k] - init[k]).abs().max().item() for k in a)
    diff = max((a[k] - b[k]).abs().max().item() for k in a)
    close = all(torch.allclose(a[k], b[k], rtol=1e-5, atol=1e-5) for k in a)
    same = _params_close(a, {k: v.cpu() for k, v in resumed.model.state_dict().items()})[0]
    adam = [adam_to_jax(t.model, t.opt) for t in (card, resumed)]
    (ca, mua, nua), (cb, mub, nub) = adam
    leaves = lambda tree: [x for _, x in ckpt.leaves_with_path(tree)]
    adam_same = ca == cb == 6 and all(np.array_equal(x, y) for x, y in zip(
        leaves(mua) + leaves(nua), leaves(mub) + leaves(nub)))
    dtypes = json.load(open(root / "cut" / "last" / "structure.json"))["dtypes"]
    print(f"Adam with {' '.join(ADAM_MODE_FLAGS)} on {device_name}: 6 UMPR-R steps, card vs CPU "
          f"max abs diff {diff:.3e} (rtol and atol 1e-5: {close}; parameters moved up to "
          f"{moved:.3e}); resumed at step 3 from last/ ({dtypes.count('bfloat16')} bfloat16 mu "
          f"leaves, {len(nua)} nu leaves): parameters bit-equal {same}, Adam state bit-equal "
          f"{adam_same} (count {ca}, {cb}); {seconds:.1f} s (host clock, 4 runs)")
    if not (close and same and adam_same and moved > 1e-4 and resumed.batch_counter == 6):
        raise AssertionError("bf16 + factored Adam: card and CPU or the resume disagree")
    return {"max_abs_diff_vs_cpu": diff, "resume_bit_equal": same and adam_same}


def rnet_pretrained_phase(device_name):
    """--rnet_pretrained on the card and on the CPU: both R-Nets hold the
    checkpoint's bits, and the card's predictions of one batch agree with
    the CPU's within E2E_TOL."""
    from umpr_tpu_torch.convert import params_to_jax
    from umpr_tpu_torch.train.trainer import Trainer
    root = WORK / "rnet"
    if root.exists():
        shutil.rmtree(root)
    glove = write_splits(root, seed=1, shards=5)
    base = ["--review_net_only", "True", "--data_dir", str(root), "--word2vec_file", str(glove),
            "--rnet_pretrained", str(root / "rnet")]
    w2v = Word2vec(str(glove))
    cfg = Config(base)
    donor = UMPR(ModelDims.from_config(cfg), w2v.embedding,
                 torch.Generator().manual_seed(11)).review_net.rnet
    ckpt.save_pytree(str(root / "rnet"), params_to_jax(donor.state_dict()))
    valid = build_dataset(str(root / "valid.csv"), str(root / "photos.json"),
                          str(root / "photos"), w2v, cfg)
    batch = next(iter(BatchLoader(valid, cfg.batch_size)))
    preds, held = {}, {}
    with log_lines("rnet-pretrained") as (lines, logger):
        for run, dev in (("cpu", "cpu"), ("card", Config.device)):
            t = Trainer(Config(base + ["--device", dev]), logger, w2v)
            rnet = t.model.review_net.rnet.state_dict()
            held[run] = all(torch.equal(rnet[k].cpu(), v) for k, v in donor.state_dict().items())
            with torch.no_grad():
                preds[run] = t.model(to_device(batch, t.device))[0].cpu()
    err = (preds["card"] - preds["cpu"]).abs().max().item()
    loaded = sum("Loaded R-Net pre-trained weights from" in line for line in lines)
    print(f"--rnet_pretrained on {device_name}: loaded {loaded} times (CPU and card), the "
          f"checkpoint's bits held {held}; one batch's predictions card vs CPU max abs diff "
          f"{err:.3e} (tolerance {E2E_TOL:.0e}), range [{preds['cpu'].min():.4f}, "
          f"{preds['cpu'].max():.4f}]")
    if not (loaded == 2 and all(held.values()) and err <= E2E_TOL):
        raise AssertionError("--rnet_pretrained: card and CPU disagree")
    return {"max_abs_diff": err}



PRETRAIN_SENTENCES = 3200  # >= 3,000: mine_pairs gives 6 batches of 1,024 pairs an epoch
PRETRAIN_BATCH = 1024  # the R-Net CLI's default batch of pairs (2,048 GRU rows)
PRETRAIN_RTOL = 1e-4  # card against CPU: each step's loss, each R-Net leaf in l2


def write_pretrain_corpus(root, n=PRETRAIN_SENTENCES, seed=0):
    """A seeded corpus for the pretrainers: n sentences of 6-14 words, each
    from one of 8 topics of 40 words (320 words, each about 100 times, all
    above min_count 10): ``train.txt`` (a sentence a line, the ABAE CLI's
    input) and ``train.csv`` (reviews of 4 sentences joined by '. ', the
    input of the R-Net CLI and of train_embeddings)."""
    rng = np.random.default_rng(seed)
    topics = [[f"t{t}w{i}" for i in range(40)] for t in range(8)]
    sents = [" ".join(rng.choice(topics[rng.integers(8)], size=rng.integers(6, 15)))
             for _ in range(n)]
    counts = pd.Series(" ".join(sents).split()).value_counts()
    if len(counts) != 320 or counts.min() < 10:
        raise AssertionError(f"pretraining corpus: {len(counts)} words, the rarest "
                             f"{counts.min()} times")
    root.mkdir(parents=True, exist_ok=True)
    (root / "train.txt").write_text("\n".join(sents) + "\n")
    pd.DataFrame([{"userID": f"U{i % 50}", "itemID": f"I{i % 40}",
                   "review": ". ".join(sents[i:i + 4]), "rating": float(i % 5 + 1)}
                  for i in range(0, n, 4)]).to_csv(root / "train.csv", index=False)


@contextlib.contextmanager
def log_lines(name="chip-smoke"):
    """(lines, logger): the messages logged while the block runs, caught
    by a handler on the root logger, which every logger propagates to (the
    port's CLIs' among them), and the logger `name` at INFO, for a caller
    that asks for a logger (a Trainer)."""
    import logging
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logging.getLogger().addHandler(handler)
    try:
        yield lines, logger
    finally:
        logging.getLogger().removeHandler(handler)


def pretraining_phase(device_name, device="cuda"):
    """ROADMAP A8 on the card: the JAX-shaped pipeline at its default widths
    (skip-gram E = 50, 14 aspects, H = 64, L = 20, 1,024 pairs a batch),
    with 2 epochs: ``python -m umpr_tpu_torch.train_embeddings``, ``-m
    umpr_tpu_torch.pretrain.abae`` (E = 200, train.txt) and ``-m
    umpr_tpu_torch.pretrain.rnet`` (train.csv; its own skip-gram and its
    own 15-epoch ABAE at E = 50, as the CLI hard-codes), through their
    mains.  Launches of the R-Net CLI: K1-K4 once a step, no plain version,
    no K9 (the table is frozen), no other kernel.  One epoch of the R-Net
    pretrainer on the card against the same epoch on the CPU, from the
    same weights and pairs (each step's loss, each R-Net leaf within
    PRETRAIN_RTOL); the saved R-Net through ``--rnet_pretrained`` of a
    UMPR-R Trainer on the card (the "Loaded" line, the bits).  Then the ms
    of one step of each pretrainer (CUDA events over back-to-back steps,
    the host included, and device ms under torch.profiler) and each CLI's
    wall seconds.  `device` other than cuda rehearses the phase elsewhere.
    """
    from umpr_tpu_torch import train_embeddings
    from umpr_tpu_torch.convert import params_from_jax, params_to_jax
    from umpr_tpu_torch.pretrain import abae, rnet, train_sentences, word2vec_train
    from umpr_tpu_torch.train.optim import Adam
    from umpr_tpu_torch.train.trainer import Trainer
    work = WORK / "pretrain"
    if work.exists():
        shutil.rmtree(work)
    write_pretrain_corpus(work)
    glove, save_rnet = work / "glove.txt", work / "rnet"
    out = {"cli_wall_s": {}}

    def cli(name, main, argv):
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        out["cli_wall_s"][name] = time.perf_counter() - t0

    on = ["--device", device]
    cli("train_embeddings", train_embeddings.main,
        on + ["--data_dir", str(work), "--out", str(glove)])
    cli("pretrain.abae", abae.main, on + ["--data_dir", str(work), "--train_epochs", "2",
                                          "--save_path", str(work / "abae")])
    with log_lines() as (lines, _), main_path_counts() as (launches, plain_calls):
        cli("pretrain.rnet", rnet.main, on + ["--data_dir", str(work), "--train_epochs", "2",
                                              "--save_ABAE", str(work / "abae_rnet"),
                                              "--save_rnet", str(save_rnet)])
    mined = re.compile(r"Start to train R net\. \((\d+) pairs")
    n_pairs = [int(m.group(1)) for m in map(mined.search, lines) if m]
    steps = 2 * (n_pairs[0] // PRETRAIN_BATCH) if n_pairs else 0
    out.update(pairs=n_pairs[0] if n_pairs else None, steps=steps, launches=dict(launches),
               launches_bf16={k.__name__: k.launches_bf16 for m in (gru_cuda, pool_cuda)
                              for k in m.KERNELS})
    gru = FORWARD + GRU_BACKWARD
    print(f"pretraining CLIs on {device_name}: {out['cli_wall_s']} s (host clock); the R-Net "
          f"CLI mined {out['pairs']} pairs, {steps} steps of {PRETRAIN_BATCH}, launches "
          f"{launches}, plain versions on CUDA tensors {plain_calls[0]}")
    if not (steps >= 8 and all(launches[k] == steps for k in gru) and plain_calls[0] == 0
            and not any(v for k, v in launches.items() if k not in gru)
            and not any(out["launches_bf16"].values())):
        raise AssertionError("the R-Net pretraining steps did not run K1-K4 once each "
                             "(and nothing else) on the card")

    # one epoch, card against CPU, from the same weights on the same pairs
    t0 = time.perf_counter()
    w2v = Word2vec(str(glove))
    model = abae.init_abae(0, w2v.embedding, 14, kmeans=False, device="cpu")
    ckpt.restore_module(str(work / "abae_rnet"), model)
    data = abae.sentences_to_ids(w2v, train_sentences(str(work)), 20)
    s1, s2, labels = rnet.mine_pairs(data, abae.abae_predict(model, data),
                                     np.random.default_rng(0))
    runs = {}
    for run, dev in (("cpu", "cpu"), ("card", device)):
        losses = []
        m = rnet.train_pairs(w2v.embedding, s1, s2, labels, np.random.default_rng(0),
                             train_epochs=1, device=dev, losses=losses)
        runs[run] = losses, {k: v.cpu() for k, v in m.rnet.state_dict().items()}
    (cpu_loss, cpu_rnet), (card_loss, card_rnet) = runs["cpu"], runs["card"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
    leaf_gap = {k: _l2_rel(card_rnet[k], v, 1e-30) for k, v in cpu_rnet.items()}
    out.update(card_vs_cpu_loss_rel=loss_gap, card_vs_cpu_rnet_l2_rel=max(leaf_gap.values()),
               epoch_steps=len(card_loss))
    print(f"R-Net pretraining, one epoch of {len(card_loss)} steps on {device_name} against "
          f"the CPU: loss max rel gap {loss_gap:.3e}, R-Net leaves max l2 rel gap "
          f"{max(leaf_gap.values()):.3e} (tolerance {PRETRAIN_RTOL:.0e}): {leaf_gap}")
    if not (len(card_loss) == len(cpu_loss) == len(s1) // PRETRAIN_BATCH
            and loss_gap <= PRETRAIN_RTOL and max(leaf_gap.values()) <= PRETRAIN_RTOL):
        raise AssertionError("R-Net pretraining: card and CPU disagree")
    out["card_vs_cpu_s"] = time.perf_counter() - t0

    # the saved R-Net warm-starts UMPR-R on the card
    with log_lines("pretrained-rnet") as (lines, logger):
        cfg = Config(on + ["--review_net_only", "True", "--data_dir", str(work),
                           "--word2vec_file", str(glove), "--rnet_pretrained", str(save_rnet)])
        trainer = Trainer(cfg, logger, w2v)
    held = trainer.model.review_net.rnet.state_dict()
    saved = ckpt.restore_pytree(str(save_rnet), params_to_jax(held))
    bits = all(torch.equal(held[k].cpu(), v) for k, v in params_from_jax(saved).items())
    loaded = sum(f'Loaded R-Net pre-trained weights from "{save_rnet}"' in s for s in lines)
    print(f"--rnet_pretrained {save_rnet} on {device_name}: loaded {loaded} time(s), the "
          f"checkpoint's bits held: {bits}")
    if not (loaded == 1 and bits):
        raise AssertionError("the pretrained R-Net did not load into UMPR-R on the card")
    del trainer

    # one step of each pretrainer at the CLIs' shapes
    t0 = time.perf_counter()
    dev = torch.device(device)
    g = torch.Generator().manual_seed(1)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows = np.arange(PRETRAIN_BATCH)
    net = rnet.PretrainRNet(w2v.embedding, 64, torch.Generator().manual_seed(0)).to(dev)
    net_opt = make_optimizer(net, 1e-3, 0.01)
    pairs = {"s1": put(s1[rows]), "l1": put(rnet.sentence_lengths(s1[rows])),
             "s2": put(s2[rows]), "l2": put(rnet.sentence_lengths(s2[rows])),
             "y": put(labels[rows])}
    ab = abae.init_abae(0, torch.randn((len(w2v), 200), generator=g).numpy(), 14,
                        kmeans=False, device=dev)
    ab_opt = Adam(ab.named_parameters(), 0.0, 1e-3)
    ids = put(data).long()
    pos, neg = ids[:512], ids[torch.randint(len(data), (512, 20), generator=g).to(dev)]
    sg = word2vec_train.SkipGram(len(w2v) - 3, 50, g).to(dev)
    sg_opt = Adam(sg.named_parameters(), 0.0, 2e-3)
    c, o, n = (torch.randint(len(w2v) - 3, shape, generator=g).to(dev)
               for shape in ((8192,), (8192,), (8192, 5)))
    steps_fn = {"rnet": lambda: rnet.rnet_step(net, net_opt, pairs),
                "abae": lambda: abae.abae_step(ab, ab_opt, pos, neg, 0.1),
                "skipgram": lambda: word2vec_train.skipgram_step(sg, sg_opt, c, o, n)}
    out["step"] = {k: {"ms": time_cuda(fn, iters=10), "device_ms": device_ms(fn, steps=5)}
                   for k, fn in steps_fn.items()}
    out["steps_s"] = time.perf_counter() - t0
    print(f"pretraining steps on {device_name} (ms: CUDA events over 10 back-to-back steps; "
          f"device_ms: torch.profiler): R-Net at {PRETRAIN_BATCH} pairs (2,048 rows, L = 20, "
          f"E = 50, H = 64), ABAE at 512 sentences x 20 negatives (E = 200, 14 aspects), "
          f"skip-gram at 8,192 pairs x 5 negatives (E = 50): {out['step']}")
    return out


A5_K = 4  # the graphs' k in the resident-corpus runs


def _logged(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "elapsed_s")} for e in events]


def _cpu_state(model):
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def _peak(fn):
    """(fn's result, the device's peak allocated bytes during fn, bytes
    allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(), base


def a5_umpr_r_runs(device_name, root):
    """UMPR-R through ``umpr_tpu_torch.main.main`` on the dispatch corpus
    (20 steps of B = 64, P = 400): streaming (``--device_dataset off``)
    and resident (the default) at k = 1 and k = A5_K, after a streaming
    warm-up run that builds and caches the splits; every later run loads
    them (memmaps: the resident upload copies them).  Resident and streaming at the same k
    must give the same parameters, logged values and best/ bits."""
    glove = write_splits(root, seed=1, shards=5, **DISPATCH_CORPUS)
    base = ["--review_net_only", "True", "--data_dir", str(root), "--word2vec_file",
            str(glove), "--train_epochs", "1", "--learning_rate", "1e-3", "--eval_every", "20"]
    runs = {}
    # a streaming run first builds and caches the splits and warms the
    # card up; then each pair, in turns
    for mode, k in (("off", 0), ("auto", 1), ("off", 1), ("off", A5_K), ("auto", A5_K)):
        name = f"{mode}_k{k}" if k else "warm-up"
        k = k or 1
        argv = base + ["--steps_per_dispatch", str(k), "--device_dataset", mode,
                       "--model_path", str(root / name), "--log_path",
                       str(root / f"{name}.log"), "--metrics_jsonl",
                       str(root / f"{name}.jsonl")]
        with main_path_counts() as (launches, plain_calls):
            trainer = train_main.main(argv)
        events = [json.loads(line) for line in open(root / f"{name}.jsonl")]
        fit_s = next(e["elapsed_s"] for e in events if e["event"] == "epoch")
        runs[name] = dict(trainer=trainer, launches=launches, plain=plain_calls[0],
                          log=(root / f"{name}.log").read_text(), events=events,
                          fit_ms_per_step=fit_s * 1e3 / trainer.batch_counter)
    loaded = {name: [s for s in ("train", "valid", "test")
                     if f"Loaded {s} dataset from {root / f'dataset_{s}.cache'}!" in r["log"]]
              for name, r in runs.items()}
    runs.pop("warm-up")
    pairs = {}
    for k in (1, A5_K):
        off, res = runs[f"off_k{k}"], runs[f"auto_k{k}"]
        t_off, t_res = off["trainer"], res["trainer"]
        files = _npz_equal(root / f"off_k{k}" / "best" / "arrays.npz",
                           root / f"auto_k{k}" / "best" / "arrays.npz")
        memmapped = all(isinstance(d.u_tokens, np.memmap) for d, _ in t_res._dev_data.values())
        n_train = max(len(d) for d, _ in t_res._dev_data.values())
        pairs[k] = dict(
            resident=t_res._resident and not t_off._resident, memmap_upload=memmapped,
            params=_state_bits_equal(t_off.model.state_dict(), t_res.model.state_dict()),
            logged=_logged(off["events"]) == _logged(res["events"]), best_files=files,
            steps=(t_off.batch_counter, t_res.batch_counter,
                   -(-n_train // t_res.config.batch_size)),
            fit_ms_per_step={"streaming": off["fit_ms_per_step"],
                             "resident": res["fit_ms_per_step"]})
    B = runs["off_k1"]["trainer"].config.batch_size
    print(f"resident corpus on {device_name}: UMPR-R through main, one epoch at B={B}, P=400; "
          f"splits loaded from the cache {loaded}; resident against streaming {pairs}; "
          f"plain versions on the card {[r['plain'] for r in runs.values()]}")
    one = (runs["off_k1"]["launches"], runs["auto_k1"]["launches"])
    if (loaded["warm-up"] or any(len(v) != 3 for n, v in loaded.items() if n != "warm-up")
            or any(r["plain"] for r in runs.values()) or one[0] != one[1]
            or not all(one[0][key] for key in FORWARD + GRU_BACKWARD)
            or not all(p["resident"] and p["memmap_upload"] and p["params"] and p["logged"]
                       and p["best_files"] and p["steps"][0] == p["steps"][1] == p["steps"][2]
            for p in pairs.values())):
        raise AssertionError("the resident corpus and streaming disagree, or the cache "
                             "was not read")
    return runs, pairs


def a5_step_times(device_name, runs):
    """ms per step of the resident and the streaming UMPR-R step, at k = 1
    (the streaming step with its batch's copy to the card) and as a graph
    of A5_K steps, CUDA events and the idle share, on the trained models."""
    from umpr_tpu_torch.train.step import MultiTrainStep, gather_batch
    t_off, t_res = runs[f"off_k{A5_K}"]["trainer"], runs[f"auto_k{A5_K}"]["trainer"]
    dev, B = t_res.device, t_res.config.batch_size
    # the training split (the larger of the two uploaded) and its tensors
    train, data = max(t_res._dev_data.values(), key=lambda e: len(e[0]))
    host = list(itertools.islice(BatchLoader(train, B), A5_K))
    rows = torch.arange(B * A5_K, dtype=torch.int32, device=dev).reshape(A5_K, B)
    full = torch.full((A5_K,), B, dtype=torch.int32, device=dev)
    chunk = {"idx": rows, "n_real": full}
    multi_off = MultiTrainStep(t_off.model, t_off.opt)
    multi_res = MultiTrainStep(t_res.model, t_res.opt)
    stacked = _stack(host, dev)
    fns = {
        "streaming_k1": lambda: train_step(t_off.model, t_off.opt, to_device(host[0], dev)),
        "resident_k1": lambda: train_step(t_res.model, t_res.opt,
                                          gather_batch(data, rows[0], full[0])),
        f"streaming_k{A5_K}": lambda: multi_off(stacked, [None] * A5_K),
        f"resident_k{A5_K}": lambda: multi_res(chunk, [None] * A5_K, data)}
    out = {name: {"ms": []} for name in fns}
    for k in (1, A5_K):
        # in turns: streaming, resident, resident, streaming
        for mode in ("streaming", "resident", "resident", "streaming"):
            out[f"{mode}_k{k}"]["ms"].append(time_cuda(fns[f"{mode}_k{k}"], iters=5) / k)
    for name, fn in fns.items():
        busy, wall = idle_share(fn)
        per = A5_K if name.endswith(f"k{A5_K}") else 1
        out[name] = {"ms_per_step": sum(out[name]["ms"]) / 2, "turns": out[name]["ms"],
                     "busy_ms_per_step": None if busy is None else busy / per,
                     "idle": _idle(busy, wall)}
    print(f"UMPR-R train step on {device_name}, resident against streaming (CUDA events, "
          f"back to back, in turns; idle under torch.profiler): {out}")
    return out


def a5_full_bank_runs(device_name, root):
    """Full UMPR at 224 px (B = 64, --vgg_fused_pool True, seed 2), 4 train
    steps at k = 1, streaming and resident with the training photo bank:
    the same parameter bits, each distinct photo decoded once for the
    bank.  Returns the streaming trainer (its model is reused) and a
    summary."""
    from umpr_tpu_torch.data import images
    from umpr_tpu_torch.train.trainer import Trainer
    from umpr_tpu_torch.utils.logging import get_logger
    glove = write_splits(root, seed=1, shards=5)
    use_seeded_photos()
    argv = ["--review_net_only", "False", "--vgg_fused_pool", "True", "--seed", "2",
            "--data_dir", str(root), "--word2vec_file", str(glove), "--learning_rate", "1e-3",
            "--eval_every", "100", "--data_workers", "4"]
    w2v = Word2vec(str(glove))
    cfg = Config(argv)
    train, valid = (build_dataset(str(root / f"{s}.csv"), str(root / "photos.json"),
                                  str(root / "photos"), w2v, cfg) for s in ("train", "valid"))
    decode = images.get_image
    out = {}
    try:
        for mode in ("off", "on"):
            decoded = []
            images.get_image = lambda path, *a: decoded.append(path) or decode(path, *a)
            t = Trainer(Config(argv + ["--device_dataset", mode]),
                        get_logger(logger_name=f"a5-full-{mode}"), w2v)
            if mode == "off":
                # the first VGG16 step of the process pays cuDNN's first-call
                # costs: a forward and backward here, no step (the same
                # parameters)
                t.model(to_device(next(iter(t._loader(train))), t.device))[1].backward()
                t.opt.zero_grad(set_to_none=True)
            with main_path_counts() as (launches, plain_calls):
                t0 = time.perf_counter()
                t.fit(train, valid, str(root / mode), _stop_after_batches=4)
                wall = time.perf_counter() - t0
            out[mode] = dict(trainer=t, decoded=decoded, launches=launches,
                             plain=plain_calls[0], wall=wall)
    finally:
        images.get_image = decode
    t_off, t_res = out["off"]["trainer"], out["on"]["trainer"]
    uniq = set(train.photo_paths.ravel()) | set(valid.photo_paths.ravel()) | {""}
    once = sorted(out["on"]["decoded"]) == sorted(uniq)
    equal = _state_bits_equal(t_off.model.state_dict(), t_res.model.state_dict())
    bank = t_res._bank
    summary = {"params_bit_equal": equal, "decoded_once": once,
               "bank_rows": bank.shape[0], "bank_bytes": bank.numel(),
               "decodes": {m: len(o["decoded"]) for m, o in out.items()},
               "fit_ms_per_step": {m: o["wall"] * 1e3 / 4 for m, o in out.items()}}
    print(f"full UMPR, 4 steps at {cfg.photo_size} px on {device_name}, streaming and "
          f"resident with the "
          f"photo bank: {summary}; launches streaming {out['off']['launches']}, resident "
          f"{out['on']['launches']}; plain versions on the card {out['off']['plain']}, "
          f"{out['on']['plain']} (fit wall: host clock, initial validation and bank upload "
          f"included)")
    if not (equal and once and t_res._resident and not t_off._resident
            and t_res.batch_counter == 4 and not out["off"]["plain"] and not out["on"]["plain"]
            and out["off"]["launches"] == out["on"]["launches"]):
        raise AssertionError("full UMPR with the training photo bank disagrees with streaming")
    return t_off, summary, (train, cfg)


def a5_accum_and_remat(device_name, trainer, train, cfg):
    """On one full-UMPR model (224 px, B = 64, fused pool): one step at
    --grad_accum_steps 4 against the single step with dropout off (the
    loss within 1e-5 relative, gradients within GRAD_RTOL l2-relative,
    parameters within rtol 2e-5, atol 2e-6 after an Adam
    step at the reference's lr 1e-6, and a lower peak); then a step with
    --remat_vgg against without, with the same pre-drawn dropout masks
    (the same bits, less memory held from the forward to the backward, a
    peak within 1% of the plain step's, K5 twice per fused block), each
    timed in turns, and block 1's second conv alone (its peak);
    then remat at --steps_per_dispatch 2 (a graph of 2 steps) against 2
    remat steps at k = 1: the same bits."""
    from umpr_tpu_torch.models.visual_net import keep_masks
    from umpr_tpu_torch.train.optim import BETA2, make_optimizer
    from umpr_tpu_torch.train.step import MultiTrainStep, train_step_accum
    model, dev, px = trainer.model, trainer.device, cfg.photo_size
    vgg = model.visual_net.vgg16
    loader = BatchLoader(train, cfg.batch_size, ignore_photos=False, resize=(px, px),
                         photo_cache=trainer.photo_cache)
    host = list(itertools.islice(loader, 2))
    batch = to_device(host[0], dev)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    fused = sum(1 for h in (px >> j for j in range(5)) if h >= FUSED_POOL_MIN_H and h % 2 == 0)

    def fresh(lr=1e-3):
        model.load_state_dict(init)
        model.zero_grad(set_to_none=True)
        return make_optimizer(model, cfg.l2_regularization, lr)

    # --grad_accum_steps 4 against 1, dropout off
    accum = {}
    for k in (1, 4):
        opt = fresh(lr=1e-6)
        step = ((lambda: train_step(model, opt, batch)) if k == 1 else
                (lambda: train_step_accum(model, opt, batch, k)[:2]))
        (loss, n), peak, base = _peak(step)
        accum[k] = dict(loss=loss.item(), n=n.item(), peak=peak, base=base,
                        grads={name: p.grad.detach().cpu() for name, p in
                               model.named_parameters() if p.requires_grad},
                        params=_cpu_state(model))
        del opt
    g1, g4 = accum[1]["grads"], accum[4]["grads"]
    # l2-relative, a gradient below a thousandth of the largest one's norm
    # held against that thousandth, as full_train_phase holds the card
    # against the CPU (the visual linear's bias gradient is rounding alone)
    floor = 1e-3 * max(g.norm() for g in g1.values())
    grad_err = max(_l2_rel(g4[n], g1[n], floor) for n in g1)
    p1, p4 = accum[1]["params"], accum[4]["params"]
    param_diff = max((p4[k] - p1[k]).abs().max().item() for k in p1)
    params_close = all(torch.allclose(p4[k], p1[k], rtol=2e-5, atol=2e-6) for k in p1)
    loss_rel = abs(accum[4]["loss"] - accum[1]["loss"]) / max(1.0, abs(accum[1]["loss"]))
    accum_out = {"loss": {k: accum[k]["loss"] for k in accum}, "loss_rel_diff": loss_rel,
                 "grad_rel_err": grad_err, "param_max_abs_diff": param_diff,
                 "params_within_tol": params_close,
                 "peak_bytes": {k: accum[k]["peak"] for k in accum},
                 "base_bytes": {k: accum[k]["base"] for k in accum}}
    print(f"--grad_accum_steps 4 against 1 on {device_name}, one full-UMPR step "
          f"(B={cfg.batch_size}, {px} px, dropout off, Adam at lr 1e-6): {accum_out}")
    if not (loss_rel <= 1e-5 and grad_err <= GRAD_RTOL and params_close
            and accum[1]["n"] == accum[4]["n"] and accum[4]["peak"] < accum[1]["peak"]):
        raise AssertionError("--grad_accum_steps 4 disagrees with the single step, or its "
                             "peak is not lower")

    # --remat_vgg against without, the same pre-drawn masks
    gens = [torch.Generator(device=dev).manual_seed(40 + j) for j in range(2)]
    masks = [keep_masks(model.dropout_shapes(batch), g, dev) for g in gens]
    remat = {}
    for on in (False, True):
        vgg.remat = on
        opt = fresh()
        held = []

        def step():
            # train_step's body, with the memory the forward leaves for the
            # backward (the saved activations) read between the two
            opt.zero_grad(set_to_none=True)
            _, loss, _ = model(batch, masks[0])
            torch.cuda.synchronize()
            held.append(torch.cuda.memory_allocated())
            loss.backward()
            opt.step()
            return loss.detach()

        with main_path_counts() as (launches, plain_calls):
            loss, peak, base = _peak(step)
        params = _cpu_state(model)
        remat[on] = dict(params=params, peak=peak, base=base, held=held[0] - base,
                         loss=loss.item(), launches=launches, plain=plain_calls[0])
        del opt
    # ms per step, in turns (off, on, on, off), on the stepped model
    opt = fresh()
    times = {False: [], True: []}
    for on in (False, True, True, False):
        vgg.remat = on
        times[on].append(time_cuda(lambda: train_step(model, opt, batch, drop=masks[0]),
                                   iters=3, warmup=1))
    del opt
    for on in times:
        remat[on]["ms"] = sum(times[on]) / len(times[on])
    off, on = remat[False], remat[True]
    bits = _state_bits_equal(off["params"], on["params"])
    # block 1's second conv alone: its forward and backward on a (B, 64,
    # px, px) input, the transient that remat cannot shorten
    conv = vgg.features[1]
    x = torch.randn((cfg.batch_size, conv.in_channels, px, px), device=dev).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    _, conv_peak, conv_base = _peak(lambda: F.conv2d(x, conv.weight, None, padding=1).backward(
        torch.ones((cfg.batch_size, conv.out_channels, px, px), device=dev).contiguous(
            memory_format=torch.channels_last)))
    conv_bytes = x.numel() * x.element_size()
    del x
    model.zero_grad(set_to_none=True)
    k5, k6 = "bias_relu_pool", "bias_relu_pool_bwd"
    # remat at k = 2 (one graph of 2 steps) against 2 remat steps at k = 1
    vgg.remat = True
    opt = fresh()
    for j in range(2):
        train_step(model, opt, to_device(host[j], dev), drop=masks[j])
    eager2 = _cpu_state(model)
    del opt
    opt = fresh()
    multi = MultiTrainStep(model, opt)
    gens = [torch.Generator(device=dev).manual_seed(40 + j) for j in range(2)]
    with main_path_counts() as (graph_launches, graph_plain):
        multi(_stack(host, dev), gens)
    torch.cuda.synchronize()
    graph2 = _cpu_state(model)
    graph_on_card, _ = device_launches(graph_launches, [multi.graph])
    captured = multi.graph.captured
    vgg.remat = False
    del opt, multi
    graph_bits = _state_bits_equal(eager2, graph2)
    remat_out = {"params_bit_equal": bits, "peak_bytes": {"off": off["peak"], "on": on["peak"]},
                 "base_bytes": {"off": off["base"], "on": on["base"]},
                 "held_after_forward_bytes": {"off": off["held"], "on": on["held"]},
                 "conv1_2_alone": {"peak_above_base_bytes": conv_peak - conv_base,
                                   "input_bytes": conv_bytes},
                 "ms_per_step": {"off": off["ms"], "on": on["ms"]},
                 "k5_launches": {"off": off["launches"][k5], "on": on["launches"][k5]},
                 "k6_launches": {"off": off["launches"][k6], "on": on["launches"][k6]},
                 "fused_blocks": fused, "graph_k2_bit_equal": graph_bits,
                 "graph_k2_captured": {k5: captured[k5], k6: captured[k6]},
                 "graph_k2_on_card": {k5: graph_on_card[k5], k6: graph_on_card[k6]},
                 "launches": on["launches"]}
    print(f"--remat_vgg on {device_name}, one full-UMPR step (B={cfg.batch_size}, {px} px, "
          f"the same masks): "
          f"{ {k: v for k, v in remat_out.items() if k != 'launches'} }; plain versions on the "
          f"card {off['plain']}, {on['plain']}, {graph_plain[0]}")
    # the step's peak is a transient of block 1's backward (conv1_2 alone
    # is printed above), which remat leaves as it is: the two peaks differ
    # by the caching allocator's block rounding (MiBs), held here to 1%.
    # What remat removes is the activations held from the forward to the
    # backward.
    if not (bits and graph_bits and on["held"] < off["held"]
            and on["peak"] - on["base"] <= 1.01 * (off["peak"] - off["base"])
            and on["launches"][k5] == 2 * fused and off["launches"][k5] == fused
            and on["launches"][k6] == off["launches"][k6] == fused
            and captured[k5] == 2 * 2 * fused and captured[k6] == 2 * fused
            and not (off["plain"] or on["plain"] or graph_plain[0])):
        raise AssertionError("--remat_vgg changed the bits, did not lower the memory held "
                             "for the backward, raised the peak past 1%, or did not run K5 "
                             "in the recompute")
    return accum_out, remat_out


def a5_runtime_phase(device_name):
    """ROADMAP A5's training runtime on the card: the resident corpus
    (a5_umpr_r_runs, a5_step_times), the training photo bank
    (a5_full_bank_runs), --grad_accum_steps and --remat_vgg
    (a5_accum_and_remat).  Returns a summary; its remat step's launch
    counts under "remat_launches"."""
    root = WORK / "a5"
    if root.exists():
        shutil.rmtree(root)
    seconds, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        seconds[name] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()

    runs, pairs = a5_umpr_r_runs(device_name, root / "umpr_r")
    lap("umpr_r_runs")
    times = a5_step_times(device_name, runs)
    lap("step_times")
    trainer, bank, (train, cfg) = a5_full_bank_runs(device_name, root / "full")
    lap("full_umpr_bank")
    accum, remat = a5_accum_and_remat(device_name, trainer, train, cfg)
    lap("accum_and_remat")
    return {"umpr_r": {str(k): v for k, v in pairs.items()}, "step_times": times,
            "full_umpr_bank": bank, "grad_accum": accum,
            "remat": {k: v for k, v in remat.items() if k != "launches"},
            "seconds": seconds, "remat_launches": remat["launches"]}


BF16_GRAD_TOL = 5e-2  # bf16 gradients: l2-relative (tests/test_torch_bf16.py)


def input_grad_phase(device_name, device="cuda", N=2560, L=20, E=50, H=64, S=20,
                     dtype=torch.float32):
    """A gradient through ``bigru_split`` with x requiring grad, at the
    UMPR-R shapes, on the card (K1-K4 and K9) and on the CPU (plain
    versions); in f32 within SUM_RTOL, with a bf16 x (every launch the
    bf16 variant) within BF16_GRAD_TOL of the l2 norms.  Returns the card
    run's launch counts."""
    g = torch.Generator().manual_seed(8)
    x = (torch.randn(N, L, E, generator=g) * 0.5).to(dtype)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    c_pos = torch.randn(N // S, S * L, 2 * H, generator=g)
    c_sent = torch.randn(N, L, 2 * H, generator=g)
    grads = {}
    for dev in ("cpu", device):
        gru = BiGRU(E, H, generator=torch.Generator().manual_seed(9)).to(dev)
        xd = x.to(dev).detach().requires_grad_()  # a leaf on either device
        with main_path_counts() as (launches, plain_calls):
            pos, sent = bigru_split(gru, xd, lengths.to(dev), S)
            ((pos.float() * c_pos.to(dev)).sum()
             + (sent.float() * c_sent.to(dev)).sum()).backward()
            torch.cuda.synchronize()
            bf16_counts = {k.__name__: k.launches_bf16 for k in gru_cuda.KERNELS}
        grads[dev] = (xd.grad.float().cpu(),
                      {n: p.grad.cpu() for n, p in gru.named_parameters()})
    (card_dx, card_w), (cpu_dx, cpu_w) = grads[device], grads["cpu"]
    if dtype == torch.float32:
        err, tol = _rel_err, SUM_RTOL
    else:
        err, tol = (lambda a, b: _l2_rel(a, b, 1e-30)), BF16_GRAD_TOL
    dx_rel = err(card_dx, cpu_dx)
    w_rel = max(err(card_w[n], w) for n, w in cpu_w.items())
    print(f"bigru_split with a {dtype} x requiring grad (N={N}, L={L}, E={E}, H={H}) on "
          f"{device_name}: dx card vs CPU relative diff {dx_rel:.3e}, weights {w_rel:.3e} "
          f"(tolerance {tol:.0e}); launches {launches}, bf16 {bf16_counts}; plain "
          f"versions on the card {plain_calls[0]}")
    want = (dict.fromkeys(launches, 0)
            | dict.fromkeys(FORWARD + GRU_BACKWARD + ("gru_input_proj_dx",), 1))
    if plain_calls[0] or launches != want or (
            dtype == torch.bfloat16 and bf16_counts != {k: launches[k] for k in bf16_counts}):
        raise AssertionError(f"input-gradient launches {launches}, expected {want}")
    if not (dx_rel <= tol and w_rel <= tol):
        raise AssertionError("card and CPU input gradients disagree")
    return launches


def port_kernel_names(pattern="*.cu*"):
    """The names of the port's CUDA kernels, read from csrc/<pattern>."""
    kernel = re.compile(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(")
    return {name for src in _build.CSRC.glob(pattern)
            for name in kernel.findall(src.read_text())}


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


# ---- ROADMAP A5: the streaming dataset build and --compute_dtype bfloat16

def streaming_build_phase(device_name):
    """The dispatch corpus's three splits built by the streaming build
    (--build_chunk_rows 7, straight into a memmap cache) and by the
    full-memory build (0): the same arrays; the native tokenizer and the
    streaming build must have run (``dataset.PATHS``); the cache loads and
    equals them.  Host work: seconds of each build on the card's machine."""
    from umpr_tpu_torch.data import dataset as ds_mod
    root = WORK / "streaming_build"
    shutil.rmtree(root, ignore_errors=True)
    glove = write_splits(root, seed=1, shards=5, **DISPATCH_CORPUS)
    w2v = Word2vec(str(glove))
    photos = (str(root / "photos.json"), str(root / "photos"))
    out = {}
    for split in ("train", "valid", "test"):
        built, secs, paths = {}, {}, {}
        for chunk in (7, 0):
            cfg = Config(["--review_net_only", "True", "--build_chunk_rows", str(chunk)])
            before = dict(ds_mod.PATHS)
            t0 = time.perf_counter()
            built[chunk] = build_dataset(
                str(root / f"{split}.csv"), *photos, w2v, cfg,
                mmap_dir=str(root / f"cache_{split}") if chunk else None)
            secs[chunk] = time.perf_counter() - t0
            paths[chunk] = {k: ds_mod.PATHS[k] - before[k] for k in before}
        cached = ds_mod.UMPRDataset.load(str(root / f"cache_{split}"))
        for field in built[0].__dataclass_fields__:
            for other in (built[7], cached):
                if not np.array_equal(np.asarray(getattr(other, field)),
                                      np.asarray(getattr(built[0], field))):
                    raise AssertionError(f"streaming build differs in {split}.{field}")
        s, f = paths[7], paths[0]
        if not (s["streaming"] == 1 and s["native_tokenizer"] >= 1 and s["full_memory"] == 0
                and s["python_tokenizer"] == 0):
            raise AssertionError(f"the streaming build did not run natively: {s}")
        if not (f["full_memory"] == 1 and f["native_tokenizer"] == 1
                and f["native_histories"] == 1 and f["python_tokenizer"] == 0):
            raise AssertionError(f"the full-memory build did not run natively: {f}")
        out[split] = {"samples": len(built[0]), "streaming_s": secs[7],
                      "full_memory_s": secs[0], "paths_streaming": s, "paths_full": f}
    print(f"streaming build on the card's machine (host clock): {out}")
    return out


BF16_PAST_ULP = 1e-4  # the share of a bf16 output allowed past one ulp


def _bf16_check(got, want, where):
    """bf16 within one ulp of the plain version but for a share of at most
    BF16_PAST_ULP of the elements, and those within one ulp at the tensor's
    largest magnitude (tests/test_torch_kernels.py _within_ulp: a sum that
    cancels, or an operand's rounding flip carried along K2/K3's
    recurrence, moves a value near zero by many of its own ulps); returns
    the max abs error."""
    past, within = _bf16_agreement(got, want, where)
    if not within:
        raise AssertionError(f"{where} disagrees with its plain bf16 version")
    return (got.float() - want.float()).abs().max().item()


def _bf16_agreement(got, want, where):
    """_bf16_check's numbers, printed: (elements past one ulp, whether
    the check holds)."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -120))) - 7)
    top = 2.0 ** (np.floor(np.log2(max(w.abs().max().item(), 2.0 ** -120))) - 7)
    err = (g - w).abs()
    past = int((err > ulp).sum())
    print(f"{where}: max|kernel - plain| = {err.max().item():.3e}, "
          f"{(err / ulp).max().item():.1f} ulp at most, {past} of {err.numel()} past one "
          f"(one ulp at the largest |value|: {top:.3e})")
    return past, bool(past <= BF16_PAST_ULP * err.numel() and (err <= ulp + top).all())


def _l2_check(got, want, where, tol=SUM_RTOL):
    rel = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
    print(f"{where}: |kernel - plain| / |plain| = {rel:.3e} (tolerance {tol:.0e})")
    if not rel <= tol:
        raise AssertionError(f"{where} disagrees with its plain version")
    return (got - want).abs().max().item()


# bf16 K1/K4 widths off E = 50: each side of K4's route edges (52 | 53:
# four stages | two; 64 | 65: whole x rows | E tiles) and of K1's wgmma
# route (256 | 257), word2vec's 300, each side of K1's wide routes (520 |
# 521), and odd wide E (709, 1617: K4's E tiles copied 2 bytes at a time)
BF16_WIDTHS = (52, 53, 64, 65, 256, 257, 300, 400, 520, 521, 709, 1617)


def bf16_kernel_phase(device, N=2560, L=20, E=50, H=64, widths=BF16_WIDTHS):
    """K1-K4's bf16 variants against their plain bf16 versions at the
    UMPR-R shapes (and K1/K4 at BF16_WIDTHS), each launched twice for the
    same bits, with their times beside the bf16 library calls.  K1's and
    K4's rows carry their kernels' registers and spills from this run's
    build."""
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(N, L, E, generator=g) * 0.5).to(device).to(bf)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    lengths[0], lengths[1] = 1, L
    lengths = lengths.to(device)
    gru = BiGRU(E, H, generator=g).to(device)
    w_ih, b_ih, w_hh, b_hh = (t.to(bf) for t in gru.kernel_operands())
    x2 = x.reshape(N * L, E)
    M, rows = N * L, []

    def row(name, source, replaces, err, times, t_bound, by, lib_call, **extra):
        r = {"name": name, "route": "cuda", "source": f"umpr_tpu_torch/csrc/{source}",
             "replaces": f"umpr_tpu/ops/gru_pallas.py:{replaces}", "io": "bfloat16",
             "max_abs_err": err, **times, "bound_ms": t_bound, "bound_by": by,
             "library_call": lib_call, **extra}
        print_row(r)
        rows.append(r)

    def same(fn, ref):
        out = fn()
        if not all(torch.equal(a, b) for a, b in zip(
                out if isinstance(out, tuple) else (out,), ref if isinstance(ref, tuple)
                else (ref,))):
            raise AssertionError("a second launch gave other bits")

    k1 = lambda: gru_cuda.gru_input_proj(x2, w_ih, b_ih)  # noqa: E731
    xg = k1()
    torch.cuda.synchronize()
    err = _bf16_check(xg, gru_cuda.gru_input_proj_ref(x2, w_ih, b_ih), "K1 bf16")
    same(k1, xg)
    at_e = {}
    for e in widths:
        gx = torch.Generator(device=device).manual_seed(e)
        xe = torch.randn(M, e, generator=gx, device=device).to(bf)
        we = (torch.randn(e, 6 * H, generator=gx, device=device) * (50 / e) ** 0.5).to(bf)
        ge = torch.randn(M, 6 * H, generator=gx, device=device).to(bf)
        k1e = lambda: gru_cuda.gru_input_proj(xe, we, b_ih)  # noqa: E731
        k4e = lambda: gru_cuda.gru_input_proj_bwd(xe, ge)  # noqa: E731
        out1, out4 = k1e(), k4e()
        _bf16_check(out1, gru_cuda.gru_input_proj_ref(xe, we, b_ih), f"K1 bf16 at E = {e}")
        want4 = gru_cuda.gru_input_proj_bwd_ref(xe, ge)
        _l2_check(out4[0], want4[0], f"K4 bf16 dW at E = {e}")
        _l2_check(out4[1], want4[1], f"K4 bf16 db at E = {e}")
        same(k1e, out1)
        same(k4e, out4)
        at_e[e] = {"gru_input_proj_device_ms": device_ms(k1e),
                   "addmm_device_ms": device_ms(lambda: torch.addmm(b_ih, xe, we)),
                   "gru_input_proj_bound_ms": k1_bound(M, e, 6 * H, 2)[0],
                   "gru_input_proj_bwd_device_ms": device_ms(k4e)}
        print(f"K1 bf16 at E = {e}: device ms {_ms(at_e[e]['gru_input_proj_device_ms'])}, "
              f"bf16 torch.addmm {_ms(at_e[e]['addmm_device_ms'])}, bound "
              f"{at_e[e]['gru_input_proj_bound_ms']:.4f}")
    t_bound, by = k1_bound(M, E, 6 * H, 2)
    row("gru_input_proj_bf16", "gru_input_proj.cu", 319, err,
        timed(k1, lambda: gru_cuda.gru_input_proj_ref(x2, w_ih, b_ih),
              lambda: torch.addmm(b_ih, x2, w_ih)),
        t_bound, by, "torch.addmm (bf16)", at_E=at_e, ptxas=bf16_ptxas("gru_input_proj"))

    xg = xg.view(N, L, 6 * H)
    k2 = lambda: gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)  # noqa: E731
    y = k2()
    torch.cuda.synchronize()
    err = _bf16_check(y, gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh), "K2 bf16")
    past = torch.arange(L, device=device)[None, :] >= lengths[:, None]
    if not bool((y[past] == 0).all()):
        raise AssertionError("K2 bf16: a position past its length is not zero")
    same(k2, y)
    lib = torch.nn.GRU(E, H, batch_first=True, bidirectional=True).to(device)
    lib.load_state_dict(gru.state_dict())
    lib = lib.to(bf)
    lengths_cpu = lengths.cpu()
    pack = torch.nn.utils.rnn.pack_padded_sequence
    library = lambda: lib(pack(x, lengths_cpu, batch_first=True, enforce_sorted=False))[0]  # noqa: E731,E501
    valid = int(lengths.sum())
    t_bound, by = k2_bf16_bound(lengths, y.numel(), H)
    parts = part_split(k2, K2_PARTS)
    print_split("K2 bf16", parts)
    row("bigru_recurrence_bf16", "bigru_recurrence.cu", 205, err,
        timed(k2, lambda: gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh), library,
              plain_iters=3), t_bound, by,
        "torch.nn.GRU(bidirectional, bf16) on pack_padded_sequence",
        device_ms_by_kernel=parts, ptxas=bf16_ptxas("bigru_recurrence"),
        at_shape=k2_bf16_shapes(device))

    gd = torch.Generator(device=device).manual_seed(1)
    dy_sent = torch.randn(N, L, 2 * H, generator=gd, device=device).to(bf)
    dy_pos = torch.randn(N // 20, 20 * L, 2 * H, generator=gd, device=device).to(bf)
    k3 = lambda: gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)  # noqa: E731,E501
    dxg, dw, db = k3()
    torch.cuda.synchronize()
    want = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
    err = _bf16_check(dxg, want[0], "K3 bf16 dxg")
    _l2_check(dw, want[1], "K3 bf16 dW_hh")
    _l2_check(db, want[2], "K3 bf16 db_hh")
    same(k3, (dxg, dw, db))
    with torch.enable_grad():
        lib_params = [p.requires_grad_() for p in lib.parameters()]
        lib_out = library().data
        lib_ct = torch.randn_like(lib_out)
        library_bwd = lambda: torch.autograd.grad(lib_out, lib_params, lib_ct,  # noqa: E731
                                                  retain_graph=True)
        n_bytes = 2 * (2 * valid * 6 * H + dxg.numel() + w_hh.numel() + b_hh.numel()) + 4 * N
        t_bound, by = bound(n_bytes, 0, bf16_flops=3 * 2 * valid * 2 * H * 3 * H)
        parts = part_split(k3, K3_PARTS)
        print_split("K3 bf16", parts)
        row("bigru_backward_bf16", "bigru_backward.cu", 698, err,
            timed(k3, lambda: gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths,
                                                           w_hh, b_hh),
                  library_bwd, plain_iters=2),
            t_bound, by, "torch.autograd.grad of torch.nn.GRU(bidirectional, bf16)",
            device_ms_by_kernel=parts, ptxas=bf16_ptxas("bigru_backward"),
            at_H=k3_bf16_widths(device, K3_BF16_WIDTHS, N, L))
        for p in lib_params:
            p.requires_grad_(False)

    dxg2 = dxg.view(M, 6 * H)
    k4 = lambda: gru_cuda.gru_input_proj_bwd(x2, dxg2)  # noqa: E731
    dw4, db4 = k4()
    torch.cuda.synchronize()
    want = gru_cuda.gru_input_proj_bwd_ref(x2, dxg2)
    err = _l2_check(dw4, want[0], "K4 bf16 dW_ih")
    _l2_check(db4, want[1], "K4 bf16 db_ih")
    same(k4, (dw4, db4))
    t_bound, by = bound(2 * (x2.numel() + dxg2.numel()) + 4 * (dw4.numel() + db4.numel()),
                        M * 6 * H, bf16_flops=2 * M * E * 6 * H)
    library, library_call = bf16_dw_library(x2, dxg2)
    row("gru_input_proj_bwd_bf16", "gru_input_proj_bwd.cu", 394, err,
        timed(k4, lambda: gru_cuda.gru_input_proj_bwd_ref(x2, dxg2), library),
        t_bound, by, library_call, partials=gru_cuda.proj_bwd_bf16_chunks(M)[1],
        ptxas=bf16_ptxas("gru_input_proj_bwd"))
    return rows


def bf16_ptxas(source):
    """The bf16 kernels of `source` in this run's build report (printed),
    as [kernel, registers, spill store bytes, spill load bytes] lists: by
    name, or instantiated on __nv_bfloat16; empty where the library was
    built before this run."""
    report = [list(r) for r in PTXAS.get(source, ())
              if "bf16" in r[0] or "bfloat16" in r[0]]
    print_ptxas(source, report)
    return report


def k2_bf16_bound(lengths, y_numel, H):
    """bf16 K2's bound at this run's lengths: xg read at the valid steps,
    y written in full, W_hh, b_hh and the lengths read once; one (H x 3H)
    product a valid step and direction at the bf16 tensor-core rate."""
    valid = int(lengths.sum())
    return bound(2 * (2 * valid * 3 * H + y_numel + 2 * H * 3 * H + 2 * 3 * H)
                 + 4 * lengths.numel(), 0, bf16_flops=2 * valid * 2 * H * 3 * H)


def k2_bf16_at(device, N, L, H):
    """bf16 K2 at (N, L, H) on _k2_bf16_operands, timed by part beside its
    bound, with its agreement: values past one ulp of the plain version
    and _bf16_check's verdict, exact zeros past each length, the same bits
    on a second launch.  Raises nothing (a parent tree's kernel is timed
    through it too)."""
    xg, lengths, w_hh, b_hh = _k2_bf16_operands(device, N, L, H)
    k2 = lambda: gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)  # noqa: E731
    y = k2()
    torch.cuda.synchronize()
    where = f"K2 bf16 at (N, L, H) = {(N, L, H)}"
    want = gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
    past, within = _bf16_agreement(y, want, where)
    out = {"max_abs_err": (y.float() - want.float()).abs().max().item(), "past_ulp": past,
           "within_tolerance": within,
           "zeros_past_lengths": bool((y[torch.arange(L, device=device)[None, :]
                                         >= lengths[:, None]] == 0).all()),
           "same_bits": torch.equal(k2(), y)}
    parts = part_split(k2, K2_PARTS)
    out["device_ms"] = sum(v for v in parts.values() if isinstance(v, float))
    out["device_ms_by_kernel"] = parts
    out["bound_ms"], out["bound_by"] = k2_bf16_bound(lengths, y.numel(), H)
    print_split(f"{where} (total {out['device_ms']:.4f}, bound {out['bound_ms']:.4f} by "
                f"{out['bound_by']})", parts)
    del xg, y, want
    torch.cuda.empty_cache()
    return out


def k2_bf16_shapes(device, shapes=K2_BF16_AT):
    """k2_bf16_at at each (N, L, H) of `shapes`; raises where K2 disagrees
    with its plain version (_bf16_check), a value past its length is not
    zero or a second launch gives other bits.  Returns {"NxLxH": ...}."""
    out = {}
    for N, L, H in shapes:
        r = out[f"{N}x{L}x{H}"] = k2_bf16_at(device, N, L, H)
        if not (r["within_tolerance"] and r["zeros_past_lengths"] and r["same_bits"]):
            raise AssertionError(f"K2 bf16 at {(N, L, H)}: {r}")
    return out


K3_BF16_WIDTHS = (128, 192)  # bf16 K3 timed beside H = 64: the sweep's last H, the wide route


def k3_bf16_widths(device, widths, N=2560, L=20):
    """bf16 K3 at (N, L, H) for each H of `widths`, on seeded bf16 inputs
    (y from K2): held against its plain version (dxg within one bf16 ulp
    but for a BF16_PAST_ULP share, dW / db within SUM_RTOL of their l2
    norms), the same bits on a second launch, and timed by part.  Returns
    {H: {"device_ms": total, "device_ms_by_kernel": parts}}."""
    out = {}
    for H in widths:
        xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh = _k3_bf16_operands(device, N, L, H)
        k3 = lambda: gru_cuda.bigru_backward(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)  # noqa: E731,E501
        got = k3()
        torch.cuda.synchronize()
        want = gru_cuda.bigru_backward_ref(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)
        _bf16_check(got[0], want[0], f"K3 bf16 dxg at H = {H}")
        _l2_check(got[1], want[1], f"K3 bf16 dW_hh at H = {H}")
        _l2_check(got[2], want[2], f"K3 bf16 db_hh at H = {H}")
        if not all(torch.equal(a, b) for a, b in zip(k3(), got)):
            raise AssertionError(f"K3 bf16 at H = {H}: a second launch gave other bits")
        parts = part_split(k3, K3_PARTS)
        total = sum(v for v in parts.values() if isinstance(v, float))
        print_split(f"K3 bf16 at H = {H} (total {total:.4f})", parts)
        out[H] = {"device_ms": total, "device_ms_by_kernel": parts}
        del xg, y, got, want
        torch.cuda.empty_cache()
    return out


def bf16_dw_library(x, dxg):
    """K4's function in PyTorch calls on bf16 x, dxg: f32 dW = x^T dxg and
    f32 db = the column sums.  torch.mm's out_dtype overload keeps the
    bf16 operands (f32 accumulation, as K4); where this torch has none,
    the operands are widened first.  Returns (fn, its description)."""
    try:
        torch.mm(x[:1].t(), dxg[:1], out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return ((lambda: (x.t().float() @ dxg.float(), dxg.sum(0, dtype=torch.float32))),
                "x.T.float() @ dxg.float() and dxg.sum(0, dtype=float32) (this torch's mm "
                "has no out_dtype)")
    return ((lambda: (torch.mm(x.t(), dxg, out_dtype=torch.float32),
                      dxg.sum(0, dtype=torch.float32))),
            "torch.mm(x.T, dxg, out_dtype=float32) and dxg.sum(0, dtype=float32)")


BF16_GRU = gru_cuda.KERNELS[:4]  # K1-K4: bf16 UMPR-R's main path


def _bf16_launches():
    return {k.__name__: k.launches_bf16 for k in BF16_GRU}


def _predict_forward(model, batch):
    """The Predictor's forward of one device batch (full static padding)."""
    return serve.Predictor._forward(SimpleNamespace(model=model), batch)


def _turns(fns, iters):
    """ms per call of each named fn, timed in turns (a, b, b, a)."""
    names = list(fns)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(time_cuda(fns[n], iters=iters))
    return {n: {"ms": sum(v) / len(v), "turns": v} for n, v in ms.items()}


def bf16_phase(device_name):
    """--compute_dtype bfloat16 through the port's entry points: UMPR-R
    trained through main on the resident corpus (the main path of K1-K4's
    bf16 variants: every launch bf16, no plain version on the card), its
    train step at k = 1 and
    as a graph of 4 and its serving forward against f32 in turns; full UMPR
    at 224 px, one train step and the serving forward against f32 (within
    the JAX package's bf16 bounds: loss 0.05, predictions 0.08); then a
    bf16 UMPR-R resume, bit-equal.  Returns (the main path's launches,
    numbers)."""
    root = WORK / "bf16_train"
    glove = write_splits(root, seed=1, shards=5)
    argv = ["--review_net_only", "True", "--data_dir", str(root),
            "--word2vec_file", str(glove), "--train_epochs", "2",
            "--learning_rate", "1e-3", "--eval_every", "2", "--compute_dtype", "bfloat16",
            "--model_path", str(root / "model"), "--log_path", str(root / "train.log"),
            "--metrics_jsonl", str(root / "metrics.jsonl"), "--cache_dataset", "False"]
    with main_path_counts() as (launches, plain_calls):
        trainer = train_main.main(argv)  # the resident corpus (--device_dataset auto)
        bf16_counts = _bf16_launches()
    events = [json.loads(line) for line in open(root / "metrics.jsonl")]
    values = [v for e in events for k, v in e.items()
              if k in ("train_loss", "valid_mse", "test_mse")]
    print(f"bf16 UMPR-R training: {trainer.batch_counter} steps, launches {launches}, "
          f"bf16 launches {bf16_counts}, plain versions on the card {plain_calls[0]}; "
          f"logged {[{k: v for k, v in e.items() if k != 'ts'} for e in events]}")
    if plain_calls[0] or not values or not all(np.isfinite(v) for v in values):
        raise AssertionError("bf16 training ran a plain version or logged a non-finite value")
    for k in BF16_GRU:
        if not launches[k.__name__] or bf16_counts[k.__name__] != launches[k.__name__]:
            raise AssertionError(f"{k.__name__}: not every launch was the bf16 variant")
    if any(launches[k] for k in launches if k not in bf16_counts):
        raise AssertionError(f"bf16 UMPR-R launched another kernel: {launches}")

    # step and forward times, bf16 against f32 on the same weights
    cfg16 = trainer.config
    cfg32 = copy.copy(cfg16)
    cfg32.compute_dtype = "float32"
    dev = trainer.device
    w2v = Word2vec(str(glove))
    ds = build_dataset(str(root / "train.csv"), str(root / "photos.json"),
                       str(root / "photos"), w2v, cfg16)
    batch = to_device(next(iter(BatchLoader(ds, cfg16.batch_size))), dev)
    models, opts, trainers = {}, {}, {}
    for name, cfg in (("float32", cfg32), ("bfloat16", cfg16)):
        m = UMPR(ModelDims.from_config(cfg), w2v.embedding).to(dev)
        m.load_state_dict(trainer.model.state_dict())
        models[name] = m
        opts[name] = make_optimizer(m, cfg.l2_regularization, cfg.learning_rate)
        trainers[name] = SimpleNamespace(model=m, opt=opts[name], config=cfg, device=dev)
    out = {"launches_bf16": bf16_counts}
    with torch.inference_mode():  # on the trained weights, before the timed steps
        preds = {n: _predict_forward(m.eval(), batch).float() for n, m in models.items()}
    for m in models.values():
        m.train()
    out["umpr_r_step_k1"] = _turns(
        {n: (lambda n=n: train_step(models[n], opts[n], batch, 1e-3)) for n in models}, 10)
    out[f"umpr_r_step_k{DISPATCH_K}"] = {}
    for n in ("float32", "bfloat16", "bfloat16", "float32"):
        ms, busy, wall = graph_step_ms(trainers[n], ds)
        out[f"umpr_r_step_k{DISPATCH_K}"].setdefault(n, []).append(
            {"ms": ms, "idle": _idle(busy, wall)})
    with torch.inference_mode():
        for m in models.values():
            m.eval()
        out["umpr_r_serving_forward"] = _turns(
            {n: (lambda n=n: _predict_forward(models[n], batch)) for n in models}, 10)
    gap = (preds["bfloat16"] - preds["float32"]).abs().max().item()
    out["umpr_r_pred_gap"] = gap
    print(f"UMPR-R on {device_name}, bf16 against f32 (CUDA events, in turns): {out}")
    if not gap <= 0.08:
        raise AssertionError(f"bf16 UMPR-R predictions {gap} from f32's")
    del models, opts, trainers

    out["full_umpr"] = bf16_full_umpr(device_name, batch, w2v)
    out["resume_bit_equal"] = resume_phase(device_name, "resume_bf16",
                                           ("--review_net_only", "True",
                                            "--compute_dtype", "bfloat16"))
    return launches, out


BF16_FULL_PX = 224  # full UMPR's photo size in the bf16 phase


def bf16_full_umpr(device_name, batch, w2v):
    """Full UMPR at 224 px (the default --vgg_fused_pool False), one train
    step and the serving forward, bf16 against f32 on the same weights and
    seeded photos: loss within rtol/atol 0.05, predictions within 0.08
    (the JAX package's bf16 test bounds), K1-K4 launched in bf16 only."""
    cfg = Config(["--review_net_only", "False", "--seed", "2",
                  "--photo_size", str(BF16_FULL_PX)])
    dev, B, px = batch["ratings"].device, batch["ratings"].shape[0], BF16_FULL_PX
    g = torch.Generator(device=dev).manual_seed(7)
    fb = dict(batch, photos=torch.randint(0, 256, (B, 1, 1, px, px, 3), generator=g,
                                          device=dev, dtype=torch.uint8))
    models, opts = {}, {}
    base = UMPR(ModelDims.from_config(cfg), w2v.embedding,
                torch.Generator().manual_seed(cfg.seed))
    with torch.no_grad():
        base.linear_fusion.bias.fill_(3.0)  # above the ReLU: the predictions compare
    for name in ("float32", "bfloat16"):
        dims = dataclasses.replace(ModelDims.from_config(cfg), compute_dtype=name)
        m = UMPR(dims, w2v.embedding).to(dev)
        m.load_state_dict(base.state_dict())
        models[name] = m
        opts[name] = make_optimizer(m, cfg.l2_regularization, 1e-6)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the Trainer sets it
    out = {}
    with torch.inference_mode():
        for m in models.values():
            m.eval()
        res = {n: m(fb) for n, m in models.items()}
        out["serving_forward"] = _turns(
            {n: (lambda n=n: _predict_forward(models[n], fb)) for n in models}, 5)
    pred_gap = (res["bfloat16"][0] - res["float32"][0]).abs().max().item()
    l16, l32 = res["bfloat16"][1].item(), res["float32"][1].item()
    for m in models.values():
        m.train()
    gru_cuda.reset_launches()
    train_step(models["bfloat16"], opts["bfloat16"], fb)
    step_bf16 = _bf16_launches()
    if not all(step_bf16.values()) or any(
            k.launches != k.launches_bf16 for k in BF16_GRU):
        raise AssertionError(f"full UMPR bf16 step: not every K1-K4 launch in bf16: "
                             f"{step_bf16}")
    out["train_step"] = _turns(
        {n: (lambda n=n: train_step(models[n], opts[n], fb)) for n in models}, 3)
    for n in models:
        torch.cuda.reset_peak_memory_stats()
        train_step(models[n], opts[n], fb)
        out["train_step"][n]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.backends.cudnn.deterministic = deterministic
    out.update(loss_bf16=l16, loss_f32=l32, pred_gap=pred_gap, launches_bf16_step=step_bf16)
    print(f"full UMPR at 224 px on {device_name}, bf16 against f32 (CUDA events, in "
          f"turns, cudnn.deterministic): {out}")
    if not (pred_gap <= 0.08 and abs(l16 - l32) <= 0.05 + 0.05 * abs(l32)):
        raise AssertionError("bf16 full UMPR left the JAX package's bf16 bounds")
    return out


# ---- ROADMAP A5's end: bf16 K5, K6 and K9, the bf16 long-history route and
# the bf16 scan; then A6, export

def bf16_pool_dx_kernel_phase(device, shapes=POOL_SHAPES, M=51200, E=50, H=64):
    """K5/K6's and K9's bf16 variants against their plain bf16 versions:
    K5/K6 at the three fused VGG blocks (B=64, 224 px) on a coarse grid
    (ties and all-negative windows occur), each row summed over the shapes
    as the f32 rows are: yp, idx and dx bit-equal, db within one bf16 ulp;
    K9 at the UMPR-R shape (M = 51,200, E = 50, H = 64), within one ulp but
    for BF16_PAST_ULP's share near zero; the same bits twice.  Times beside
    the bf16 library calls."""
    bf = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(15)
    names = ("bias_relu_pool_bf16", "bias_relu_pool_bwd_bf16")
    per_shape = {n: [] for n in names}
    errs = dict.fromkeys(names, 0.0)
    for shape in shapes:
        N, Hh, W, C = shape
        x = ((torch.randn(shape, generator=g, device=device) * 2).round() / 2).to(bf)
        b = ((torch.randn(C, generator=g, device=device) * 0.4).round() / 4).to(bf)
        dyp = torch.randn(N, Hh // 2, W // 2, C, generator=g, device=device).to(bf)
        yp, idx = pool_cuda.bias_relu_pool(x, b)
        dx, db = pool_cuda.bias_relu_pool_bwd(dyp, idx, yp)
        torch.cuda.synchronize()
        ref_yp, ref_idx = pool_cuda.bias_relu_pool_ref(x, b)
        ref_dx, ref_db = pool_cuda.bias_relu_pool_bwd_ref(dyp, ref_idx, ref_yp)
        exact = (torch.equal(yp, ref_yp), torch.equal(idx, ref_idx), torch.equal(dx, ref_dx))
        errs[names[0]] = max(errs[names[0]], (yp.float() - ref_yp.float()).abs().max().item())
        errs[names[1]] = max(errs[names[1]], (dx.float() - ref_dx.float()).abs().max().item(),
                             _bf16_check(db, ref_db, f"K6 bf16 db at x {shape}"))
        dead = (ref_yp == 0).float().mean().item()
        del ref_yp, ref_idx, ref_dx
        again = (*pool_cuda.bias_relu_pool(x, b), *pool_cuda.bias_relu_pool_bwd(dyp, idx, yp))
        same = all(torch.equal(a, c) for a, c in zip(again, (yp, idx, dx, db)))
        del again
        print(f"K5/K6 bf16 at x {shape}: yp, idx, dx bit-equal to plain {exact}; second "
              f"launch same bits {same}; windows pooled exactly 0 {dead:.1%}")
        if not (all(exact) and same):
            raise AssertionError(f"K5/K6 bf16 disagree with their plain versions at {shape}")
        xr = x.permute(0, 3, 1, 2).detach().requires_grad_()
        br = b.view(1, C, 1, 1).detach().requires_grad_()
        with torch.enable_grad():
            out, _ = F.max_pool2d(F.relu(xr + br), 2, return_indices=True)
        dout = dyp.permute(0, 3, 1, 2)
        n_in, n_out = x.numel(), yp.numel()
        rows = ((names[0], lambda: pool_cuda.bias_relu_pool(x, b),
                 lambda: pool_cuda.bias_relu_pool_ref(x, b),
                 lambda: F.max_pool2d(F.relu(xr.detach() + br.detach()), 2,
                                      return_indices=True),
                 bound(2 * (n_in + C + n_out) + n_out, 5 * n_in)),
                (names[1], lambda: pool_cuda.bias_relu_pool_bwd(dyp, idx, yp),
                 lambda: pool_cuda.bias_relu_pool_bwd_ref(dyp, idx, yp),
                 lambda: torch.autograd.grad(out, (xr, br), dout, retain_graph=True),
                 bound(2 * (2 * n_out + n_in + C) + n_out, 8 * n_out)))
        for name, kernel, plain, library, (t_bound, by) in rows:
            per_shape[name].append({
                "x": list(shape),
                **timed(kernel, plain, library, iters=10, plain_iters=3, lib_iters=10),
                "bound_ms": t_bound, "bound_by": by})
        del x, dyp, yp, idx, dx, xr, br, out, dout
        torch.cuda.empty_cache()
    kernel_rows = pool_rows(per_shape, errs, "_bf16", io="bfloat16")

    gd = torch.Generator(device=device).manual_seed(7)
    dxg = torch.randn(M, 6 * H, generator=gd, device=device).to(bf)
    w = (torch.randn(E, 6 * H, generator=gd, device=device) / (6 * H) ** 0.5).to(bf)
    k9 = lambda: gru_cuda.gru_input_proj_dx(dxg, w)  # noqa: E731
    dx9 = k9()
    torch.cuda.synchronize()
    err = _bf16_check(dx9, gru_cuda.gru_input_proj_dx_ref(dxg, w), "K9 bf16")
    if not torch.equal(k9(), dx9):
        raise AssertionError("K9 bf16: a second launch gave other bits")
    # bf16 products at the bf16 rate; the two directions' rounded sum on the CUDA cores
    t_bound, by = k9_bound(M, 6 * H, E)
    row = {"name": "gru_input_proj_dx_bf16", "route": "cuda",
           "source": "umpr_tpu_torch/csrc/gru_input_proj_dx.cu",
           "replaces": "umpr_tpu/ops/gru_pallas.py:394", "replaces_branch": "emit_dxc=True",
           "io": "bfloat16", "max_abs_err": err,
           **timed(k9, lambda: gru_cuda.gru_input_proj_dx_ref(dxg, w),
                   lambda: torch.mm(dxg, w.t())),
           "bound_ms": t_bound, "bound_by": by, "library_call": "torch.mm(dxg, w_ih.t()) (bf16)",
           "at_shape": k9_bf16_shapes(device)}
    print_row(row)
    return kernel_rows + [row]


def k9_bound(M, G, E):
    """bf16 K9's bound at (M, 6H = G, E): dxg and W read and dx written
    once, the products at the bf16 rate, the directions' rounded sum on
    the CUDA cores."""
    return bound(2 * (M * G + E * G + M * E), M * E, bf16_flops=2 * M * G * E)


# bf16 K9 off the UMPR-R shape (M, 6H, E): its column tiles (E = 56, 64,
# 65, 300), odd H = 17 (2-byte halves), H = 100 (3H = 300) and a 3H past
# its wgmma kernel's shared memory (H = 256, the mma.sync kernel)
K9_BF16_AT = ((51200, 384, 56), (51200, 384, 64), (51200, 384, 65), (51200, 384, 300),
              (51200, 102, 50), (51200, 600, 50), (20000, 1536, 50))


def k9_bf16_shapes(device, shapes=K9_BF16_AT):
    """bf16 K9 at each (M, 6H, E) of `shapes`: within one ulp of its
    plain version but for BF16_PAST_ULP's share (_bf16_check), the same
    bits twice, its device ms beside bf16 torch.mm's and its bound.
    Returns {"MxGxE": {...}}."""
    out = {}
    for M, G, E in shapes:
        g = torch.Generator(device=device).manual_seed(M + G + E)
        dxg = torch.randn(M, G, generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn(E, G, generator=g, device=device) / G ** 0.5).to(torch.bfloat16)
        k9 = lambda: gru_cuda.gru_input_proj_dx(dxg, w)  # noqa: E731
        dx = k9()
        torch.cuda.synchronize()
        where = f"K9 bf16 at (M, 6H, E) = {(M, G, E)}"
        err = _bf16_check(dx, gru_cuda.gru_input_proj_dx_ref(dxg, w), where)
        if not torch.equal(k9(), dx):
            raise AssertionError(f"{where}: a second launch gave other bits")
        t_bound, by = k9_bound(M, G, E)
        r = out[f"{M}x{G}x{E}"] = {
            "device_ms": device_ms(k9), "mm_device_ms": device_ms(lambda: torch.mm(dxg, w.t())),
            "bound_ms": t_bound, "bound_by": by, "max_abs_err": err}
        print(f"{where}: device ms {_ms(r['device_ms'])}, bf16 torch.mm "
              f"{_ms(r['mm_device_ms'])}, bound {t_bound:.4f} ({by})")
        del dxg, dx
        torch.cuda.empty_cache()
    return out


K1_F32_TURN_WIDTHS = (113, 200, 300, 352, 353, 400, 452, 453, 520, 709, 1617)  # routes' edges
K49_F32_WIDTHS = (100, 200, 300)  # f32 K4 and K9 at GloVe's and word2vec's widths
TURNS_DIM = 300  # the word table of the f32 UMPR-R train step timed in turns


def k49_f32_widths(device, M=51200, G=384, widths=K49_F32_WIDTHS):
    """f32 K4 and K9 at (M, E, 6H = G) for each E of `widths`, each held
    against its plain version (K4: dW and db within SUM_RTOL of their
    largest entries; K9: within K9_TOL), timed (device ms under
    torch.profiler) beside its library calls (K4: x.T @ dxg and
    dxg.sum(0); K9: torch.mm(dxg, w_ih.t()); TF32 off) and its bound (3xTF32
    products at the TF32 rate).  Returns {"K4": {E: ...}, "K9": {E: ...}}."""
    out = {"K4": {}, "K9": {}}
    for e in widths:
        g = torch.Generator(device=device).manual_seed(e)
        x = torch.randn(M, e, generator=g, device=device)
        dxg = torch.randn(M, G, generator=g, device=device)
        w = torch.randn(e, G, generator=g, device=device) / G ** 0.5
        k4 = lambda: gru_cuda.gru_input_proj_bwd(x, dxg)  # noqa: E731
        k9 = lambda: gru_cuda.gru_input_proj_dx(dxg, w)  # noqa: E731
        dw, db = k4()
        dx = k9()
        torch.cuda.synchronize()
        want_dw, want_db = gru_cuda.gru_input_proj_bwd_ref(x, dxg)
        rel4 = max(_rel_err(dw, want_dw), _rel_err(db, want_db))
        rel9 = _rel_err(dx, gru_cuda.gru_input_proj_dx_ref(dxg, w))
        if not (rel4 <= SUM_RTOL and rel9 <= K9_TOL):
            raise AssertionError(f"f32 K4 or K9 at E = {e} disagrees with its plain version")
        t4, by4 = bound(4 * (M * e + M * G + e * G + G), M * G, tf32_flops=3 * 2 * M * e * G)
        t9, by9 = bound(4 * (M * G + e * G + M * e), 0, tf32_flops=3 * 2 * M * G * e)
        r4 = out["K4"][e] = {"device_ms": device_ms(k4), "max_rel_err": rel4,
                             "library_device_ms": device_ms(lambda: (x.t() @ dxg, dxg.sum(0))),
                             "bound_ms": t4, "bound_by": by4,
                             "kernels": sorted(device_split(k4, steps=3))}
        r9 = out["K9"][e] = {"device_ms": device_ms(k9), "max_rel_err": rel9,
                             "library_device_ms": device_ms(lambda: torch.mm(dxg, w.t())),
                             "bound_ms": t9, "bound_by": by9,
                             "kernels": sorted(device_split(k9, steps=3))}
        for name, r, lib in (("K4", r4, "x.T @ dxg + dxg.sum(0)"),
                             ("K9", r9, "torch.mm(dxg, w_ih.t())")):
            print(f"{name} f32 at (M, E, 6H) = {(M, e, G)}: device ms {_ms(r['device_ms'])}, "
                  f"{lib} {_ms(r['library_device_ms'])}, bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']}); kernels {r['kernels']}", flush=True)
        del x, dxg, w, dw, db, dx
        torch.cuda.empty_cache()
    return out


def _k1_kernels(keys):
    """The K1 kernels among profiler keys (not K4's _bwd nor K9's _dx)."""
    return sorted(k for k in keys
                  if "gru_input_proj" in k and "_bwd" not in k and "_dx" not in k)


def step_turns(device, parent_lib, dim=TURNS_DIM):
    """f32 UMPR-R's train step with a seeded synthetic `dim`-d word table,
    as a graph of DISPATCH_K steps (graph_step_ms), with the parent's K1
    library (`parent_lib`, a ctypes.CDLL of its gru_input_proj.cu) and this
    tree's, in turns (parent, change, change, parent): every other kernel
    is this tree's.  Before each turn one eager train step from the same
    initial weights and batch runs under torch.profiler: the K1 kernels it
    launched show which library ran (the parent's lacks
    gru_input_proj_xt, this tree's takes it), and its loss must agree
    between the sides within E2E_TOL.  Returns {"parent": [...],
    "change": [...]}, each turn's ms a step, idle share, first-step loss
    and K1 kernels."""
    root = WORK / "turns_step"
    shutil.rmtree(root, ignore_errors=True)
    glove = write_splits(root, seed=1, shards=5, dim=dim)
    cfg = Config(["--review_net_only", "True", "--data_dir", str(root), "--word2vec_file",
                  str(glove), "--learning_rate", "1e-3", "--cache_dataset", "False"])
    w2v = Word2vec(str(glove))
    ds = build_dataset(str(root / "train.csv"), str(root / "photos.json"), str(root / "photos"),
                       w2v, cfg)
    model = UMPR(ModelDims.from_config(cfg), w2v.embedding).to(device)
    init = copy.deepcopy(model)
    batch = to_device(next(iter(BatchLoader(ds, cfg.batch_size))), device)
    trainer = SimpleNamespace(model=model, config=cfg, device=device,
                              opt=make_optimizer(model, cfg.l2_regularization, 1e-3))
    change = _build.library("gru_input_proj")
    parent_lib.error_string.argtypes, parent_lib.error_string.restype = [ctypes.c_int], \
        ctypes.c_char_p
    out = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        _build._libs["gru_input_proj"] = parent_lib if side == "parent" else change
        try:
            with torch.enable_grad():
                losses = []

                def first_step():
                    m = copy.deepcopy(init)
                    opt = make_optimizer(m, cfg.l2_regularization, 1e-3)
                    losses.append(train_step(m, opt, batch)[0].item())

                kernels, _, _ = profile_device(first_step, 1)
                ms, busy, wall = graph_step_ms(trainer, ds)
        finally:
            _build._libs["gru_input_proj"] = change
        k1 = _k1_kernels(e.key for e in kernels)
        out[side].append({"ms": ms, "idle": _idle(busy, wall), "first_loss": losses[0],
                          "k1_kernels": k1})
        print(f"turns, f32 UMPR-R train step at E = {dim}, graph of {DISPATCH_K} ({side}'s K1): "
              f"{ms:.4f} ms a step, idle {_idle(busy, wall)}; first step's loss "
              f"{losses[0]!r} (calls {len(losses)}), K1 kernels {k1}", flush=True)
    xt = {side: [any("gru_input_proj_xt" in k for k in r["k1_kernels"]) for r in out[side]]
          for side in out}
    if not (all(xt["change"]) and not any(xt["parent"])
            and all(r["k1_kernels"] for rs in out.values() for r in rs)):
        raise AssertionError(f"the train step did not run the side's K1 in every turn: {xt}")
    first = [r["first_loss"] for rs in out.values() for r in rs]
    if not (all(np.isfinite(first))
            and max(first) - min(first) <= E2E_TOL * max(1.0, abs(first[0]))):
        raise AssertionError(f"the first step's loss differs between the sides: {first}")
    return out


def turns_phase(device, parent):
    """The tree at `parent` (a checkout's root, e.g. a git archive of the
    parent commit under build/) against this one, on the same inputs, in
    turns (parent, change, change, parent; device ms under torch.profiler):
    bf16 K1 at (51,200, E, 384) for each E of BF16_WIDTHS and E = 50, bf16
    K9 at the UMPR-R shape and K9_BF16_AT, f32 K1 at K1_F32_TURN_WIDTHS
    (with the kernels this tree's K1 ran: its route), each beside its
    library call (bf16 or f32 torch.addmm / torch.mm, TF32 off) and its
    bound, and f32 K1's values past 1e-5 of the f64 product (each side's
    and cuBLAS's: _past_f64); f32 UMPR-R's train step at E = TURNS_DIM
    with either K1 (step_turns); then f32 K4 and K9 of this tree alone at
    K49_F32_WIDTHS
    (k49_f32_widths).  The parent's sources are built here (one nvcc
    each, at once) into build/chip_smoke/parent/.  Returns {"K1": {E:
    ...}, "K9": {shape: ...}, "K1_f32": {E: ...}, "umpr_r_step": ...,
    "K4_K9_f32": ...}."""
    P, I = ctypes.c_void_p, ctypes.c_int
    kernels = (("gru_input_proj", ("gru_input_proj_bf16", "gru_input_proj"),
                [P] * 4 + [I] * 3 + [P]),
               ("gru_input_proj_dx", ("gru_input_proj_dx_bf16",), [P] * 3 + [I] * 3 + [P]))
    root = WORK / "parent"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(root / f"lib{name}.so"),
         str(Path(parent) / "umpr_tpu_torch" / "csrc" / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, _, _ in kernels}
    fns, libs = {}, {}
    for name, symbols, argtypes in kernels:
        out, _ = procs[name].communicate()
        if procs[name].returncode != 0:
            raise AssertionError(f"the parent's {name} did not build:\n{out}")
        libs[name] = ctypes.CDLL(str(root / f"lib{name}.so"))
        for symbol in symbols:
            parent_fn = getattr(libs[name], symbol)
            parent_fn.argtypes, parent_fn.restype = argtypes, ctypes.c_int
            fns[symbol] = (parent_fn, _build.kernel_function(name, argtypes, symbol)[0])
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16

    def in_turns(pair, args):
        calls = []
        for fn in pair:
            def call(fn=fn):
                if fn(*args, stream):
                    raise AssertionError("a launch failed")
            calls.append(call)
        p1, c1, c2, p2 = (device_ms(calls[i]) for i in (0, 1, 1, 0))
        return {"parent_device_ms": [p1, p2], "device_ms": [c1, c2],
                "kernels": sorted(device_split(calls[1], steps=3))}

    def print_turns(what, r, lib):
        print(f"turns, {what}: parent {_ms(r['parent_device_ms'][0])}, change "
              f"{_ms(r['device_ms'][0])}, change {_ms(r['device_ms'][1])}, parent "
              f"{_ms(r['parent_device_ms'][1])}; {lib} {_ms(r['lib_device_ms'])}, bound "
              f"{r['bound_ms']:.4f}; change's kernels {r['kernels']}", flush=True)

    out = {"K1": {}, "K9": {}, "K1_f32": {}}
    M, G = 51200, 384
    for dtype, widths, key in ((bf, (50,) + BF16_WIDTHS, "K1"),
                               (torch.float32, K1_F32_TURN_WIDTHS, "K1_f32")):
        for e in widths:
            g = torch.Generator(device=device).manual_seed(e)
            x = torch.randn(M, e, generator=g, device=device).to(dtype)
            w = (torch.randn(e, G, generator=g, device=device) * (50 / e) ** 0.5).to(dtype)
            b = torch.randn(G, generator=g, device=device).to(dtype)
            xg = torch.empty(M, G, device=device, dtype=dtype)
            symbol = "gru_input_proj_bf16" if dtype == bf else "gru_input_proj"
            args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), xg.data_ptr(), M, e, G)
            r = out[key][e] = in_turns(fns[symbol], args)
            r["lib_device_ms"] = device_ms(lambda: torch.addmm(b, x, w))
            r["bound_ms"] = k1_bound(M, e, G, x.element_size())[0]
            print_turns(f"K1 {'bf16' if dtype == bf else 'f32'} at E = {e}", r, "torch.addmm")
            if dtype == torch.float32:  # each side's and cuBLAS's distance from the f64 product
                exact = gru_cuda.gru_input_proj_ref(x.double(), w.double(), b.double())
                past = {"plain_f32": _past_f64(torch.addmm(b, x, w), exact)}
                for side, fn in zip(("parent", "change"), fns[symbol]):
                    fn(*args, stream)
                    past[side] = _past_f64(xg, exact)
                r["past_1e-5_f64"] = past
                print(f"turns, K1 f32 at E = {e}, values past 1e-5 of f64 (count, largest "
                      f"share): {past}", flush=True)
                del exact
            del x, xg
    for M9, G9, E9 in ((51200, 384, 50),) + K9_BF16_AT:
        g = torch.Generator(device=device).manual_seed(M9 + G9 + E9)
        dxg = torch.randn(M9, G9, generator=g, device=device).to(bf)
        w = (torch.randn(E9, G9, generator=g, device=device) / G9 ** 0.5).to(bf)
        dx = torch.empty(M9, E9, device=device, dtype=bf)
        r = out["K9"][f"{M9}x{G9}x{E9}"] = in_turns(
            fns["gru_input_proj_dx_bf16"],
            (dxg.data_ptr(), w.data_ptr(), dx.data_ptr(), M9, G9, E9))
        r["lib_device_ms"] = device_ms(lambda: torch.mm(dxg, w.t()))
        r["bound_ms"] = k9_bound(M9, G9, E9)[0]
        print_turns(f"K9 bf16 at (M, 6H, E) = {(M9, G9, E9)}", r, "torch.mm")
        del dxg, dx
    torch.cuda.empty_cache()
    out["umpr_r_step"] = step_turns(device, libs["gru_input_proj"])
    out["K4_K9_f32"] = k49_f32_widths(device)
    return out


def _bf16_train(device_name, work, flags, corpus=None):
    """bf16 training through ``umpr_tpu_torch.main.main`` (one epoch, the
    initial validation and the test pass) on a fresh corpus: (trainer,
    launches, glove path).  No plain version may run on the card, every
    launch of K1-K6 and K9 must be its bf16 variant and every logged value
    finite."""
    root = WORK / work
    shutil.rmtree(root, ignore_errors=True)
    glove = write_splits(root, seed=1, shards=5, **(corpus or {}))
    argv = ["--data_dir", str(root), "--word2vec_file", str(glove), "--train_epochs", "1",
            "--learning_rate", "1e-3", "--eval_every", "1000", "--compute_dtype", "bfloat16",
            "--model_path", str(root / "model"), "--log_path", str(root / "train.log"),
            "--metrics_jsonl", str(root / "metrics.jsonl"), *STREAMING, *flags]
    with main_path_counts() as (launches, plain_calls):
        trainer = train_main.main(argv)
        # K7/K8 have no bf16 variant: the bf16 route widens their inputs
        bf16_counts = {k.__name__: k.launches_bf16 for m in (gru_cuda, pool_cuda)
                       for k in m.KERNELS}
    events = [json.loads(line) for line in open(root / "metrics.jsonl")]
    values = [v for e in events for k, v in e.items()
              if k in ("train_loss", "valid_mse", "test_mse")]
    print(f"bf16 training {work} on {device_name}: {trainer.batch_counter} steps, "
          f"launches {launches}, bf16 {bf16_counts}; logged "
          f"{[{k: v for k, v in e.items() if k != 'ts'} for e in events]}")
    if plain_calls[0] or not values or not all(np.isfinite(v) for v in values):
        raise AssertionError(f"{work}: a plain version ran on the card or a value was "
                             "not finite")
    if bf16_counts != {k: launches[k] for k in bf16_counts}:
        raise AssertionError(f"{work}: not every launch was a bf16 variant")
    return trainer, launches, glove


def _twin(model, **dims):
    """A copy of `model` (its weights, on its device) with ModelDims fields
    replaced by `dims` (compute_dtype, vgg_fused_pool)."""
    twin = UMPR(dataclasses.replace(model.dims, **dims),
                np.zeros(tuple(model.embedding.weight.shape), np.float32))
    twin.load_state_dict(model.state_dict())
    return twin.to(model.embedding.weight.device)


def _twins(trainer, dtypes, **dims):
    """_twin's of `trainer`'s model under each compute dtype, and Adam at
    lr 1e-6 for each."""
    models = {name: _twin(trainer.model, compute_dtype=name, **dims) for name in dtypes}
    return models, {name: make_optimizer(m, trainer.config.l2_regularization, 1e-6)
                    for name, m in models.items()}


def bf16_paths_phase(device_name):
    """--compute_dtype bfloat16 on the paths of bf16 K5/K6, the widened
    long-history route and the bf16 scan, each path trained
    through ``umpr_tpu_torch.main.main`` (one epoch) with the launch
    counts zeroed before it and read after it:
    - full UMPR at 224 px with --vgg_fused_pool True: K5/K6 in bf16 only;
      then on its weights, fused against the composite pool in turns
      (train step, forward, peak memory);
    - long-history UMPR-R (P = 8192): every K7/K8 launch on f32-widened
      inputs; train step and forward against f32 in turns;
    - --gru_size 100 (the bf16 scan): no K1-K4 launch; step ms at k = 1
      and as a graph of 4 against f32's, and predictions within 0.08 of
      f32's (the JAX package's bf16 bound).
    Returns ({path: launches}, numbers)."""
    use_seeded_photos()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the Trainer sets it
    launches, out = {}, {}

    trainer, launches["full_umpr_fused"], glove = _bf16_train(
        device_name, "bf16_full", ("--review_net_only", "False", "--vgg_fused_pool", "True",
                                   "--seed", "2", "--data_workers", "4"))
    if not all(launches["full_umpr_fused"][k] for k in ("bias_relu_pool",
                                                         "bias_relu_pool_bwd")):
        raise AssertionError("bf16 full UMPR with the fused pool launched no K5/K6")
    cfg = trainer.config
    ds = build_dataset(str(WORK / "bf16_full" / "train.csv"),
                       str(WORK / "bf16_full" / "photos.json"),
                       str(WORK / "bf16_full" / "photos"), Word2vec(str(glove)), cfg)
    batch = to_device(next(iter(BatchLoader(ds, cfg.batch_size))), trainer.device)
    gp = torch.Generator(device=trainer.device).manual_seed(7)
    px = cfg.photo_size
    batch["photos"] = torch.randint(0, 256, (cfg.batch_size, 1, 1, px, px, 3), generator=gp,
                                    device=trainer.device, dtype=torch.uint8)
    models, opts = {}, {}
    for fused in (True, False):
        m, o = _twins(trainer, ("bfloat16",), vgg_fused_pool=fused)
        models[fused], opts[fused] = m["bfloat16"], o["bfloat16"]
    del trainer
    pool_cuda.reset_launches()
    train_step(models[True], opts[True], batch)
    step_counts = {k.__name__: (k.launches, k.launches_bf16) for k in pool_cuda.KERNELS}
    res = {"launches_per_step": step_counts}
    res["train_step"] = _turns({f"fused_{f}": (lambda f=f: train_step(models[f], opts[f], batch))
                                for f in (True, False)}, 3)
    for f in (True, False):
        _, peak, _ = _peak(lambda f=f: train_step(models[f], opts[f], batch))
        res["train_step"][f"fused_{f}"]["peak_bytes"] = peak
    with torch.inference_mode():
        for m in models.values():
            m.eval()
        preds = {f: m(batch)[0].float() for f, m in models.items()}
        res["forward"] = _turns({f"fused_{f}": (lambda f=f: _predict_forward(models[f], batch))
                                 for f in (True, False)}, 3)
    res["pred_gap_fused_vs_composite"] = (preds[True] - preds[False]).abs().max().item()
    print(f"full UMPR bf16 at {px} px on {device_name}, --vgg_fused_pool True against False "
          f"(CUDA events, in turns, cudnn.deterministic): {res}")
    fused = sum(1 for h in (px >> k for k in range(5)) if h >= FUSED_POOL_MIN_H and h % 2 == 0)
    if step_counts != dict.fromkeys(("bias_relu_pool", "bias_relu_pool_bwd"), (fused, fused)):
        raise AssertionError(f"a bf16 fused train step launched {step_counts}")
    out["full_umpr_fused"] = res
    del models, opts, batch
    torch.cuda.empty_cache()

    # the kernel path's node sees bf16 inputs; K7/K8's wrappers take f32
    # only, so each of their launches ran on the node's widened copies
    node_inputs = []
    apply = attention.AffinityAttention.apply
    attention.AffinityAttention.apply = staticmethod(
        lambda *a: node_inputs.append(a[0].dtype) or apply(*a))
    try:
        trainer, launches["long_history"], glove = _bf16_train(
            device_name, "bf16_long", ("--review_net_only", "True") + LONG_FLAGS, LONG_CORPUS)
    finally:
        del attention.AffinityAttention.apply  # the inherited one again
    if not node_inputs or set(node_inputs) != {torch.bfloat16} or not (
            len(node_inputs) == launches["long_history"]["affinity_tiles"]
            == launches["long_history"]["affinity_finish"]):
        raise AssertionError(f"long-history bf16: {len(node_inputs)} kernel-path calls on "
                             f"{set(node_inputs)}, launches {launches['long_history']}")
    cfg = trainer.config
    ds = build_dataset(str(WORK / "bf16_long" / "train.csv"),
                       str(WORK / "bf16_long" / "photos.json"),
                       str(WORK / "bf16_long" / "photos"), Word2vec(str(glove)), cfg)
    batch = to_device(next(iter(BatchLoader(ds, cfg.batch_size))), trainer.device)
    models, opts = _twins(trainer, ("float32", "bfloat16"))
    del trainer
    res = {"bf16_calls_widened_for_k7_k8": len(node_inputs)}
    res["train_step"] = _turns({n: (lambda n=n: train_step(models[n], opts[n], batch))
                                for n in models}, 3)
    with torch.inference_mode():
        for m in models.values():
            m.eval()
        preds = {n: _predict_forward(m, batch).float() for n, m in models.items()}
        res["forward"] = _turns({n: (lambda n=n: _predict_forward(models[n], batch))
                                 for n in models}, 3)
    res["pred_gap"] = (preds["bfloat16"] - preds["float32"]).abs().max().item()
    print(f"long-history UMPR-R bf16 on {device_name} against f32 (CUDA events, in "
          f"turns): {res}")
    if not res["pred_gap"] <= 0.08:
        raise AssertionError("long-history bf16 predictions left the JAX bf16 bound")
    out["long_history"] = res
    del models, opts, batch
    torch.cuda.empty_cache()

    trainer, launches["gru_size_100"], glove = _bf16_train(
        device_name, "bf16_gru100", ("--review_net_only", "True", "--gru_size", "100",
                                     "--seed", "5"))
    if any(launches["gru_size_100"][k.__name__] for k in gru_cuda.KERNELS):
        raise AssertionError(f"bf16 --gru_size 100 launched {launches['gru_size_100']}")
    cfg = trainer.config
    ds = build_dataset(str(WORK / "bf16_gru100" / "train.csv"),
                       str(WORK / "bf16_gru100" / "photos.json"),
                       str(WORK / "bf16_gru100" / "photos"), Word2vec(str(glove)), cfg)
    batch = to_device(next(iter(BatchLoader(ds, cfg.batch_size))), trainer.device)
    models, opts = _twins(trainer, ("float32", "bfloat16"))
    res = {"train_step_k1": _turns({n: (lambda n=n: train_step(models[n], opts[n], batch))
                                    for n in models}, 5)}
    res[f"train_step_k{DISPATCH_K}"] = {}
    for n in ("float32", "bfloat16", "bfloat16", "float32"):
        twin = SimpleNamespace(model=models[n], opt=opts[n], config=cfg, device=trainer.device)
        ms, busy, wall = graph_step_ms(twin, ds)
        res[f"train_step_k{DISPATCH_K}"].setdefault(n, []).append(
            {"ms": ms, "idle": _idle(busy, wall)})
    with torch.inference_mode():
        for m in models.values():
            m.eval()
        preds = {n: _predict_forward(m, batch).float() for n, m in models.items()}
    res["pred_gap"] = (preds["bfloat16"] - preds["float32"]).abs().max().item()
    print(f"--gru_size 100 bf16 (the scan) on {device_name} against f32 (K1/K2, CUDA "
          f"events, in turns): {res}")
    if not res["pred_gap"] <= 0.08:
        raise AssertionError("--gru_size 100 bf16 predictions left the JAX bf16 bound")
    out["gru_size_100"] = res
    torch.backends.cudnn.deterministic = deterministic
    return launches, out


EXPORT_TOL = {"float32": E2E_TOL, "bfloat16": 0.08}  # against the f32 Predictor


def export_phase(device_name):
    """ROADMAP A6: ``python -m umpr_tpu_torch.export`` (its main) on the
    card for UMPR-R and full UMPR (224 px), f32 and bf16, from a seeded
    best/; each artifact loaded with load_predict and scoring a loader
    batch (full UMPR: seeded photos) against the f32 Predictor's model on
    the kernel path (runtime maxima, as the artifact takes them): within
    E2E_TOL in f32 and 0.08 in bf16.  Then UMPR-R exported on the CPU,
    moved to the card by load_predict, against the card's export within
    1e-5; each artifact's forward ms beside the Predictor's model in the
    artifact's dtype (the kernel path), in turns."""
    from umpr_tpu_torch import export
    use_seeded_photos()
    work = WORK / "export"
    if work.exists():
        shutil.rmtree(work)
    glove, csv, _ = write_corpus(work, seed=0)
    w2v = Word2vec(str(glove))
    out = {}
    for kind, flags in (("umpr_r", ("--review_net_only", "True")),
                        ("full_umpr", ("--review_net_only", "False", "--seed", "2"))):
        argv = [*flags, "--data_dir", str(work), "--word2vec_file", str(glove),
                "--model_path", str(work / kind)]
        cfg = Config(argv)
        base = UMPR(ModelDims.from_config(cfg), w2v.embedding,
                    torch.Generator().manual_seed(cfg.seed))
        with torch.no_grad():
            base.linear_fusion.bias.fill_(3.0)  # above the ReLU: the predictions compare
        ckpt.save_best(str(work / kind), base)
        predictor = serve.Predictor(cfg, w2v, str(work / kind))
        ds = build_dataset(str(csv), str(work / "photos.json"), str(work / "photos"), w2v, cfg)
        batch = to_device(next(iter(BatchLoader(ds, cfg.batch_size))), predictor.device)
        if not cfg.review_net_only:
            g = torch.Generator(device=predictor.device).manual_seed(3)
            px = cfg.photo_size
            batch["photos"] = torch.randint(0, 256, (cfg.batch_size, 1, 1, px, px, 3),
                                            generator=g, device=predictor.device,
                                            dtype=torch.uint8)
        with torch.inference_mode():
            want = predictor.model(batch)[0]
        res = {}
        for dt in ("float32", "bfloat16"):
            # the artifact is timed beside the Predictor's model in its own dtype
            model = predictor.model
            if dt != "float32":
                model = _twin(model, compute_dtype=dt).eval()
            path = str(work / f"{kind}_{dt}.pt2")
            t0 = time.perf_counter()
            export.main(argv + ["--compute_dtype", dt, "--output", path])
            export_s = time.perf_counter() - t0
            meta = json.load(open(path + ".json"))
            predict, params = export.load_predict(path)
            inputs = {k: batch[k] for k in meta["input_keys"]}
            got = predict(params, inputs)
            gap = (got - want).abs().max().item()
            with torch.inference_mode():
                ms = _turns({"artifact": lambda: predict(params, inputs),
                             "predictor_model": lambda: model(batch)}, 2)
            res[dt] = {"gap": gap, "export_s": export_s, "device": meta["device"],
                       "artifact_bytes": Path(path).stat().st_size, **ms}
            print(f"export {kind} {dt} on {device_name}: exported in {export_s:.1f} s "
                  f"(host clock), {res[dt]['artifact_bytes']} bytes; max |artifact - "
                  f"Predictor f32| {gap:.3e} (tolerance {EXPORT_TOL[dt]}); forward ms "
                  f"artifact {ms['artifact']['ms']:.3f}, the Predictor's model in {dt} "
                  f"{ms['predictor_model']['ms']:.3f} (CUDA events, in turns)")
            if not (meta["device"] == str(predictor.device) and gap <= EXPORT_TOL[dt]):
                raise AssertionError(f"the {kind} {dt} artifact disagrees with the Predictor")
            if kind == "umpr_r" and dt == "float32":
                card = (predict, params, inputs, got)
        out[kind] = res
        del predictor, base, model
        torch.cuda.empty_cache()
    predict, params, inputs, got = card
    path = str(work / "umpr_r_cpu.pt2")
    export.main(["--review_net_only", "True", "--data_dir", str(work), "--word2vec_file",
                 str(glove), "--model_path", str(work / "umpr_r"), "--device", "cpu",
                 "--output", path])
    moved, moved_params = export.load_predict(path, got.device)
    gap = (moved(moved_params, inputs) - got).abs().max().item()
    print(f"export: UMPR-R traced on the CPU, moved to the card: max |moved - card's own "
          f"export| {gap:.3e} (tolerance 1e-5)")
    if not gap <= 1e-5:
        raise AssertionError("the CPU artifact moved to the card disagrees with the card's")
    out["cpu_artifact_on_card_gap"] = gap
    del predict, params, inputs, got, card, moved, moved_params
    torch.cuda.empty_cache()
    out["long_history"] = export_long_history(device_name, work / "long")
    return out


CUSTOM_OPS = ["umpr_tpu_torch::affinity_finish", "umpr_tpu_torch::affinity_tiles"]


# (dtype, batch size) of the long-history artifacts: bf16 at B = 32 (still
# above the threshold), since the f32 part alone adds over 60 s to the phase
LONG_EXPORTS = (("float32", 64), ("bfloat16", 32))


def export_long_history(device_name, work, exports=LONG_EXPORTS):
    """ROADMAP A6's remainder: long-history UMPR-R (LONG_FLAGS, P = 8192)
    through ``python -m umpr_tpu_torch.export`` on the card, at each of
    `exports`' dtype and batch size, its graph holding K7/K8's custom ops.
    Each artifact's forward of a loader batch against the f32 Predictor's
    model on the kernel path (EXPORT_TOL), with K7 and K8 launched once each by it and
    no other kernel and no plain version on the card; the artifact timed
    against the Predictor's model in the artifact's dtype, in turns, and
    the f32 artifact's device time by kernel (the bi-GRU scan's share).
    The attention alone through the custom ops against AffinityAttention
    (the ctypes wrappers), in turns, the same bits.  Then the f32 artifact
    traced on the CPU (no forward there), moved to the card by
    load_predict, against the card's export within 1e-5."""
    from umpr_tpu_torch import export
    glove, csv, _ = write_corpus(work, seed=0, **LONG_CORPUS)
    w2v = Word2vec(str(glove))
    argv = ["--review_net_only", "True", *LONG_FLAGS, "--data_dir", str(work),
            "--word2vec_file", str(glove), "--model_path", str(work / "umpr_r")]
    cfg = Config(argv)
    if not kernel_attention(cfg):
        raise AssertionError("the long-history config does not take the kernel route")
    base = UMPR(ModelDims.from_config(cfg), w2v.embedding,
                torch.Generator().manual_seed(cfg.seed))
    with torch.no_grad():
        base.linear_fusion.bias.fill_(3.0)  # above the ReLU: the predictions compare
    ckpt.save_best(str(work / "umpr_r"), base)
    del base
    predictor = serve.Predictor(cfg, w2v, str(work / "umpr_r"))
    ds = build_dataset(str(csv), str(work / "photos.json"), str(work / "photos"), w2v, cfg)
    out = {}
    for dt, B in exports:
        P = cfg.max_sent_count * cfg.max_sent_length
        if not B * P * P * 4 > attention.TILED_BYTES_THRESHOLD:
            raise AssertionError(f"B = {B} does not take the kernel route")
        batch = to_device(next(iter(BatchLoader(ds, B))), predictor.device)
        with torch.inference_mode():
            want = predictor.model(batch)[0]
        model = predictor.model
        if dt != "float32":
            model = _twin(model, compute_dtype=dt).eval()
        path = str(work / f"long_{dt}.pt2")
        t0 = time.perf_counter()
        export.main(argv + ["--compute_dtype", dt, "--batch_size", str(B), "--output", path])
        export_s = time.perf_counter() - t0
        meta = json.load(open(path + ".json"))
        predict, params = export.load_predict(path)
        inputs = {k: batch[k] for k in meta["input_keys"]}
        with main_path_counts() as (launches, plain_calls):
            got = predict(params, inputs)
            torch.cuda.synchronize()
        gap = (got - want).abs().max().item()
        with torch.inference_mode():
            ms = _turns({"artifact": lambda: predict(params, inputs),
                         "predictor_model": lambda: model(batch)}, 2)
        res = {"batch_size": B, "gap": gap, "export_s": export_s,
               "custom_ops": meta["custom_ops"],
               "launches": {k: v for k, v in launches.items() if v},
               "plain_calls_on_card": plain_calls[0], **ms}
        print(f"export long-history UMPR-R {dt} at B = {B} on {device_name}: exported in "
              f"{export_s:.1f} s (host clock), custom ops {meta['custom_ops']}; one forward "
              f"launched {res['launches']}, plain versions on the card "
              f"{plain_calls[0]}; max |artifact - Predictor f32| {gap:.3e} (tolerance "
              f"{EXPORT_TOL[dt]}); forward ms artifact {ms['artifact']['ms']:.3f}, the "
              f"Predictor's model in {dt} {ms['predictor_model']['ms']:.3f} (CUDA events, "
              "in turns)")
        if not (meta["custom_ops"] == CUSTOM_OPS and gap <= EXPORT_TOL[dt]
                and res["launches"] == {"affinity_tiles": 1, "affinity_finish": 1}
                and plain_calls[0] == 0):
            raise AssertionError(f"the long-history {dt} artifact: {res}")
        if dt == "float32":
            split = device_split(lambda: predict(params, inputs), steps=3)
            k7k8 = sum(t for k, t in split.items()
                       if re.search(r"\baffinity_(tiles|finish)\w*\s*[(<]", k))
            total = sum(split.values())
            res["device_ms"] = total or None
            res["device_ms_k7_k8"] = k7k8 if split else None
            print(f"  the f32 artifact's forward by kernel (torch.profiler): "
                  + (f"{total:.3f} ms on the device, K7 + K8 {k7k8:.3f}, the rest (the "
                     f"bi-GRU scan, embedding, S-Net, head) {total - k7k8:.3f}"
                     if split else "not measured"))
            card = (predict, params, inputs, got)
        out[dt] = res
        del model, batch
    # the attention alone: the custom ops against the ctypes wrappers
    g = torch.Generator(device=predictor.device).manual_seed(4)
    B, P, D = ATT_SHAPE
    U, I = (torch.randn(B, P, D, generator=g, device=predictor.device) for _ in range(2))
    M = torch.randn(D, D, generator=g, device=predictor.device) * 0.005
    exists = torch.rand(P, generator=g, device=predictor.device) < 0.9
    with torch.inference_mode():
        a = attention.affinity_attention_ops(U, I, M, exists)
        b = attention.AffinityAttention.apply(U, I, M, exists)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        route = _turns({"custom_ops": lambda: attention.affinity_attention_ops(U, I, M, exists),
                        "ctypes_wrappers": lambda: attention.AffinityAttention.apply(
                            U, I, M, exists)}, 3)
    out["attention_route"] = {"same_bits": same, **route}
    print(f"  attention forward at {ATT_SHAPE}: custom ops {route['custom_ops']['ms']:.3f} ms, "
          f"ctypes wrappers (AffinityAttention) {route['ctypes_wrappers']['ms']:.3f} ms (CUDA "
          f"events, in turns); the same bits: {same}")
    if not same:
        raise AssertionError("the custom-op attention route differs from AffinityAttention")
    del U, I, M, a, b
    predict, params, inputs, got = card
    path = str(work / "long_cpu.pt2")
    t0 = time.perf_counter()
    export.main(argv + ["--device", "cpu", "--output", path])
    cpu_s = time.perf_counter() - t0
    moved, moved_params = export.load_predict(path, got.device)
    with main_path_counts() as (launches, plain_calls):
        gap = (moved(moved_params, inputs) - got).abs().max().item()
    print(f"  traced on the CPU in {cpu_s:.1f} s, moved to the card: max |moved - card's "
          f"own export| {gap:.3e} (tolerance 1e-5), launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if not (gap <= 1e-5 and launches["affinity_tiles"] == 1 and plain_calls[0] == 0):
        raise AssertionError("the CPU long-history artifact moved to the card disagrees")
    out["cpu_artifact_on_card_gap"] = gap
    out["launches"] = {k: out["float32"]["launches"].get(k, 0) for k in ATTENTION}
    del predictor, predict, params, moved, moved_params
    torch.cuda.empty_cache()
    return out


def write_raw_amazon(root, base_url, seed=0, users=40, items=16, per_user=8, vocab=2000,
                     dim=50):
    """A seeded raw Amazon dump (python-literal dicts, gzipped; mixed case,
    punctuation and contractions for the cleaning to work on, an empty
    review the preprocessor drops), its metadata (every item but I0 with an
    imUrl on `base_url`, and an item nobody reviewed) and glove.txt.
    Returns (glove, reviews path, meta path)."""
    import gzip
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    vecs = rng.standard_normal((vocab, dim)).astype(np.float32) * 0.4
    with open(root / "glove.txt", "w") as f:
        for w, v in zip(words, vecs):
            f.write(w + " " + " ".join(f"{x:.6f}" for x in v) + "\n")
    seps = [" ", " ", " ", ", ", "! ", " (", ") ", "'s ", " - "]

    def sentence():
        toks = rng.choice(words, size=rng.integers(4, 26))
        return "".join((str(t).upper() if rng.random() < 0.2 else str(t))
                       + str(rng.choice(seps)) for t in toks).strip()

    with gzip.open(root / "reviews.json.gz", "wt", encoding="utf-8") as f:
        for u in range(users):
            for it in rng.choice(items, size=per_user, replace=False):
                text = ". ".join(sentence() for _ in range(rng.integers(2, 8))) + "."
                f.write(repr({"reviewerID": f"U{u}", "asin": f"I{it}", "reviewText": text,
                              "overall": float(rng.integers(1, 6))}) + "\n")
        f.write(repr({"reviewerID": "U0", "asin": "I1", "reviewText": "",
                      "overall": 3.0}) + "\n")
    with open(root / "meta.json", "w") as f:
        for it in range(items + 1):
            item = {"asin": f"I{it}", "title": f"item {it}"}
            if it:
                item["imUrl"] = f"{base_url}/I{it}.jpg"
            f.write(repr(item) + "\n")
    return root / "glove.txt", root / "reviews.json.gz", root / "meta.json"


def seeded_jpeg_bytes(name):
    """JPEG-framed bytes (SOI ... EOI) seeded by `name`: what the
    downloader checks; the card's machine has no decoder (seeded_photo)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return b"\xff\xd8\xff\xe0" + rng.integers(0, 256, 4096, dtype=np.uint8).tobytes() + \
        b"\xff\xd9"


def _cli(module, *args):
    """python -m `module` args in a subprocess from the checkout's root:
    (its stdout, its host-clock seconds), or raise with its output."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", module, *map(str, args)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        raise RuntimeError(f"{module} exited {run.returncode}:\n{run.stdout}\n{run.stderr}")
    return run.stdout, time.perf_counter() - t0


def data_prep_phase(device_name):
    """ROADMAP A9 (layer L0): a seeded raw Amazon dump and its metadata
    through ``python -m umpr_tpu_torch.text.preprocess`` and the manifest's
    photos through ``python -m umpr_tpu_torch.data.download`` from a local
    HTTP server, both as subprocesses (this machine has neither sklearn nor
    nltk); the files they write built by build_dataset, and one batch of
    the train split scored by a full-UMPR Predictor (224 px) on the card:
    K1/K2 launched, no plain version, finite and varied predictions."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    use_seeded_photos()
    work = WORK / "data_prep"
    if work.exists():
        shutil.rmtree(work)
    hits = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            hits.append(self.path)
            body = seeded_jpeg_bytes(self.path)
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    data = work / "data"
    argv = ["--review_net_only", "False", "--data_dir", str(data), "--word2vec_file",
            str(work / "raw" / "glove.txt"), "--model_path", str(work / "full_umpr"),
            "--seed", "2"]
    cfg = Config(argv)
    try:
        glove, raw, meta = write_raw_amazon(work / "raw",
                                            f"http://127.0.0.1:{srv.server_address[1]}")
        w2v = Word2vec(str(glove))
        with ThreadPoolExecutor(1) as pool:  # the preprocessor runs while the model is made
            pre = pool.submit(_cli, "umpr_tpu_torch.text.preprocess", "--data_path", raw,
                              "--meta_path", meta, "--save_dir", data)
            base = UMPR(ModelDims.from_config(cfg), w2v.embedding,
                        torch.Generator().manual_seed(cfg.seed))
            with torch.no_grad():
                base.linear_fusion.bias.fill_(3.0)
            ckpt.save_best(str(work / "full_umpr"), base)
            del base
            pre, pre_s = pre.result()
        down, down_s = _cli("umpr_tpu_torch.data.download", "--photos_json",
                            data / "photos.json")
    finally:
        srv.shutdown()
        srv.server_close()
    manifest = pd.read_json(data / "photos.json", orient="records", lines=True)
    files = {p.stem: p.read_bytes() for p in (data / "photos").glob("*.jpg")}
    saved = [ln for ln in pre.splitlines() if ln.startswith("#### Saved")]
    done = [ln for ln in down.splitlines() if ln.startswith("done:")]
    print(f"data_prep on {device_name}: preprocess {pre_s:.1f} s ({'; '.join(saved)}), "
          f"download {down_s:.1f} s ({done[0] if done else 'no done: line'}), "
          f"{len(hits)} requests")
    want_files = {pid: seeded_jpeg_bytes(f"/{bid}.jpg")
                  for pid, bid in zip(manifest["photo_id"], manifest["business_id"])}
    # every reviewed item but I0 has an imUrl
    if not (len(manifest) >= 14 and set(manifest["business_id"]) <= {f"I{i}" for i in
                                                                     range(1, 16)}
            and files == want_files and len(hits) == len(manifest)
            and done and done[0].startswith(f"done: {len(manifest)} ok, 0 failed")):
        raise AssertionError("the downloader did not fetch the manifest's photos")
    splits = {name: build_dataset(str(data / f"{name}.csv"), str(data / "photos.json"),
                                  str(data / "photos"), w2v, cfg)
              for name in ("train", "valid", "test")}
    sizes = {name: len(ds.ratings) for name, ds in splits.items()}
    paths = [p for p in splits["train"].photo_paths.ravel() if p]
    if not (sizes["train"] >= cfg.batch_size and paths
            and all(Path(p).stem in files for p in paths)):
        raise AssertionError(f"the prepared splits do not build: {sizes}")
    predictor = serve.Predictor(cfg, w2v, str(work / "full_umpr"))
    with main_path_counts() as (launches, plain_calls):
        preds, rows = predictor.predict_dataset(subset(splits["train"], cfg.batch_size))
        torch.cuda.synchronize()
    preds = np.asarray(preds)
    res = {"preprocess_s": pre_s, "download_s": down_s, "split_sizes": sizes,
           "photos": len(files), "pred_std": float(preds.std()),
           "launches": {k: v for k, v in launches.items() if v},
           "plain_calls_on_card": plain_calls[0]}
    print(f"  splits {sizes}; one full-UMPR Predictor batch on the card: {len(preds)} "
          f"predictions, std {res['pred_std']:.4f}, launches {res['launches']}, plain "
          f"versions on the card {plain_calls[0]}")
    if not (len(preds) == cfg.batch_size and np.isfinite(preds).all()
            and res["pred_std"] > MIN_SPREAD and plain_calls[0] == 0
            and all(launches[k] > 0 for k in FORWARD)):
        raise AssertionError(f"the prepared corpus did not serve: {res}")
    del predictor
    torch.cuda.empty_cache()
    return res


PARALLEL_TIMEOUT = 300  # seconds that a world of parallel_phase may take
PARALLEL_STEP_ITERS = 5  # back-to-back train steps timed in each run


def start_procs(cmds, outs, cwds=None, env=None, timeout=PARALLEL_TIMEOUT):
    """One process per command in `cmds`, its output (stdout and stderr)
    to the file in `outs`, never to a pipe: a rank blocked on a full pipe
    would block the others inside a collective.  `cwds`: each process's
    working directory (default this repo).  -> the handle for
    finish_procs, with a deadline `timeout` seconds from now."""
    procs = []
    for i, (cmd, out) in enumerate(zip(cmds, outs)):
        log = open(out, "w")
        procs.append((subprocess.Popen(cmd, cwd=REPO if cwds is None else cwds[i], env=env,
                                       stdout=log, stderr=subprocess.STDOUT), log, Path(out)))
    return procs, time.monotonic() + timeout


def finish_procs(started, check=True):
    """Wait for the processes of start_procs until their deadline; any
    left then is killed.  With `check`, the first process that fails has
    the others killed at once (they would wait in a collective) and the
    tails of every output raise; without it every process may end on its
    own.  -> [(exit code, output tail)]."""
    procs, deadline = started
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p, _, _ in procs]
            if None not in codes or (check and any(codes)):
                break
            time.sleep(0.1)
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    out = [(p.returncode, out.read_text()[-4000:]) for p, _, out in procs]
    if check and any(rc for rc, _ in out):
        raise AssertionError("\n".join(f"--- process {i} of {len(out)} exited {rc}; its "
                                       f"output's tail:\n{tail}"
                                       for i, (rc, tail) in enumerate(out)))
    return out


def grad_rms(opt):
    """Each trainable parameter's RMS gradient over a run as the port's
    Adam saw it (the L2 term included): sqrt(nu / (1 - beta2^t)), the
    denominator of its updates."""
    c2 = 1 - BETA2 ** int(opt.count)
    return {n: np.sqrt(opt.state[p]["exp_avg_sq"].detach().cpu().numpy() / c2)
            for n, p in zip(opt.names, opt.params)}


def param_gaps(got, want, rms, n=3):
    """The `n` leaves of `want` (name -> array) whose elements lie farthest
    from `got`'s, relatively, each with that element's gap, its value and
    its RMS gradient in `rms` (want's run) beside the leaf's median RMS
    gradient; and the count of elements past rtol 1e-5 + atol 1e-7 (the
    elementwise gate of tests/test_parallel.py)."""
    rows, past = [], 0
    for k, v in want.items():
        gap = np.abs(got[k] - v)
        rel = gap / np.maximum(np.abs(v), 1e-30)
        j = int(np.argmax(rel))
        past += int((gap > 1e-5 * np.abs(v) + 1e-7).sum())
        rows.append({"leaf": k, "rel": float(rel.flat[j]), "gap": float(gap.flat[j]),
                     "value": float(v.flat[j]), "grad_rms": float(rms[k].flat[j]),
                     "leaf_median_grad_rms": float(np.median(rms[k]))})
    return sorted(rows, key=lambda r: -r["rel"])[:n], past


def rank_run(out, argv):
    """One rank of parallel_phase (or its whole run in a world of 1):
    ``umpr_tpu_torch.main.main(argv)`` with the launch counts zeroed before
    it and read after it, counting train/step.py's gradient all-reduces
    (eager or inside a CUDA graph's capture) and the checkpoint writes;
    then, with the process group still up, the ms per train step on this
    rank's rows of one global batch (CUDA events, back to back, every rank
    alike; in a world of one also without the all-reduce, in turns).  Writes ``<out>.json`` and, in ``<out>.npz``, the trainable
    parameters (``p/<name>``) and their RMS gradients over the run
    (``g/<name>``)."""
    from umpr_tpu_torch.data.loader import BatchLoader as Loader
    from umpr_tpu_torch.parallel import multihost
    from umpr_tpu_torch.train import step as step_module
    reduces = {"eager": 0, "captured": 0}
    reduce_gradients = step_module.reduce_gradients

    def counted(*args):
        reduces["captured" if torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return reduce_gradients(*args)

    writes, save_items = [], ckpt.save_items
    step_module.reduce_gradients = counted
    ckpt.save_items = lambda path, *a, **k: writes.append(Path(path).name) or save_items(
        path, *a, **k)
    try:
        with main_path_counts() as (launches, plain_calls):
            trainer = train_main.main(argv)
    finally:
        step_module.reduce_gradients, ckpt.save_items = reduce_gradients, save_items
    cfg = trainer.config
    np.savez(out + ".npz", **{f"p/{n}": p.detach().cpu().numpy()
                              for n, p in trainer.model.named_parameters() if p.requires_grad},
             **{f"g/{n}": g for n, g in grad_rms(trainer.opt).items()})
    graph = getattr(getattr(trainer, "multi_train_step", None), "graph", None)
    ds = build_dataset(str(Path(cfg.data_dir) / "train.csv"),
                       str(Path(cfg.data_dir) / "photos.json"),
                       str(Path(cfg.data_dir) / "photos"), Word2vec(cfg.word2vec_file), cfg)
    batch = multihost.put_local(next(iter(Loader(ds, cfg.batch_size))), trainer.device,
                                trainer._rows)
    def timed(mesh):
        step = lambda: train_step(trainer.model, trainer.opt, batch, mesh=mesh)
        if trainer.device.type == "cuda":
            return time_cuda(step, iters=PARALLEL_STEP_ITERS)
        t0 = time.perf_counter()
        for _ in range(PARALLEL_STEP_ITERS):
            step()
        return (time.perf_counter() - t0) / PARALLEL_STEP_ITERS * 1e3

    ms = timed(trainer.mesh)
    # a world of one: the same step without its all-reduce, in turns with
    # it in this process (the all-reduce's own cost, host noise shared)
    turns = None
    if trainer.mesh is not None and multihost.world_size() == 1:
        turns = [timed(m) for m in (None, trainer.mesh, trainer.mesh, None)]
    json.dump({"rank": multihost.rank(), "world": multihost.world_size(),
               "backend": multihost.collective_backend(), "steps": trainer.batch_counter,
               "launches": launches, "plain_calls": plain_calls[0], "reduces": reduces,
               "writes": writes, "graph_replays": None if graph is None else graph.replays,
               "ms_per_step": ms, "ms_turns_without_with_with_without": turns,
               "rows": None if trainer._rows is None else
               [trainer._rows.start, trainer._rows.stop]}, open(out + ".json", "w"))
    multihost.shutdown()


def rank_result(out):
    """rank_run's result at `out`: its JSON, ``params`` and ``grad_rms``."""
    r = json.load(open(out + ".json"))
    with np.load(out + ".npz") as z:
        for key, prefix in (("params", "p/"), ("grad_rms", "g/")):
            r[key] = {k[2:]: z[k] for k in z.files if k.startswith(prefix)}
    return r


def start_ranks(work, n, argv, group=False):
    """`n` processes of ``chip_smoke.py --rank_run`` over `argv` in `work`,
    as one world when `group` (an explicit coordinator: n = 1 forms a
    world of one) or as a run without a process group."""
    work.mkdir(parents=True)
    argv = list(argv) + ["--model_path", str(work / "model"), "--log_path",
                         str(work / "train.log"), "--metrics_jsonl", str(work / "metrics.jsonl")]
    if group:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            argv += ["--coordinator_address", f"127.0.0.1:{sock.getsockname()[1]}",
                     "--num_processes", str(n)]
    cmds = [[sys.executable, str(REPO / "chip_smoke.py"), "--rank_run", str(work / f"rank{i}"),
             "--", *argv, *(["--process_id", str(i)] if group else [])] for i in range(n)]
    return work, start_procs(cmds, [work / f"rank{i}.out" for i in range(n)])


def wait_ranks(started):
    """Each rank's rank_result; a failed rank or the deadline kills every
    rank and raises with the outputs' tails."""
    work, procs = started
    finish_procs(procs)
    return [rank_result(str(work / f"rank{i}")) for i in range(len(procs[0]))]


def _metrics(work):
    return [{k: v for k, v in json.loads(line).items() if k not in ("ts", "elapsed_s")}
            for line in open(work / "metrics.jsonl")]


def parallel_phase(device_name, extra=()):
    """ROADMAP A7 on one card, through ``umpr_tpu_torch.main``
    (``rank_run``) at the reference widths (B = 64, S = L = 20, E = 50, H =
    64, streamed):
    (a) UMPR-R, one epoch (5 steps) with an evaluation every 2, as two
        gloo ranks sharing the card and as a run without a process group
        (in this process, after them):
        the ranks' parameters and logged lines bit-equal, the parameters
        within 1e-5 (l2, per tensor) and the logged values within rtol
        1e-5 of the 1-rank run's (the leaves farthest apart elementwise
        printed beside their RMS gradients); best/ and last/ written by
        rank 0 alone,
        as often as by the 1-rank run; K1-K4 launched in each rank (K3 and
        K4 once a train step) and no plain version;
    (b) a world of one on NCCL (an explicit coordinator, --num_processes
        1) at --steps_per_dispatch 4, 2 epochs: the gradient all-reduce
        captured in the graph of 4 steps and replayed, and the same bits
        (parameters, logged values) as the same run without a process
        group, which calls no all-reduce; the two run in turn, so that
        each one's eager step time is its own on the card.
    Each world is a set of processes writing to files, each wait bounded
    by PARALLEL_TIMEOUT; a failed rank kills the others and the logs'
    tails are printed.  `extra`: flags for every run (a CPU rehearsal passes
    ``("--device", "cpu")``; it then expects gloo and no capture).
    Returns the {"parallel": ...} numbers."""
    work = WORK / "parallel"
    if work.exists():
        shutil.rmtree(work)
    glove = write_splits(work / "data", seed=1, shards=5)
    base = ["--review_net_only", "True", "--data_dir", str(work / "data"),
            "--word2vec_file", str(glove), "--learning_rate", "1e-3", *STREAMING, *extra]
    on_card = "--device" not in extra
    t0 = time.perf_counter()
    a = base + ["--train_epochs", "1", "--eval_every", "2"]
    two = wait_ranks(start_ranks(work / "two_gloo", 2, a, group=True))
    # the 1-rank run here, in this process (no process group): one process
    # start less
    (work / "one").mkdir()
    rank_run(str(work / "one" / "rank0"), a + [
        "--model_path", str(work / "one" / "model"), "--log_path", str(work / "one" / "train.log"),
        "--metrics_jsonl", str(work / "one" / "metrics.jsonl")])
    one = rank_result(str(work / "one" / "rank0"))
    a_s = time.perf_counter() - t0
    logs = [re.findall(r"train loss [0-9.]+|mse [a-z ]*[0-9.]+",
                       (work / "two_gloo" / f"train.p{i}.log").read_text()) for i in range(2)]
    ranks_equal = logs[0] == logs[1] and len(logs[0]) >= 3 and all(
        np.array_equal(two[1]["params"][k], v) for k, v in two[0]["params"].items())
    l2 = {k: float(np.linalg.norm(two[0]["params"][k] - v) / np.linalg.norm(v))
          for k, v in one["params"].items()}
    gaps, past = param_gaps(two[0]["params"], one["params"], one["grad_rms"])
    worst = gaps[0]["rel"]
    got, want = _metrics(work / "two_gloo"), _metrics(work / "one")
    values = [(e[k], f[k]) for e, f in zip(got, want) for k in ("train_loss", "valid_mse",
                                                                 "test_mse") if k in f]
    value_rel = max(abs(x - y) / abs(y) for x, y in values)
    print(f"parallel (a) on {device_name}: UMPR-R, 2 gloo ranks sharing the card against 1 "
          f"rank, {one['steps']} steps, {a_s:.1f} s (host clock, both runs, process starts "
          f"included): ranks bit-equal {ranks_equal}; {len(values)} logged values within "
          f"{value_rel:.3e} (rtol 1e-5); parameters l2 {max(l2.values()):.3e} (1e-5), "
          f"elementwise {worst:.3e} ({past} elements past rtol 1e-5 + atol 1e-7); the "
          f"farthest leaves, each element beside its RMS gradient in the 1-rank run: "
          + "; ".join(f"{g['leaf']} {g['rel']:.3e} (|gap| {g['gap']:.3e} at |value| "
                      f"{abs(g['value']):.3e}, RMS gradient {g['grad_rms']:.3e}, the leaf's "
                      f"median {g['leaf_median_grad_rms']:.3e})" for g in gaps)
          + f"; writes rank 0 {two[0]['writes']}, rank 1 "
          f"{two[1]['writes']}, 1-rank run {one['writes']}; K1-K4 launches rank 0 "
          + str({k: two[0]["launches"][k] for k in FORWARD + GRU_BACKWARD}) + ", rank 1 "
          + str({k: two[1]["launches"][k] for k in FORWARD + GRU_BACKWARD}))
    for r in two:
        counts = r["launches"]
        if not (r["backend"] == "gloo" and r["world"] == 2 and not r["plain_calls"]
                and (not on_card or counts["bigru_backward"] == counts["gru_input_proj_bwd"]
                     == r["steps"] and counts["gru_input_proj"] == counts["bigru_recurrence"]
                     > r["steps"])):
            raise AssertionError(f"rank {r['rank']} did not run K1-K4 on gloo: {r}")
    if not (ranks_equal and [e["event"] for e in got] == [e["event"] for e in want]
            and value_rel <= 1e-5 and max(l2.values()) <= 1e-5 and two[0]["steps"] == one["steps"]
            and two[1]["writes"] == [] and two[0]["writes"] == one["writes"]
            and one["writes"].count("best") >= 1):
        raise AssertionError("2 ranks on one card disagree with 1 rank")

    t0 = time.perf_counter()
    b = base + ["--train_epochs", "2", "--eval_every", "4", "--steps_per_dispatch", "4"]
    # one after the other, so that each times its eager steps alone on the card
    nccl = wait_ranks(start_ranks(work / "world_of_one", 1, b, group=True))[0]
    plain = wait_ranks(start_ranks(work / "no_group", 1, b))[0]
    b_s = time.perf_counter() - t0
    bits = all(np.array_equal(nccl["params"][k], v) for k, v in plain["params"].items())
    same_log = _metrics(work / "world_of_one") == _metrics(work / "no_group")
    turns = nccl["ms_turns_without_with_with_without"]
    print(f"parallel (b) on {device_name}: a world of one on {nccl['backend']} at "
          f"--steps_per_dispatch 4, {nccl['steps']} steps, {b_s:.1f} s (host clock, both runs "
          f"in turn): all-reduces {nccl['reduces']}, graph replays {nccl['graph_replays']}; "
          f"without a group {plain['reduces']}; parameters bit-equal {bits}, logged values "
          f"bit-equal {same_log}; eager steps (k = 1, each run alone on the card) "
          f"{nccl['ms_per_step']:.3f} ms in the world of one, {plain['ms_per_step']:.3f} without "
          f"a group; in the world of one's process, in turns, without / with / with / without "
          f"its all-reduce: " + " / ".join(f"{t:.3f}" for t in turns) + " ms")
    captured = 4 if on_card else 0
    if not (bits and same_log and nccl["backend"] == ("nccl" if on_card else "gloo")
            and nccl["reduces"]["captured"] == captured and nccl["reduces"]["eager"] > 0
            and (not on_card or nccl["graph_replays"] >= 2)
            and plain["reduces"] == {"eager": 0, "captured": 0} and plain["backend"] is None):
        raise AssertionError("the NCCL world of one differs from the run without a group")
    return {"card": device_name,
            "umpr_r_ms_per_step_two_gloo_ranks_sharing_one_card": [r["ms_per_step"] for r in two],
            "umpr_r_ms_per_step_one_rank": one["ms_per_step"],
            "umpr_r_ms_per_step_world_of_one": nccl["ms_per_step"],
            "umpr_r_ms_per_step_no_group": plain["ms_per_step"],
            "world_of_one_ms_in_turns_without_with_with_without_all_reduce": turns,
            "note": "two gloo ranks on one shared card check correctness, not scaling",
            "steps": {"two_gloo": one["steps"], "world_of_one": nccl["steps"]},
            "max_value_rel": value_rel, "max_param_l2_rel": max(l2.values()),
            "max_param_elementwise_rel": worst, "params_past_elementwise_gate": past,
            "farthest_leaves": gaps, "reduces_world_of_one": nccl["reduces"],
            "seconds": {"a": round(a_s, 1), "b": round(b_s, 1)}}


def main():
    if sys.argv[1:2] == ["--rank_run"] and sys.argv[3:4] == ["--"]:  # parallel_phase's ranks
        rank_run(sys.argv[2], sys.argv[4:])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    if sys.argv[1:2] == ["--turns"] and len(sys.argv) == 3:  # K1 and K9 against a parent tree
        serve.set_f32_parity()
        with torch.no_grad():
            print(json.dumps({"turns": turns_phase(torch.device("cuda"), sys.argv[2])}))
        return 0
    if sys.argv[1:] == ["--steps"]:  # K2's, K8's, bf16 K4's, K3's, K2's, K1's, K9's, f32 K1's designs
        _build.build(("affinity_tiles", "bigru_recurrence", "bigru_backward"))
        with torch.no_grad():
            print(json.dumps({"k2_steps": k2_steps_phase(torch.device("cuda")),
                              "k8_steps": k8_steps_phase(torch.device("cuda")),
                              "k4_bf16_steps": k4_steps_phase(torch.device("cuda")),
                              "k3_bf16_steps": k3_steps_phase(torch.device("cuda")),
                              "k2_bf16_steps": k2_bf16_steps_phase(torch.device("cuda")),
                              "k1_bf16_steps": k1_bf16_steps_phase(torch.device("cuda")),
                              "k9_bf16_steps": k9_bf16_steps_phase(torch.device("cuda")),
                              "k1_f32_steps": k1_f32_steps_phase(torch.device("cuda"))}))
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
        PTXAS[name] = ptxas_report(log)
        print_ptxas(name, PTXAS[name])

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
        bf16_kernels = phase("bf16 gru kernels", bf16_kernel_phase, device)
        bf16_kernels += phase("bf16 pool and input-gradient kernels",
                              bf16_pool_dx_kernel_phase, device)
    streaming = phase("streaming build", streaming_build_phase, card)
    served = phase("UMPR-R serving", serve_phase, card)
    trained = phase("UMPR-R training", train_phase, card)
    full = phase("full UMPR training", full_train_phase, card)
    full_served = phase("full UMPR serving", full_serve_phase, card)
    input_grad = phase("bigru_split input gradient", input_grad_phase, card)
    input_grad_bf16 = phase("bigru_split input gradient, bf16", input_grad_phase, card,
                            "cuda", 2560, 20, 50, 64, 20, torch.bfloat16)
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
    # --steps_per_dispatch (CUDA graphs), the Adam modes, the profiler and
    # the R-Net warm start
    dispatch = {
        "adam_step": phase("Adam step", optimizer_phase, card),
        "umpr_r_training": phase("UMPR-R training at k = 1 and 4", dispatch_phase, card),
        "full_umpr_training": phase("full UMPR training at k = 1 and 2", full_dispatch_phase,
                                    card),
        "umpr_r_serving": phase("UMPR-R serving at k = 1 and 4", serve_dispatch_phase, card),
        "adam_bf16_factored": phase("bf16 mu + factored nu Adam", adam_modes_phase, card),
        "rnet_pretrained": phase("--rnet_pretrained", rnet_pretrained_phase, card)}
    # ROADMAP A5's runtime: the resident corpus, the dataset cache,
    # --grad_accum_steps and --remat_vgg
    a5 = phase("a5_runtime", a5_runtime_phase, card)
    # --compute_dtype bfloat16: its main path (UMPR-R training) launches the
    # bf16 variants of K1-K4
    bf16_launches, bf16 = phase("bf16", bf16_phase, card)
    # ROADMAP A5's end (bf16 K5/K6 with the fused pool, the long-history
    # route, the bf16 scan) and A6 (export)
    bf16_path_launches, bf16_paths = phase("bf16 paths", bf16_paths_phase, card)
    exported = phase("export", export_phase, card)
    # ROADMAP A9: the offline preprocessor and the photo downloader feed a
    # full-UMPR Predictor
    prepared = phase("data_prep", data_prep_phase, card)
    # ROADMAP A7: data-parallel ranks through main, on the one card
    parallel = phase("parallel", parallel_phase, card)
    # ROADMAP A8: the pretrainers' CLIs; the R-Net pretraining steps run K1-K4
    pretraining = phase("pretraining", pretraining_phase, card)
    for k in kernels:
        k["launches_umpr_r_training_k4"] = dispatch["umpr_r_training"]["launches_on_card"][
            k["name"]]
        k["launches_full_umpr_training_k2"] = dispatch["full_umpr_training"][
            "launches_on_card"][k["name"]]
        k["launches_umpr_r_serving_k4"] = dispatch["umpr_r_serving"]["launches_on_card"][
            k["name"]]
        k["launches_full_umpr_remat_step"] = a5["remat_launches"][k["name"]]
        if k["name"] in ATTENTION:  # the bf16 route runs them on widened inputs
            k["launches_long_history_bf16_training"] = bf16_path_launches["long_history"][
                k["name"]]
            # one forward of the long-history f32 artifact (its custom ops)
            k["launches_long_history_export"] = exported["long_history"]["launches"][
                k["name"]]
    # each bf16 variant's main path: bf16 UMPR-R training (K1-K4), bf16 full
    # UMPR training with the fused pool (K5/K6), the bf16 input gradient (K9)
    bf16_main = dict(bf16["launches_bf16"],
                     bias_relu_pool=bf16_path_launches["full_umpr_fused"]["bias_relu_pool"],
                     bias_relu_pool_bwd=bf16_path_launches["full_umpr_fused"][
                         "bias_relu_pool_bwd"],
                     gru_input_proj_dx=input_grad_bf16["gru_input_proj_dx"])
    for k in bf16_kernels:
        base = k["name"][:-len("_bf16")]
        k["launches"] = bf16_main[base]
        k["launches_full_umpr_bf16_step"] = bf16["full_umpr"]["launches_bf16_step"].get(base, 0)
        for run, counts in bf16_path_launches.items():
            k[f"launches_bf16_{run}_training"] = counts[base]
    kernels += bf16_kernels
    for k in kernels:
        base = k["name"].removesuffix("_bf16")
        k["launches_rnet_pretraining"] = (pretraining["launches"][k["name"]] if base == k["name"]
                                          else pretraining["launches_bf16"][base])
    print(f"phase seconds: {seconds}")
    print(json.dumps({"resume_bit_equal": resumed}))
    print(json.dumps({"steps_per_dispatch": dispatch}))
    print(json.dumps({"a5_runtime": {k: v for k, v in a5.items() if k != "remat_launches"}}))
    print(json.dumps({"streaming_build": streaming}))
    print(json.dumps({"bf16": {k: v for k, v in bf16.items() if k != "launches_bf16"}}))
    print(json.dumps({"bf16_paths": bf16_paths}))
    print(json.dumps({"export": exported}))
    print(json.dumps({"data_prep": prepared}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"pretraining": {k: v for k, v in pretraining.items()
                                      if k not in ("launches", "launches_bf16")}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
