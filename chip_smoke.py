#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (umpr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Print the card's name and power limit; build every CUDA kernel of the
   port from the sources in the checkout (one nvcc per source, in
   parallel) and print the build time and ptxas report.
2. Hold each kernel against its plain PyTorch version at the UMPR-R shapes
   (N=2560 sentence rows, L=20, E=50, H=64, f32; lengths 1..20) and time
   the kernel, the plain version and one PyTorch library call (yardstick
   only: the port never calls it): K1 and K2 (the bi-GRU forward), K3 and
   K4 (its backward).
3. Serve UMPR-R at the reference widths (B=64, S=L=20, E=50, H=64) from a
   seeded synthetic corpus and a seeded checkpoint: HTTP /predict requests
   through make_http_server, one CSV-mode pass through serve.main, and the
   same rows on the CPU with the plain versions.  Launch counts show the
   requests went through K1 and K2.
4. Train UMPR-R at the same widths through ``umpr_tpu_torch.main.main``
   (2 epochs over a seeded train/valid/test corpus, Adam at lr 1e-3, an
   evaluation every 2 batches, then the test pass).  Launch counts show
   every train step went through K1-K4 and every evaluation batch through
   K1 and K2; the loss is finite and the GRU weights moved; one step's
   gradients and the first validation MSE agree with the CPU (plain
   versions).  Then the ms per train step (CUDA events) and a
   torch.profiler breakdown of train steps.
5. Print a ``{"kernels": [...]}`` line (launches: the training run's),
   then, as the last line, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero without the last line.  Without a
CUDA device the script exits 2.  Work files go to build/chip_smoke/ in
the checkout.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from umpr_tpu_torch import main as train_main
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.data.loader import BatchLoader, to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.ops import _build, gru_cuda
from umpr_tpu_torch.ops.gru import BiGRU
from umpr_tpu_torch import serve
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.step import evaluate_mse, train_step

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FMA (non-tensor
# core) FLOP/s, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

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
MIN_SPREAD = 1e-3  # std of the served predictions: 10x E2E_TOL, so the
                   # card-vs-CPU check sees real, varied outputs
# the seeded checkpoint: with seed 0 the ReLU head's input is positive on
# this corpus, so predictions are not clamped to a constant 0
CKPT_SEED = 0


def write_corpus(root, seed=0, shards=3, users=12, items=12, per_user=8,
                 vocab=2000, dim=50):
    """A seeded synthetic corpus in the training-CSV schema with enough
    history to fill S=L=20: `shards` groups of users and items that never
    meet, so each shard is a self-contained request.  Writes glove.txt
    (`vocab` words, `dim`-d), reviews.csv and photos.json (one item lacks a
    photo, so its rows are unscorable).  Returns (glove path, csv path,
    list of row-index arrays per shard)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    vecs = rng.standard_normal((vocab, dim)).astype(np.float32) * 0.4
    with open(root / "glove.txt", "w") as f:
        for w, v in zip(words, vecs):
            f.write(w + " " + " ".join(f"{x:.6f}" for x in v) + "\n")

    def sentence():
        toks = list(rng.choice(words, size=rng.integers(4, 26)))
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
                review = ". ".join(sentence() for _ in range(rng.integers(2, 8))) + "."
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


def bound(n_bytes, flops):
    """Least time on the card in ms, and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
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
    print(f"K1 gru_input_proj: max|kernel - plain| = {err:.3e} (tolerance {K1_TOL:.0e})")
    if not err <= K1_TOL:
        raise AssertionError("K1 disagrees with its plain version")
    t_bound, by = bound(4 * (x2.numel() + w_ih.numel() + b_ih.numel() + xg.numel()),
                        2 * x2.shape[0] * E * 6 * H)
    rows.append({
        "name": "gru_input_proj", "route": "cuda",
        "source": "umpr_tpu_torch/csrc/gru_input_proj.cu",
        "replaces": "umpr_tpu/ops/gru_pallas.py:319",
        "also_replaces": ["umpr_tpu/ops/gru_pallas.py:541"],
        "max_abs_err": err,
        "ms": time_cuda(lambda: gru_cuda.gru_input_proj(x2, w_ih, b_ih)),
        "plain_ms": time_cuda(lambda: gru_cuda.gru_input_proj_ref(x2, w_ih, b_ih)),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": time_cuda(lambda: torch.addmm(b_ih, x2, w_ih)),
        "library_call": "torch.addmm"})

    xg = xg.view(N, L, 6 * H)
    y = gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (y - gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh)).abs().max().item()
    print(f"K2 bigru_recurrence: max|kernel - plain| = {err:.3e} (tolerance {K2_TOL:.0e})")
    if not err <= K2_TOL:
        raise AssertionError("K2 disagrees with its plain version")
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
    # bytes and operations of the valid steps this run's lengths need, both
    # directions: xg is read only there, y is written in full
    valid = int(lengths.sum())
    t_bound, by = bound(
        4 * (2 * valid * 3 * H + y.numel() + w_hh.numel() + b_hh.numel()
             + lengths.numel()),
        2 * valid * 2 * H * 3 * H)
    rows.append({
        "name": "bigru_recurrence", "route": "cuda",
        "source": "umpr_tpu_torch/csrc/bigru_recurrence.cu",
        "replaces": "umpr_tpu/ops/gru_pallas.py:205",
        "also_replaces": ["umpr_tpu/ops/gru_pallas.py:463"],
        "max_abs_err": err,
        "ms": time_cuda(lambda: gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)),
        "plain_ms": time_cuda(
            lambda: gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh), iters=5),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": time_cuda(library),
        "library_call": "torch.nn.GRU(bidirectional) on pack_padded_sequence"})
    rows += backward_kernel_phase(x, xg, y, lengths, gru, lib)
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"{r['library_call']} {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return rows


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
    print(f"K4 gru_input_proj_bwd: max|kernel - plain| = {err4:.3e}, relative "
          f"{rel4:.3e} (tolerance {SUM_RTOL:.0e})")
    if not rel4 <= SUM_RTOL:
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
        lib_ms = time_cuda(library)

    # this run's lengths: each direction reads xg, h_prev (y) and both
    # cotangents only at valid steps and does three (H x 3H) products there
    valid = int(lengths.sum())
    t_bound, by = bound(
        4 * (2 * valid * (3 * H + H + 2 * H) + dxg.numel() + 2 * w_hh.numel()
             + 2 * b_hh.numel() + lengths.numel()),
        2 * valid * 3 * 2 * H * 3 * H)
    rows.append({
        "name": "bigru_backward", "route": "cuda",
        "source": "umpr_tpu_torch/csrc/bigru_backward.cu",
        "replaces": "umpr_tpu/ops/gru_pallas.py:698",
        "also_replaces": ["umpr_tpu/ops/gru_pallas.py:501"],
        "max_abs_err": err, "max_rel_err_dw_db": rel,
        "ms": time_cuda(lambda: gru_cuda.bigru_backward(
            xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh)),
        "plain_ms": time_cuda(lambda: gru_cuda.bigru_backward_ref(
            xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh), iters=3, warmup=1),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": lib_ms,
        "library_call": "torch.autograd.grad of nn.GRU(bidirectional) on "
                        "pack_padded_sequence w.r.t. its weights (projection "
                        "backward included)"})
    M = N * L
    t_bound, by = bound(4 * (x2.numel() + dxg2.numel() + dw_ih.numel() + db_ih.numel()),
                        2 * M * E * 6 * H + M * 6 * H)
    rows.append({
        "name": "gru_input_proj_bwd", "route": "cuda",
        "source": "umpr_tpu_torch/csrc/gru_input_proj_bwd.cu",
        "replaces": "umpr_tpu/ops/gru_pallas.py:394",
        "max_abs_err": err4, "max_rel_err": rel4,
        "ms": time_cuda(lambda: gru_cuda.gru_input_proj_bwd(x2, dxg2)),
        "plain_ms": time_cuda(lambda: gru_cuda.gru_input_proj_bwd_ref(x2, dxg2)),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": time_cuda(lambda: (x2.t() @ dxg2, dxg2.sum(0))),
        "library_call": "x.T @ dxg and dxg.sum(0)"})
    return rows


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
PLAIN = ("gru_input_proj_ref", "bigru_recurrence_ref", "bigru_backward_ref",
         "gru_input_proj_bwd_ref")


@contextlib.contextmanager
def main_path_counts():
    """Zero every kernel's launch count, count the plain versions' calls on
    CUDA tensors, and on exit fill the yielded dict with the launches made
    inside the block: (launches dict, [plain calls])."""
    launches, plain_calls = {}, [0]
    saved = {name: getattr(gru_cuda, name) for name in PLAIN}
    gru_cuda.reset_launches()
    for name, fn in saved.items():
        setattr(gru_cuda, name, _counting(fn, plain_calls))
    try:
        yield launches, plain_calls
    finally:
        for name, fn in saved.items():
            setattr(gru_cuda, name, fn)
        launches.update({k.__name__: k.launches for k in gru_cuda.KERNELS})


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


def serve_phase(device_name):
    """UMPR-R serving at the reference widths.  Returns the launch counts
    of the main path (HTTP requests + CSV mode)."""
    if WORK.exists():
        shutil.rmtree(WORK)
    glove, csv, shard_rows = write_corpus(WORK, seed=0)
    model_dir = WORK / "model"
    argv = ["--review_net_only", "True", "--data_dir", str(WORK), "--word2vec_file", str(glove),
            "--model_path", str(model_dir)]
    cfg = Config(argv)  # default device: cuda
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
            out_csv = WORK / "predictions.csv"
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
    print(f"HTTP: {len(requests)} /predict requests, {int(scored.sum())} of "
          f"{len(df)} rows scored at B={cfg.batch_size}, S={cfg.max_sent_count}, "
          f"L={cfg.max_sent_length}, in {http_s:.3f} s")
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
    want = dict.fromkeys(launches, 0) | dict.fromkeys(FORWARD, n_batches)
    if launches != want:
        raise AssertionError(f"serving launches {launches}, expected {want}")

    # the same rows on the CPU, plain versions
    cpu = serve.Predictor(Config(argv + ["--device", "cpu"]), w2v, str(model_dir))
    ds = build_dataset(str(csv), str(WORK / "photos.json"),
                             str(WORK / "photos"), w2v, cfg)
    cpu_pred, rows = cpu.predict_dataset(ds)
    err = np.abs(cpu_pred - csv_pred[rows]).max()
    print(f"card vs CPU plain versions: max abs diff {err:.3e} "
          f"(tolerance {E2E_TOL:.0e}) over {len(rows)} samples")
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
    predictor.predict_dataset(ds)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        predictor.predict_dataset(ds)
    wall = (time.perf_counter() - t0) / reps
    n_b = -(-len(ds) // cfg.batch_size)
    batch = to_device(next(iter(BatchLoader(ds, cfg.batch_size))),
                            predictor.device)
    batch["pad_maxima"] = (cfg.max_sent_count, cfg.max_sent_length,
                           cfg.max_ui_sent_count, cfg.max_sent_length)
    with torch.inference_mode():
        fwd_ms = time_cuda(lambda: predictor.model(batch))
    print(f"serving on {device_name}: predict_dataset {wall / n_b * 1e3:.3f} ms "
          f"per B={cfg.batch_size} batch ({len(ds) / wall:.1f} samples/s, host "
          f"clock, {len(ds)} samples); device forward {fwd_ms:.3f} ms per batch "
          f"({cfg.batch_size / fwd_ms * 1e3:.1f} samples/s, CUDA events)")
    with torch.inference_mode():
        device_breakdown(lambda: predictor.model(batch), "forward")
    return launches


def _gru_params(model):
    return {n: p.detach().cpu() for n, p in model.named_parameters()
            if ".gru." in n}


def train_phase(device_name):
    """UMPR-R training at the reference widths through the port's CLI.
    Returns the launch counts of the main path (fit + test)."""
    root = WORK / "train"
    glove = write_splits(root, seed=1, shards=5)
    argv = ["--review_net_only", "True", "--data_dir", str(root),
            "--word2vec_file", str(glove), "--train_epochs", "2",
            "--learning_rate", "1e-3", "--eval_every", "2",
            "--model_path", str(root / "model"), "--log_path", str(root / "train.log"),
            "--metrics_jsonl", str(root / "metrics.jsonl")]
    with main_path_counts() as (launches, plain_calls):
        t0 = time.perf_counter()
        trainer = train_main.main(argv)  # default device: cuda
        main_s = time.perf_counter() - t0
    cfg, B = trainer.config, trainer.config.batch_size
    w2v = Word2vec(str(glove))
    photos = (str(root / "photos.json"), str(root / "photos"))
    ds = {s: build_dataset(str(root / f"{s}.csv"), *photos, w2v, cfg)
          for s in ("train", "valid", "test")}
    events = [json.loads(line) for line in open(root / "metrics.jsonl")]
    evals = [e for e in events if e["event"] == "eval"]
    steps = trainer.batch_counter
    n_batches = {s: -(-len(d) // B) for s, d in ds.items()}
    eval_batches = len(evals) * n_batches["valid"] + n_batches["test"]
    print(f"training: {steps} train steps over {len(ds['train'])} samples "
          f"(B={B}, S={cfg.max_sent_count}, L={cfg.max_sent_length}), "
          f"{len(evals)} validations of {len(ds['valid'])} samples, test on "
          f"{len(ds['test'])}, in {main_s:.1f} s (host clock, datasets built "
          f"inside)")
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
    want = dict.fromkeys(launches, steps) | dict.fromkeys(FORWARD, steps + eval_batches)
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")

    # the GRU moved, and one step's gradients agree with the CPU
    dims = ModelDims.from_config(cfg)
    init = UMPR(dims, w2v.embedding, torch.Generator().manual_seed(cfg.seed))
    before = _gru_params(init)
    moved = {n: (p - before[n]).abs().max().item()
             for n, p in _gru_params(trainer.model).items()}
    print(f"GRU weights moved by (max abs): {min(moved.values()):.3e} .. "
          f"{max(moved.values()):.3e} over {len(moved)} tensors")
    if len(moved) != 8 or not min(moved.values()) > 0:
        raise AssertionError("a GRU weight did not move")
    batch = next(iter(BatchLoader(ds["train"], B)))
    grads = []
    for dev in ("cpu", trainer.device):
        model = UMPR(dims, w2v.embedding, torch.Generator().manual_seed(cfg.seed)).to(dev)
        model(to_device(batch, dev))[1].backward()
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None})
    rel = {n: _rel_err(grads[1][n], g) for n, g in grads[0].items()}
    gru_rel = max(v for n, v in rel.items() if ".gru." in n)
    print(f"one train step, card vs CPU plain versions: GRU gradients max "
          f"relative diff {gru_rel:.3e}, all {len(rel)} parameters "
          f"{max(rel.values()):.3e} (tolerance {GRAD_RTOL:.0e})")
    if len(rel) != len(list(init.parameters())) - 1 or not max(rel.values()) <= GRAD_RTOL:
        raise AssertionError("card and CPU gradients disagree")
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
    step_ms = time_cuda(lambda: train_step(model, opt, dev_batch, 1e-3))
    print(f"training on {device_name}: {step_ms:.3f} ms per B={B} train step "
          f"({B / step_ms * 1e3:.1f} samples/s, CUDA events, back to back); "
          f"fit + test {main_s / steps * 1e3:.1f} ms per train step, "
          f"evaluations and dataset builds included (host clock)")
    device_breakdown(lambda: train_step(model, opt, dev_batch, 1e-3), "train step",
                     steps=5)
    return launches


def device_breakdown(fn, what, steps=10, top=10):
    """Device time by kernel over `steps` calls of fn (torch.profiler), and
    the device's busy share of the host wall time of those calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side kernel events only: the CPU ops that launched them carry
    # the same time again, and a user annotation's device span (the
    # optimizer's "Optimizer.step#...") covers kernels counted already
    events = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                      for e in events
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and not getattr(e, "is_user_annotation", False)
                      and not e.key.startswith("Optimizer.")),
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
    with torch.no_grad():
        kernels = kernel_phase(device)
    served = serve_phase(f"{device_name} ({smi})")
    trained = train_phase(f"{device_name} ({smi})")
    for k in kernels:
        k["launches"] = trained[k["name"]]
        k["launches_serving"] = served[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
