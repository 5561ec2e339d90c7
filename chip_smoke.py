#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (umpr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Print the card's name and power limit; build every CUDA kernel of the
   serving path from the sources in the checkout (one nvcc per source, in
   parallel) and print the build time and ptxas report.
2. Hold each kernel against its plain PyTorch version at the UMPR-R shapes
   (N=2560 sentence rows, L=20, E=50, H=64, f32; lengths 1..20) and time
   the kernel, the plain version and one PyTorch library call (yardstick
   only: the port never calls it).
3. Serve UMPR-R at the reference widths (B=64, S=L=20, E=50, H=64) from a
   seeded synthetic corpus and a seeded checkpoint: HTTP /predict requests
   through make_http_server, one CSV-mode pass through serve.main, and the
   same rows on the CPU with the plain versions.  Launch counts show the
   requests went through the kernels.
4. Print a ``{"kernels": [...]}`` line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero without the last line.  Without a
CUDA device the script exits 2.  Work files go to build/chip_smoke/ in
the checkout.
"""

from __future__ import annotations

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

from umpr_tpu_torch.config import Config
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.data.loader import BatchLoader, to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.ops import _build, gru_cuda
from umpr_tpu_torch.ops.gru import BiGRU
from umpr_tpu_torch import serve
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train import checkpoint as ckpt

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FMA (non-tensor
# core) FLOP/s, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

K1_TOL = 1e-5  # f32 sums of 50 products in another order
K2_TOL = 1e-5  # masked GRU tolerance of PARITY.md, f32 over 20 steps
E2E_TOL = 1e-4  # full forward tolerance of PARITY.md, card vs CPU
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
    """Each kernel against its plain version at the serving path's shapes."""
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
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"{r['library_call']} {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']})")
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
    plain_calls = [0]
    saved = (gru_cuda.gru_input_proj_ref, gru_cuda.bigru_recurrence_ref)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        _post(base, requests[0])  # warm-up, before the counts are zeroed
        gru_cuda.reset_launches()
        gru_cuda.gru_input_proj_ref = _counting(saved[0], plain_calls)
        gru_cuda.bigru_recurrence_ref = _counting(saved[1], plain_calls)
        t0 = time.perf_counter()
        answers = [_post(base, rows) for rows in requests]
        http_s = time.perf_counter() - t0
        repeat = _post(base, requests[0])
        out_csv = WORK / "predictions.csv"
        serve.main(argv + ["--input", str(csv), "--output", str(out_csv)])
        launches = {k.__name__: k.launches for k in gru_cuda.KERNELS}
    finally:
        gru_cuda.gru_input_proj_ref, gru_cuda.bigru_recurrence_ref = saved
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

    print(f"main path launches: {launches}; plain versions called on the "
          f"card: {plain_calls[0]}; batches dispatched: {n_batches}")
    if plain_calls[0]:
        raise AssertionError("a plain version ran on the card")
    for name, n in launches.items():
        if n != n_batches:
            raise AssertionError(f"{name}: {n} launches for {n_batches} batches")

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
    device_breakdown(predictor.model, batch)
    return launches


def device_breakdown(model, batch, steps=10, top=10):
    """Device time by kernel over `steps` forwards (torch.profiler), and the
    device's busy share of the host wall time of those forwards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                model(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side events only: the CPU ops that launched them carry the
    # same time again
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    if not kernels:
        print("device breakdown: torch.profiler recorded no device time "
              f"(not measured); wall {wall_ms:.3f} ms per forward")
        return
    print(f"device breakdown (torch.profiler, {steps} forwards): busy "
          f"{busy:.3f} ms of {wall_ms:.3f} ms wall per forward (idle share "
          f"{1 - busy / wall_ms:.1%}), {len(kernels)} kernels")
    for name, ms in kernels[:top]:
        print(f"  {ms:8.4f} ms  {ms / busy:6.1%}  {name[:90]}")


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
    launches = serve_phase(f"{device_name} ({smi})")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
