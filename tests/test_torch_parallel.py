"""Data-parallel training of the port (umpr_tpu_torch/parallel, ROADMAP A7)
on the CPU: gloo worlds of 2 and 4 ranks, each rank a subprocess
(tests/torch_dist_worker.py) with a timeout, against the port's 1-rank run
(no process group) and the JAX package's 1- and 2-device runs.

Gate (PARITY.md:17-22): N ranks == 1 rank at rtol 1e-5, and the ranks
bit-equal to one another; after a whole fit the parameters are held in l2
(assert_close says why), under bf16 at bf16's tolerances, and full UMPR
with dropout and accumulation by its masks (its test says why).  Every
world runs all of its scenarios in one spawn (a module fixture); each test
reads its own.
"""

import json
import os
import socket
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import finish_procs, start_procs, write_splits
from tests import torch_dist_worker as worker
from tests.ref_oracle import random_batch
from tests.test_parallel import run_steps as jax_run_steps
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_from_jax
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.parallel import mesh as port_mesh
from umpr_tpu_torch.parallel import multihost
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train.optim import BETA1, BETA2, make_optimizer
from umpr_tpu_torch.train.step import eval_step, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # seconds for a whole world, every scenario of it included
RTOL, ATOL = 1e-5, 1e-7  # tests/test_parallel.py's, N devices against 1
# bf16 2 ranks against 1: test_torch_bf16.py's loss tolerance for the
# logged values, one bf16 rounding (2^-8) in l2 for each parameter tensor
BF16_RTOL, BF16_L2 = 1e-2, 2.0 ** -8
LR = 1e-3  # every scenario's learning rate
GRAD_ROUNDING = 1e-6  # an RMS gradient below it is f32 rounding residue here
B, S, L, S_UI = 16, 5, 12, 2  # tests/test_parallel.py's batches

SHAPE = ["--batch_size", "8", "--max_sent_count", "6", "--max_sent_length", "10",
         "--max_ui_sent_count", "2", "--min_sent_count", "3", "--gru_size", "64",
         "--self_atte_size", "16", "--device", "cpu", "--learning_rate", str(LR),
         "--seed", "4", "--async_checkpoint", "False"]
UMPR_R = ["--review_net_only", "True", "--train_epochs", "1", "--eval_every", "2"]
FULL = ["--review_net_only", "False", "--photo_size", "32", "--kernel_count", "8",
        "--train_epochs", "1", "--eval_every", "2", "--seed", "1",
        "--device_dataset", "off"]


def _address():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def start_world(root, world, scenarios):
    """Start `scenarios` in a gloo world of `world` ranks, one subprocess
    each, their output to files."""
    root.mkdir(parents=True, exist_ok=True)
    spec = root / "spec.json"
    spec.write_text(json.dumps({"address": _address(), "world": world, "out": str(root),
                                "threads": 1, "scenarios": scenarios}))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return root, scenarios, start_procs(
        [[sys.executable, worker.__file__, str(spec), str(r)] for r in range(world)],
        [root / f"rank{r}.log" for r in range(world)], env=env, timeout=TIMEOUT)


def finish_world(started):
    """Wait for a started world (a failed rank or the deadline kills every
    rank and raises with the logs' tails).  -> {scenario name: [result of
    rank r]}."""
    root, scenarios, procs = started
    world = len(finish_procs(procs))
    return {sc["name"]: [worker.load(root / f"{sc['name']}.r{r}.npz") for r in range(world)]
            for sc in scenarios}


def _save_steps(path, seed, batches, emb_rows=48):
    """The weights of tests/test_parallel.py's run_steps (JAX init, carried
    through convert.py) and `batches`, in the worker's steps layout."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((emb_rows, 16)).astype(np.float32)
    jparams = jax.tree.map(np.asarray, init_umpr(jax.random.PRNGKey(seed),
                                                 JaxDims(review_net_only=True), emb))
    state = {f"p/{k}": v.numpy() for k, v in params_from_jax(jparams).items()}
    arrays = {f"b{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()}
    np.savez(path, emb=emb, **state, **arrays)
    return {"kind": "steps", "data": str(path), "lr": LR, "l2": 1e-3,
            "dims": {"gru_size": 64, "self_atte_size": 64}}


def _parallel_batches():
    return [random_batch(np.random.default_rng(100 + i), B=B, S=S, L=L, S_ui=S_UI)
            for i in range(3)]


def _skewed_batches():
    """The longest histories and sentences lie only in rank 1's rows
    (8..15): rank 0's rows hold at most 2 sentences of at most 8 tokens."""
    batches = []
    for i in range(3):
        b = random_batch(np.random.default_rng(200 + i), B=B, S=S, L=L, S_ui=S_UI,
                         max_count=2, max_len=8)
        late = random_batch(np.random.default_rng(300 + i), B=B, S=S, L=L, S_ui=S_UI)
        for k in b:
            b[k][8:] = late[k][8:]
        for key in ("u", "i"):
            b[f"{key}_counts"][12] = S
            b[f"{key}_lengths"][12] = L
            b[f"{key}_tokens"][12] = 3 + np.arange(S * L).reshape(S, L) % 40
        batches.append(b)
    return batches


def _dead_rank1_batches():
    """A last batch whose rank-1 rows are all dead, padded as the loader
    pads them (row 0's tokens, counts 0, lengths 1, sample_mask 0)."""
    batches = _parallel_batches()[:2]
    last = random_batch(np.random.default_rng(400), B=B, S=S, L=L, S_ui=S_UI)
    for k in last:
        last[k][8:] = last[k][0]
    last["sample_mask"][8:] = 0.0
    for k in ("u_counts", "i_counts", "ui_counts"):
        last[k][8:] = 0
    for k in ("u_lengths", "i_lengths", "ui_lengths"):
        last[k][8:] = 1
    return batches + [last]


def _write_photos(root):
    import cv2
    rng = np.random.default_rng(0)
    (root / "photos").mkdir()
    for line in open(root / "photos.json"):
        pid = json.loads(line)["photo_id"]
        assert cv2.imwrite(str(root / "photos" / f"{pid}.jpg"),
                           rng.integers(0, 256, (40, 36, 3)).astype(np.uint8))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded corpus with photos and an odd-sized word table, its splits
    cached in the data_dir (the workers load the caches)."""
    root = tmp_path_factory.mktemp("corpus")
    glove = str(write_splits(root, seed=2, shards=5, users=6, items=6, per_user=4,
                             vocab=300, dim=16))
    _write_photos(root)
    cfg = Config(SHAPE + ["--data_dir", str(root), "--word2vec_file", glove])
    w2v = Word2vec(glove)
    for s in ("train", "valid", "test"):
        build_dataset(str(root / f"{s}.csv"), str(root / "photos.json"), str(root / "photos"),
                      w2v, cfg).save(str(root / f"dataset_{s}.cache"))
    return root, glove, w2v.embedding.shape[0]


# the 2-rank Trainer scenarios: streamed, resident at --steps_per_dispatch
# 2 (the multi-step loop, gathering its rows), full UMPR with dropout,
# accumulation (and with dropout), bf16, the sharded table and two meshes
# with it
FITS = {"umpr_r": UMPR_R + ["--device_dataset", "off"],
        "resident_k2": UMPR_R + ["--steps_per_dispatch", "2"],
        "full_dropout": FULL,
        "accum": UMPR_R + ["--grad_accum_steps", "2"],
        "full_dropout_accum": FULL + ["--grad_accum_steps", "2"],
        "shard": UMPR_R + ["--device_dataset", "off", "--shard_embedding", "True"],
        "umpr_r_bf16": UMPR_R + ["--device_dataset", "off", "--compute_dtype", "bfloat16"],
        "shard_bf16": UMPR_R + ["--device_dataset", "off", "--shard_embedding", "True",
                                "--compute_dtype", "bfloat16"],
        "mesh_1x2": UMPR_R + ["--mesh_shape", "[1, 2]", "--shard_embedding", "True"],
        "mesh_2x1": UMPR_R + ["--mesh_shape", "[2, 1]", "--shard_embedding", "True"]}
MESH_2X2 = UMPR_R + ["--mesh_shape", "[2, 2]", "--shard_embedding", "True"]


def _fit(name, corpus, runs, flags):
    """A fit scenario; its run directory is kept only where a test reads
    its best/ (the sharded table's), since full UMPR's checkpoints take
    hundreds of MB a run."""
    root, glove, _ = corpus
    return {"kind": "fit", "name": name, "data": str(root),
            "keep_run": "--shard_embedding" in flags,
            "argv": SHAPE + list(flags) + ["--data_dir", str(root), "--word2vec_file", glove,
                                           "--model_path", str(runs / name)]}


def one_rank(sc):
    """The scenario in this process, with no process group."""
    assert not dist.is_initialized()
    torch.set_num_threads(1)
    return worker.run(sc)


def _without_layout(flags):
    """`flags` less --mesh_shape and --shard_embedding and their values: a
    world of 1 has neither."""
    out = list(flags)
    for key in ("--mesh_shape", "--shard_embedding"):
        if key in out:
            i = out.index(key)
            del out[i:i + 2]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, corpus):
    """Every scenario on 2 ranks (one world) and on 4 (another), the 1-rank
    references computed here while the worlds run, and the JAX package's
    run_steps on 1 and 2 devices.  -> (steps scenarios, {name: [rank
    results]}, {name: 1-rank result}, {devices: (losses, trainable)})."""
    root = tmp_path_factory.mktemp("worlds")
    steps = {name: dict(_save_steps(root / f"{name}.npz", seed, batches()), name=name)
             for name, seed, batches in (("parallel", 0, _parallel_batches),
                                         ("skewed", 1, _skewed_batches),
                                         ("dead", 2, _dead_rank1_batches))}
    fits = {name: _fit(name, corpus, root / "runs", flags)
            for name, flags in {**FITS, "mesh_2x2": MESH_2X2}.items()}
    worlds = [start_world(root / "world2", 2, list(steps.values()) + [
                  sc for name, sc in fits.items() if name != "mesh_2x2"]),
              start_world(root / "world4", 4, [fits["mesh_2x2"]])]
    one, by_flags, results = {}, {}, {}
    try:
        for name, sc in steps.items():
            one[name] = one_rank(sc)
        for name, flags in {**FITS, "mesh_2x2": MESH_2X2}.items():
            key = tuple(_without_layout(flags))
            if key not in by_flags:
                by_flags[key] = one_rank(_fit(name, corpus, root / "one", key))
            one[name] = by_flags[key]
        jax_runs = {n: jax_run_steps(jax.devices()[:n]) for n in (1, 2)}
    finally:
        for w in worlds:
            results.update(finish_world(w))
    return steps, results, one, jax_runs


def assert_ranks_bit_equal(results):
    """Losses, events and trainable parameters bit for bit."""
    first = results[0]
    for r in results[1:]:
        assert r["events"] == first["events"]
        np.testing.assert_array_equal(r["losses"], first["losses"])
        assert r["params"].keys() == first["params"].keys()
        for k, v in first["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


def adam_reach(lr, steps):
    """How far two runs' Adam paths can part in `steps` steps at rate `lr`,
    whatever their gradients: each step moves an element by lr *
    |mu_hat| / (sqrt(nu_hat) + eps), and by Cauchy-Schwarz over the
    moments' weights w_i, u_i of the gradients seen, |mu_hat| /
    sqrt(nu_hat) <= sqrt(sum_i w_i^2 / u_i) (1.0 at the first step)."""
    reach = 0.0
    for t in range(1, steps + 1):
        w = (1 - BETA1) * BETA1 ** np.arange(t) / (1 - BETA1 ** t)
        u = (1 - BETA2) * BETA2 ** np.arange(t) / (1 - BETA2 ** t)
        reach += np.sqrt(np.sum(w * w / u))
    return 2 * LR * reach


def assert_logged_close(got, want, rtol=RTOL):
    """The per-step losses, the events and their logged values within
    `rtol`."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
    assert [e["event"] for e in got["events"]] == [e["event"] for e in want["events"]]
    for e, f in zip(got["events"], want["events"]):
        for k in ("train_loss", "valid_mse", "test_mse"):
            if k in f:
                np.testing.assert_allclose(e[k], f[k], rtol=rtol, err_msg=(k, f))


def assert_close(got, want, whole_fit=False):
    """Losses and logged MSEs within RTOL; parameters within RTOL and ATOL
    after a few steps.  After a whole fit each parameter tensor is held to
    RTOL in l2 instead: a gradient summed in another order differs in its
    last bits, Adam divides that by the element's RMS gradient, and over a
    fit the gap grows past ATOL at some elements (chip_smoke.param_gaps
    lists the farthest beside their RMS gradients); a VGG16 ReLU or pool
    decision within rounding of its threshold moves a conv weight's
    gradient (PARITY.md).  tests/test_parallel.py's 3 steps of UMPR-R
    reach neither.  A leaf whose every RMS gradient in the 1-rank run is
    below GRAD_ROUNDING has gradients of rounding residue alone
    (visual_net.linear.bias: it cancels in pos_emb - img_emb, eq. 11):
    Adam's steps follow their signs, so it is held to adam_reach."""
    assert_logged_close(got, want)
    assert got["params"].keys() == want["params"].keys() == want["grad_rms"].keys()
    assert got["steps"] == want["steps"] > 0
    for k, v in want["params"].items():
        if want["grad_rms"][k].max() < GRAD_ROUNDING:
            assert np.abs(got["params"][k] - v).max() <= adam_reach(LR, want["steps"]), k
        elif whole_fit:
            assert np.linalg.norm(got["params"][k] - v) <= RTOL * np.linalg.norm(v), k
        else:
            np.testing.assert_allclose(got["params"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def test_two_ranks_match_one_rank_and_the_jax_devices(runs):
    """UMPR-R on tests/test_parallel.py's weights and batches: 2 gloo ranks
    bit-equal, within 1e-5 of the port's 1-rank run and of the JAX
    package's run_steps on 1 and on 2 devices."""
    _, results, one, jax_runs = runs
    ranks = results["parallel"]
    assert_ranks_bit_equal(ranks)
    assert_close(ranks[0], one["parallel"])
    for losses, trainable in jax_runs.values():
        np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=RTOL, atol=1e-6)
        want = params_from_jax(jax.tree.map(np.asarray, trainable))
        assert want.keys() == ranks[0]["params"].keys()
        for k, v in want.items():
            np.testing.assert_allclose(ranks[0]["params"][k], v.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def _local_maxima(batch, rows):
    return (max(batch["u_counts"][rows].max(), batch["i_counts"][rows].max()),
            max(batch["u_lengths"][rows].max(), batch["i_lengths"][rows].max()))


def test_pad_maxima_of_the_whole_batch_on_every_rank(runs):
    """The longest count and length lie only in rank 1's rows: rank 0's own
    maxima differ from the global ones (the reference's DataParallel
    shard-length bug would run it at them), and the ranks still give the
    1-rank run."""
    steps, results, one, _ = runs
    data = np.load(steps["skewed"]["data"])
    model = UMPR(ModelDims(**steps["skewed"]["dims"]), data["emb"])
    model.load_state_dict({k[2:]: torch.from_numpy(data[k]) for k in data.files
                           if k.startswith("p/")})
    for b in _skewed_batches():
        whole = _local_maxima(b, slice(0, B))
        own = _local_maxima(b, slice(0, 8))
        assert whole == (S, L) == _local_maxima(b, slice(8, 16))
        assert own[0] < S and own[1] < L
        rank0 = multihost.put_global(b, slice(0, 8))
        np.testing.assert_array_equal(rank0["pad_maxima"][:2], whole)
        # rank 0's rows score otherwise at their own maxima: the bug shows
        # (in the head's input; these weights clamp its output to 0)
        heads = []
        hook = model.linear_fusion.register_forward_hook(lambda m, i, o: heads.append(i[0]))
        with torch.no_grad():
            model({k: torch.from_numpy(v) for k, v in rank0.items()})
            model({k: torch.from_numpy(v) for k, v in rank0.items() if k != "pad_maxima"})
        hook.remove()
        assert (heads[0] - heads[1]).abs().max() > 1e-4
    assert_ranks_bit_equal(results["skewed"])
    assert_close(results["skewed"][0], one["skewed"])


def test_last_batch_with_dead_rows_on_one_rank(runs):
    """The last batch's rows 8..15 (all of rank 1's) are dead: rank 1 adds
    zeros, and the MSE still divides by the 8 real samples."""
    _, results, one, _ = runs
    assert_ranks_bit_equal(results["dead"])
    assert_close(results["dead"][0], one["dead"])


@pytest.mark.parametrize("name", ["umpr_r", "resident_k2", "full_dropout", "accum"])
def test_fit_on_two_ranks_matches_one_rank(name, runs):
    """Trainer.fit + test on 2 ranks: streamed (``umpr_r``), resident at
    --steps_per_dispatch 2 (``resident_k2``), full UMPR at 32 px with
    dropout on, its masks drawn at the global batch's shape
    (``full_dropout``), and --grad_accum_steps 2 (``accum``)."""
    _, results, one, _ = runs
    assert_ranks_bit_equal(results[name])
    assert_close(results[name][0], one[name], whole_fit=True)
    assert [e["event"] for e in results[name][0]["events"]].count("test") == 1
    # the rule of rounding residue takes the leaf whose gradient cancels, alone
    residue = {k for k, g in one[name]["grad_rms"].items() if g.max() < GRAD_ROUNDING}
    assert residue == ({"visual_net.linear.bias"} if name == "full_dropout" else set())


def _step_masks(keep, k, layers=2):
    """A fit's recorded dropout masks (each train forward's VGG16
    classifier calls, in order) -> per train step, per call, the masks of
    the step's k micro-batches joined in row order."""
    per_step = k * layers
    assert keep and len(keep) % per_step == 0
    return [[np.concatenate([keep[s + j * layers + c] for j in range(k)])
             for c in range(layers)] for s in range(0, len(keep), per_step)]


def test_accumulated_dropout_on_two_ranks_takes_the_one_rank_masks(runs):
    """Full UMPR with dropout at --grad_accum_steps 2 on 2 ranks
    (Trainer._dropout draws the whole batch's masks micro-batch by
    micro-batch and keeps the rank's rows; train_step_accum cuts them into
    the rank's micro-batches): at every train step each rank's forwards
    apply the masks of its rows in the 1-rank run, bit for bit; the ranks
    are bit-equal, the losses and logged MSEs within RTOL of the 1-rank
    run's, and every parameter within adam_reach of it.  The parameters
    are not held to RTOL: at 32 px a VGG16 ReLU of the last block crosses
    its threshold within rounding in one run and not in the other during
    the fit (the masks and the first steps' features agree), and from
    there the conv and classifier gradients differ by whole rows."""
    _, results, one, _ = runs
    ranks, want = results["full_dropout_accum"], one["full_dropout_accum"]
    assert_ranks_bit_equal(ranks)
    assert_logged_close(ranks[0], want)
    whole = _step_masks(want["keep"], 2)
    assert len(whole) == want["steps"] == ranks[0]["steps"]
    for r, rank in enumerate(ranks):
        own = _step_masks(rank["keep"], 2)
        assert len(own) == len(whole)
        for step, (got, full) in enumerate(zip(own, whole)):
            for g, f in zip(got, full):
                rows = f.shape[0] // len(ranks)
                np.testing.assert_array_equal(g, f[r * rows:(r + 1) * rows],
                                              err_msg=(r, step))
    reach = adam_reach(LR, want["steps"])
    for k, v in want["params"].items():
        assert np.abs(ranks[0]["params"][k] - v).max() <= reach, k


def test_bf16_two_ranks_match_one_rank(runs):
    """UMPR-R under --compute_dtype bfloat16 on 2 ranks against the 1-rank
    run: the ranks bit-equal, the logged values within BF16_RTOL and each
    parameter tensor within BF16_L2 (l2).  The forward runs on bf16
    copies of the weights, so each rank's gradient of a weight is its
    rows' sum rounded to bf16 before the all-reduce adds the two, where
    the 1-rank run rounds the whole batch's sum once: an ulp apart here
    and there, which Adam and the recurrence carry along."""
    _, results, one, _ = runs
    ranks, want = results["umpr_r_bf16"], one["umpr_r_bf16"]
    assert_ranks_bit_equal(ranks)
    assert_logged_close(ranks[0], want, BF16_RTOL)
    for k, v in want["params"].items():
        assert np.linalg.norm(ranks[0]["params"][k] - v) <= BF16_L2 * np.linalg.norm(v), k


@pytest.mark.parametrize("replicated,sharded", [("umpr_r", "shard"),
                                                ("umpr_r_bf16", "shard_bf16")])
def test_shard_embedding_is_bit_equal_to_the_replicated_table(replicated, sharded, runs,
                                                              corpus):
    """--shard_embedding over 2 ranks with an odd vocabulary, in f32 and
    under --compute_dtype bfloat16 (the table cast in the forward): the
    same bits as the replicated table's run, and best/ holds the unpadded
    table."""
    steps, results, _, _ = runs
    _, _, vocab = corpus
    assert vocab % 2 == 1
    assert_ranks_bit_equal(results[sharded])
    assert_ranks_bit_equal([results[replicated][0], results[sharded][0]])
    # the shards are the rows of the table padded to an even count
    table = results[replicated][0]["table"]
    shards = np.concatenate([r["table"] for r in results[sharded]])
    assert table.shape == (vocab, 16) and shards.shape == (vocab + 1, 16)
    np.testing.assert_array_equal(shards[:vocab], table)
    assert not shards[vocab:].any()
    best = os.path.join(os.path.dirname(steps["parallel"]["data"]), "runs", sharded, "best")
    keys = json.load(open(os.path.join(best, "structure.json")))["keys"]
    with np.load(os.path.join(best, "arrays.npz")) as z:
        saved = z[f"leaf_{keys.index(str(['embedding'])):05d}"]
    np.testing.assert_array_equal(saved, table)


@pytest.mark.parametrize("name", ["mesh_1x2", "mesh_2x1", "mesh_2x2"])
def test_mesh_shapes_match_one_rank(name, runs):
    """--mesh_shape [1, 2] (the table over mp, each rank the whole batch),
    [2, 1] and [2, 2] (4 ranks), each with --shard_embedding: every rank
    bit-equal, within 1e-5 of the 1-rank run."""
    _, results, one, _ = runs
    assert len(results[name]) == (4 if name == "mesh_2x2" else 2)
    assert_ranks_bit_equal(results[name])
    assert_close(results[name][0], one[name], whole_fit=True)


def test_layout_errors_name_the_world():
    with pytest.raises(ValueError, match="batch_size 6 must divide over the 4 data-parallel"
                                         " ranks of a world of 4"):
        port_mesh.check_layout([4], 6, 4)
    with pytest.raises(ValueError, match=r"--mesh_shape \[2, 3\] lays out 6 ranks .* the "
                                         "world has 4"):
        port_mesh.check_layout([2, 3], 12, 4)
    with pytest.raises(ValueError, match="world has 2"):
        Config(["--device", "cpu", "--mesh_shape", "[4]", "--num_processes", "2"])
    with pytest.raises(ValueError, match="batch_size 5"):
        Config(["--device", "cpu", "--batch_size", "5", "--num_processes", "2"])


def test_local_rows_partition():
    """JAX's test_local_rows_partition (tests/test_multihost.py): the row
    blocks of the ranks tile the batch in rank order."""
    for world in (1, 2, 4, 8):
        rows = [multihost.local_rows(64, world, i) for i in range(world)]
        assert rows[0].start == 0 and rows[-1].stop == 64
        assert all(a.stop == b.start for a, b in zip(rows, rows[1:]))
        assert {r.stop - r.start for r in rows} == {64 // world}
    with pytest.raises(ValueError):
        multihost.local_rows(10, 4, 0)


def test_rank_coords_follow_make_mesh_reshape():
    """Rank r sits where JAX's make_mesh puts device r: devices.reshape(shape)
    row-major, so (dp = r // mp, mp = r % mp)."""
    from umpr_tpu.parallel.mesh import make_mesh
    for shape in ([8], [4, 2], [2, 4], [2, 2, 2]):
        devices = make_mesh(jax.devices()[:8], shape=shape).devices
        for r in range(8):
            assert devices[port_mesh.rank_coords(r, shape)].id == jax.devices()[r].id
    assert port_mesh.rank_coords(5, [4, 2]) == (5 // 2, 5 % 2)


def test_world_of_one_calls_no_collective():
    """Without a process group the Trainer has no mesh, and a train and an
    eval step call no collective (dist.all_reduce patched to raise)."""
    assert not dist.is_initialized() and multihost.world_size() == 1
    batch = random_batch(np.random.default_rng(5), B=4, S=S, L=L, S_ui=S_UI)
    emb = np.random.default_rng(0).standard_normal((48, 16)).astype(np.float32)
    model = UMPR(ModelDims(gru_size=8, self_atte_size=8), emb, torch.Generator().manual_seed(0))
    opt = make_optimizer(model, 1e-3, 1e-3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    raise_ = mock.Mock(side_effect=AssertionError("a collective was called"))
    with mock.patch.object(dist, "all_reduce", raise_), \
            mock.patch.object(dist, "all_gather", raise_), \
            mock.patch.object(dist, "broadcast_object_list", raise_):
        assert port_mesh.setup_runtime(Config(["--device", "cpu"])) is None
        train_step(model, opt, tb)
        eval_step(model, tb)
        assert multihost.broadcast_str("x") == "x" and multihost.barrier("x") is None
    assert not raise_.called


def test_gloo_on_cuda_refuses_graphs_and_serving_refuses_ranks(tmp_path):
    """--steps_per_dispatch > 1 with gloo collectives on a card raises
    (a CUDA graph cannot capture gloo), before any device use; a Predictor
    over more than one rank raises naming ROADMAP A7b."""
    from types import SimpleNamespace
    from umpr_tpu_torch import serve
    from umpr_tpu_torch.train import trainer as trainer_module
    cfg = Config(["--device", "cpu", "--review_net_only", "True", "--steps_per_dispatch", "4",
                  "--eval_every", "4"])
    cfg.torch_device = torch.device("cuda")
    gloo = SimpleNamespace(backend="gloo", dp=2, rows=lambda B: slice(0, B // 2))
    with mock.patch.object(trainer_module, "setup_runtime", return_value=gloo), \
            pytest.raises(NotImplementedError, match="cannot capture gloo"):
        trainer_module.Trainer(cfg, mock.Mock(), None)
    for flags in (["--num_processes", "2"], ["--coordinator_address", "127.0.0.1:1"]):
        cfg = Config(["--device", "cpu", "--review_net_only", "True"] + flags)
        with pytest.raises(NotImplementedError, match="A7b"):
            serve.Predictor(cfg, None, str(tmp_path))
