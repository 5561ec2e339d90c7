"""Multi-process training through the port's CLI on the CPU: two
``python -m umpr_tpu_torch.main --device cpu`` processes joined by
``--coordinator_address 127.0.0.1:<port> --num_processes 2 --process_id
i`` (gloo), against the 1-process run of the same flags.

The two processes run in different working directories, as on hosts that
share no filesystem but the corpus: rank 1's relative run directory stays
empty, so every checkpoint file is the primary's, and its resume and test
read only what the primary broadcasts.  Output goes to files (a full pipe
would block a rank inside a collective), and every wait has a timeout
that kills both ranks.
"""

import json
import os
import re
import socket
import sys

import numpy as np
import pytest

from chip_smoke import after_resume, finish_procs, start_procs, write_splits
from umpr_tpu_torch import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
RTOL = 1e-5
SHAPE = ["--batch_size", "8", "--max_sent_count", "6", "--max_sent_length", "10",
         "--max_ui_sent_count", "2", "--min_sent_count", "3", "--gru_size", "64",
         "--self_atte_size", "16"]
RUN = ["--device", "cpu", "--review_net_only", "True", "--train_epochs", "2",
       "--eval_every", "2", "--learning_rate", "1e-3", "--seed", "4"]
STOP = 3  # the interrupted run stops after 3 steps; it saved last/ at 2
# main with Trainer.fit's interruption hook (as chip_smoke's resume phase)
CUT = ("import sys\n"
       "from umpr_tpu_torch import main\n"
       "from umpr_tpu_torch.train.trainer import Trainer\n"
       "fit = Trainer.fit\n"
       f"Trainer.fit = lambda self, *a, **k: fit(self, *a, _stop_after_batches={STOP})\n"
       "main.main(sys.argv[1:])\n")


def _address():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def start(root, name, argv, code=None):
    """Two ranks of `argv`, rank i in ``root/<name>/rank<i>``."""
    address = _address()
    cwds = [root / name / f"rank{i}" for i in range(2)]
    for cwd in cwds:
        cwd.mkdir(parents=True)
    cmd = [sys.executable] + (["-c", code] if code else ["-m", "umpr_tpu_torch.main"])
    return start_procs(
        [cmd + argv + ["--coordinator_address", address, "--num_processes", "2",
                       "--process_id", str(i)] for i in range(2)],
        [cwd / "out.txt" for cwd in cwds], cwds=cwds,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), timeout=TIMEOUT)


def finish(started, ok=True):
    """Wait for both ranks (killed at the deadline); -> [(exit code,
    output tail)].  With `ok` a failed rank raises with both tails."""
    return finish_procs(started, check=ok)


LINE = re.compile(r"train loss ([0-9.]+); valid mse ([0-9.]+)|test mse is ([0-9.]+)")


def logged(path):
    """(train loss, valid MSE) pairs and the test MSE of a log file."""
    found = [m.groups() for m in LINE.finditer(open(path).read())]
    return ([(float(a), float(b)) for a, b, _ in found if a],
            [float(c) for _, _, c in found if c])


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        return x.files == y.files and all(np.array_equal(x[k], y[k]) for k in x.files)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The runs: 2-process (default run and log names), the 1-process
    twin, a 2-process run stopped after STOP steps and its resumed run, a
    2-process --test_only, and a resume from a missing path."""
    root = tmp_path_factory.mktemp("multihost")
    data = root / "data"
    glove = str(write_splits(data, seed=2, shards=5, users=6, items=6, per_user=4,
                             vocab=300, dim=16))
    base = RUN + SHAPE + ["--data_dir", str(data), "--word2vec_file", glove]
    whole = start(root, "whole", base + ["--metrics_jsonl", str(root / "whole.jsonl")])
    out = {"root": root, "whole": finish(whole)}
    # the caches now exist: the other runs load them
    cut_dir = root / "cut" / "rank0" / "run"
    cut = start(root, "cut", base + ["--model_path", "run", "--save_every_batches", "2"],
                code=CUT)
    missing = start(root, "missing", base + ["--model_path", "run", "--resume_path",
                                             str(root / "nowhere")])
    out["one"] = port_main.main(base + ["--model_path", str(root / "one"),
                                        "--log_path", str(root / "one.txt"),
                                        "--metrics_jsonl", str(root / "one.jsonl")])
    out["cut"], out["missing"] = finish(cut), finish(missing, ok=False)
    out["meta"] = json.load(open(cut_dir / "last" / "meta.json"))
    whole_dir = next((root / "whole" / "rank0" / "model").iterdir())
    resumed = start(root, "resumed", base + [
        "--model_path", str(cut_dir), "--resume_path", str(cut_dir),
        "--metrics_jsonl", str(root / "resumed.jsonl")])
    test_only = start(root, "test_only", base + ["--model_path", str(whole_dir),
                                                 "--test_only", "True", "--log_path", "t.txt"])
    out["resumed"], out["test_only"] = finish(resumed), finish(test_only)
    out["whole_dir"], out["cut_dir"] = whole_dir, cut_dir
    return out


def test_two_processes_log_the_one_process_run(cli):
    """Both ranks' logs (``.p0`` / ``.p1``, in their own directories) hold
    the 1-process run's train losses, validation and test MSEs; there is
    one run directory, named by the primary's stamp on both ranks."""
    root = cli["root"]
    want_pairs, want_test = logged(root / "one.txt")
    assert len(want_pairs) >= 4 and len(want_test) == 1
    names = []
    for i in range(2):
        cwd = root / "whole" / f"rank{i}"
        logs = list((cwd / "log").iterdir())
        assert len(logs) == 1 and logs[0].name.endswith(f".p{i}.txt"), logs
        pairs, test = logged(logs[0])
        np.testing.assert_allclose(pairs, want_pairs, rtol=RTOL)
        np.testing.assert_allclose(test, want_test, rtol=RTOL)
        runs = list((cwd / "model").iterdir())
        assert len(runs) == 1
        names.append((logs[0].name[:-len(f".p{i}.txt")], runs[0].name))
    assert names[0] == names[1] and names[0][0] == names[0][1]


def test_primary_alone_writes_checkpoints_and_builds_the_caches(cli):
    """best/ and last/ exist in rank 0's run directory only; each split's
    cache was built once, by rank 0, and loaded by rank 1."""
    root = cli["root"]
    run0, run1 = ((root / "whole" / f"rank{i}" / "model").iterdir() for i in range(2))
    run0, run1 = next(run0), next(run1)
    assert (run0 / "best" / "arrays.npz").exists() and (run0 / "last" / "arrays.npz").exists()
    assert not any(run1.iterdir())
    logs = [next((root / "whole" / f"rank{i}" / "log").iterdir()).read_text()
            for i in range(2)]
    for split in ("train", "valid", "test"):
        assert f"Loaded {split} dataset from" not in logs[0]
        assert f"Loaded {split} dataset from" in logs[1]
        assert (root / "data" / f"dataset_{split}.cache" / "complete.marker").exists()
    assert "rank 0 at {'dp': 0}, collectives on gloo" in logs[0]
    assert "rank 1 at {'dp': 1}, collectives on gloo" in logs[1]


def test_resume_on_two_processes_is_bit_exact(cli):
    """Stopped after 3 steps (last/ saved at 2, mid-epoch), resumed on 2
    processes: best/ and last/ hold the uninterrupted run's bits, and the
    metrics logged after the resume point are its values."""
    meta = cli["meta"]
    assert meta["epoch"] == 0 and meta["batch_counter"] == 2 and meta["batch_in_epoch"] == 2
    for name in ("best", "last"):
        assert _npz_equal(cli["whole_dir"] / name / "arrays.npz",
                          cli["cut_dir"] / name / "arrays.npz"), name
    events = {r: [json.loads(line) for line in open(cli["root"] / f"{r}.jsonl")]
              for r in ("whole", "resumed")}
    want = after_resume(events["whole"], meta["batch_counter"])
    assert len(want) >= 3 and after_resume(events["resumed"], meta["batch_counter"]) == want


def test_test_only_on_two_processes(cli):
    """--test_only on 2 processes reports the training run's test MSE on
    both ranks (rank 1 reads nothing: the primary broadcasts best/)."""
    root = cli["root"]
    _, want = logged(next((root / "whole" / "rank0" / "log").iterdir()))
    for i in range(2):
        _, got = logged(root / "test_only" / f"rank{i}" / f"t.p{i}.txt")
        assert got == want


def test_failed_restore_raises_on_both_ranks(cli):
    """A missing --resume_path: the primary's error is broadcast before any
    array, so both ranks raise within the timeout instead of waiting."""
    (rc0, tail0), (rc1, tail1) = cli["missing"]
    assert rc0 and rc1 and rc0 != -9 and rc1 != -9, (tail0, tail1)
    assert "failed on the primary rank" in tail0 and "failed on the primary rank" in tail1
    assert "nowhere" in tail1
