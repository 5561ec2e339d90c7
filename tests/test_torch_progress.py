"""Progress bars in the port (``utils.logging.progress``), as the JAX
trainer's ``_progress``: shown only when stderr is a terminal, tqdm
optional (a plain ``desc n/total`` counter without it), display only.

- the three cases of ``progress``;
- with stderr a terminal (and no tqdm), the log lines and
  ``--metrics_jsonl`` events are those of a run with stderr not one;
- the totals count dispatch items, right after a mid-epoch resume at
  ``--steps_per_dispatch 2``: each bar yields as many items as its total."""

import io
import json
import logging
import sys

import pytest
import torch

from tests.test_device_dataset import packed_dataset
from tests.test_torch_train_flags import _W2v
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.train import trainer as trainer_module
from umpr_tpu_torch.train.trainer import Trainer
from umpr_tpu_torch.utils.logging import progress


class _Terminal(io.StringIO):
    def isatty(self):
        return True


@pytest.fixture(autouse=True)
def fixed_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_progress_is_silent_off_a_terminal_and_counts_without_tqdm(monkeypatch):
    items = [1, 2, 3]
    plain = io.StringIO()
    assert progress(items, "Evaluate", 3, plain) is items and plain.getvalue() == ""

    term = _Terminal()
    monkeypatch.setitem(sys.modules, "tqdm", None)  # not installed
    assert list(progress(items, "Evaluate", 3, term)) == items
    assert term.getvalue() == "\rEvaluate 1/3\rEvaluate 2/3\rEvaluate 3/3\n"

    monkeypatch.delitem(sys.modules, "tqdm")
    tqdm = pytest.importorskip("tqdm")
    bar = progress(items, "Evaluate", 3, _Terminal())
    assert isinstance(bar, tqdm.tqdm) and list(bar) == items


BASE = ["--device", "cpu", "--review_net_only", "True", "--batch_size", "8",
        "--train_epochs", "2", "--eval_every", "4", "--learning_rate", "0.01",
        "--min_sent_count", "1", "--seed", "2", "--steps_per_dispatch", "2",
        "--save_every_batches", "2"]


def _fit(tmp_path, name, caplog, *flags, stop=0):
    tmp_path.mkdir(exist_ok=True)
    cfg = Config(BASE + list(flags) + ["--metrics_jsonl", str(tmp_path / f"{name}.jsonl")])
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=f"progress-{name}"):
        trainer = Trainer(cfg, logging.getLogger(f"progress-{name}"), _W2v())
        trainer.fit(packed_dataset(56, seed=0), packed_dataset(24, seed=1),
                    str(tmp_path / "run"), _stop_after_batches=stop)
    events = [{k: v for k, v in json.loads(line).items() if k not in ("ts", "elapsed_s")}
              for line in open(tmp_path / f"{name}.jsonl")]
    lines = [r.getMessage() for r in caplog.records if "Time used" not in r.getMessage()]
    return events, lines


def test_bars_change_no_log_line_or_metric(tmp_path, caplog, monkeypatch):
    quiet = _fit(tmp_path / "a", "run", caplog)
    term = _Terminal()
    monkeypatch.setattr(sys, "stderr", term)
    monkeypatch.setitem(sys.modules, "tqdm", None)
    shown = _fit(tmp_path / "b", "run", caplog)
    assert "Training epoch 0 4/4" in term.getvalue() and "Evaluate 2/2" in term.getvalue()
    assert shown == quiet and len(quiet[0]) >= 4


def test_totals_count_dispatches_after_a_mid_epoch_resume(tmp_path, caplog, monkeypatch):
    bars = []

    def recording(it, desc, total):
        bar = [desc, total, 0]
        bars.append(bar)
        for item in it:
            bar[2] += 1
            yield item

    _fit(tmp_path, "cut", caplog, stop=1)  # 7 batches an epoch; one chunk, saved at 2
    monkeypatch.setattr(trainer_module, "progress", recording)
    _fit(tmp_path, "resumed", caplog, "--resume_path", str(tmp_path / "run"))
    train = [b for b in bars if b[0].startswith("Training")]
    # epoch 0 from batch 2: 5 batches = 2 chunks + 1 single; epoch 1: 3 + 1
    assert [(d, t) for d, t, _ in train] == [("Training epoch 0", 3), ("Training epoch 1", 4)]
    evals = [b for b in bars if b[0] == "Evaluate"]
    assert evals and all(t == 2 for _, t, _ in evals)  # 3 batches: a chunk and a single
    assert all(n == t for _, t, n in bars)
