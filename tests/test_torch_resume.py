"""``last/`` checkpoints and resume in the port on the CPU.

- A run stopped mid-epoch (``_stop_after_batches``) and resumed from its
  ``--save_every_batches`` checkpoint ends with the bits of the
  uninterrupted run: parameters, Adam's state, ``best/`` and every
  ``--metrics_jsonl`` value computed after the resume point, for UMPR-R
  and full UMPR at 32 px (JPEG photos, dropout).
- Adam's state in optax's layout: one step against the JAX package's
  optimizer (1e-5, PARITY.md's one-step tolerance), and a restored
  optimizer that takes the next step with the bits of the original.
- Across packages: a JAX-written ``last/`` resumes in the port, and the
  rest of the run matches the JAX run at the 1e-4 of the fit test; a
  port-written ``last/`` restores in ``umpr_tpu`` (``restore_last`` and
  the JAX Trainer's ``--resume_path``).
- The epoch cadence, async writes equal to sync ones, and the resident
  training corpus raising.

The CPU's thread count is fixed in each test, so that oneDNN's
reductions keep one order."""

import json
import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import after_resume
from tests.ref_oracle import random_batch
from tests.test_device_dataset import EMB, VOCAB, packed_dataset
from tests.test_torch_train import (RUN, SHAPE, _events, _jax_and_port_models, _splits)
from tests.test_torch_train import EMB as TRAIN_EMB
from tests.test_torch_train import VOCAB as TRAIN_VOCAB
from umpr_tpu.config import Config as JaxConfig
from umpr_tpu.data.dataset import build_dataset as jax_build_dataset
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu.text.vocab import Word2vec as JaxWord2vec
from umpr_tpu.train import checkpoint as jckpt
from umpr_tpu.train.optim import make_optimizer as jax_make_optimizer
from umpr_tpu.train.optim import split_frozen
from umpr_tpu.train.step import make_train_step
from umpr_tpu.train.trainer import Trainer as JaxTrainer
from umpr_tpu.utils.logging import get_logger as jax_get_logger
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import adam_from_jax, adam_to_jax
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.data.loader import to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.optim import make_optimizer
from umpr_tpu_torch.train.step import train_step
from umpr_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True)
def fixed_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


class _W2v:
    embedding = np.random.default_rng(1).standard_normal((VOCAB, EMB)).astype(np.float32)


BASE = ["--device", "cpu", "--batch_size", "8", "--train_epochs", "2",
        "--eval_every", "4", "--learning_rate", "0.01", "--min_sent_count", "1",
        "--seed", "2"]
FULL = ["--review_net_only", "False", "--photo_size", "32", "--kernel_count", "8",
        "--vgg_fused_pool", "True"]


def _with_photos(ds, tmp_path):
    """JPEG photos for a packed dataset's samples (four files, a missing
    one and empty slots)."""
    rng = np.random.default_rng(5)
    files = []
    for j in range(4):
        p = tmp_path / f"p{j}.jpg"
        assert cv2.imwrite(str(p), rng.integers(0, 256, (40, 50, 3)).astype(np.uint8))
        files.append(str(p))
    paths = np.full((len(ds), 1, 1), "", dtype="<U256")
    for i in range(len(ds)):
        if i % 5 != 4:
            paths[i, 0, 0] = str(tmp_path / "gone.jpg") if i % 7 == 6 else files[i % 4]
    ds.photo_paths = paths
    return ds


def _trainer(flags, tmp_path, name, logger=None):
    cfg = Config(BASE + flags + ["--metrics_jsonl", str(tmp_path / f"{name}.jsonl")])
    return Trainer(cfg, logger or logging.getLogger(f"resume-{name}"), _W2v())


def _flat(tree):
    return {ckpt.keystr(p): np.asarray(a) for p, a in ckpt.leaves_with_path(tree)}


@pytest.mark.parametrize("model", ["umpr_r", "full"])
def test_resumed_run_equals_uninterrupted_bit_for_bit(model, tmp_path, caplog):
    flags = FULL if model == "full" else ["--review_net_only", "True"]
    train, valid = packed_dataset(40, seed=0), packed_dataset(8, seed=1)
    if model == "full":
        train, valid = _with_photos(train, tmp_path), _with_photos(valid, tmp_path)

    whole = _trainer(flags, tmp_path, "whole")
    whole.fit(train, valid, str(tmp_path / "whole"))
    assert whole.batch_counter == 10  # 2 epochs of 5 batches

    cut = _trainer(flags + ["--save_every_batches", "2"], tmp_path, "cut")
    cut.fit(train, valid, str(tmp_path / "cut"), _stop_after_batches=3)
    meta = json.load(open(tmp_path / "cut" / "last" / "meta.json"))
    assert meta == {"epoch": 0, "batch_counter": 2, "best_loss": 100.0,
                    "batch_in_epoch": 2}

    with caplog.at_level(logging.INFO, logger="resume-resumed"):
        resumed = _trainer(flags + ["--save_every_batches", "2", "--resume_path",
                                    str(tmp_path / "cut")], tmp_path, "resumed")
    assert f"Resumed from {tmp_path / 'cut'} at epoch 0, batch 2 (+2 into the epoch)." \
        in caplog.text
    assert (resumed.start_epoch, resumed.start_batch_in_epoch) == (0, 2)
    resumed.fit(train, valid, str(tmp_path / "cut"))
    assert resumed.batch_counter == whole.batch_counter

    a, b = whole.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    (ca, mua, nua), (cb, mub, nub) = (adam_to_jax(t.model, t.opt) for t in (whole, resumed))
    assert ca == cb == 10
    for x, y in ((mua, mub), (nua, nub)):
        fx, fy = _flat(x), _flat(y)
        for k in fx:
            np.testing.assert_array_equal(fx[k], fy[k], err_msg=k)
    for name in ("best", "last"):
        fa = np.load(tmp_path / "whole" / name / "arrays.npz")
        fb = np.load(tmp_path / "cut" / name / "arrays.npz")
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{name} {k}")
    assert (json.load(open(tmp_path / "whole" / "last" / "meta.json"))
            == json.load(open(tmp_path / "cut" / "last" / "meta.json")))
    want = after_resume(_events(tmp_path / "whole.jsonl"), 2)
    assert [e["batch"] for e in want] == [4, 5, 8, 10]
    assert after_resume(_events(tmp_path / "resumed.jsonl"), 2) == want


def test_adam_state_converts_to_optax_layout_and_back():
    jparams, jdims, model = _jax_and_port_models(seed=3)
    rng = np.random.default_rng(11)
    batches = [random_batch(rng, B=2, S=3, L=7, S_ui=2, vocab=TRAIN_VOCAB, emb=TRAIN_EMB,
                            max_len=7) for _ in range(2)]
    l2, lr = 1e-3, 1e-3
    tx = jax_make_optimizer(l2)
    trainable, frozen = split_frozen(jparams)
    _, jstate, _, _ = make_train_step(jdims, tx, donate=False)(
        trainable, frozen, tx.init(trainable),
        {k: jnp.asarray(v) for k, v in batches[0].items()}, lr, None)
    opt = make_optimizer(model, l2, lr)
    train_step(model, opt, to_device(batches[0], "cpu"), lr)

    count, mu, nu = adam_to_jax(model, opt)
    assert count.dtype == np.int32 and count == int(jstate[1].count) == 1
    for ours, theirs in ((mu, jstate[1].mu), (nu, jstate[1].nu)):
        want = {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(theirs)[0]}
        got = _flat(ours)
        assert got.keys() == want.keys()
        for k in want:
            scale = max(np.abs(want[k]).max(), 1e-30)
            np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=1e-5,
                                       err_msg=k)

    # a fresh optimizer loaded from optax's layout takes the next step with
    # the original's bits
    twin = UMPR(ModelDims(gru_size=64, self_atte_size=16), np.zeros((TRAIN_VOCAB, TRAIN_EMB),
                                                                    np.float32))
    twin.load_state_dict(model.state_dict())
    twin_opt = make_optimizer(twin, l2, lr)
    adam_from_jax(twin, twin_opt, count, mu, nu)
    for m, o in ((model, opt), (twin, twin_opt)):
        train_step(m, o, to_device(batches[1], "cpu"), lr)
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n
    assert all(torch.equal(opt.state[p]["exp_avg_sq"], twin_opt.state[q]["exp_avg_sq"])
               for p, q in zip(model.parameters(), twin.parameters()) if p.requires_grad)


def test_jax_written_last_resumes_in_port(tmp_path):
    glove = _splits(tmp_path)
    data = {s: str(tmp_path / f"{s}.csv") for s in ("train", "valid", "test")}
    photos = (str(tmp_path / "photos.json"), str(tmp_path / "photos"))
    jax_flags = ["--use_pallas", "False", "--multi_gpu", "False", "--device_dataset", "off",
                 "--async_checkpoint", "False"]
    jw = JaxWord2vec(glove)
    runs = {}
    for name, extra, stop in (("jax", [], 0), ("jax_cut", ["--save_every_batches", "2"], 3)):
        jcfg = JaxConfig(argv=RUN + SHAPE + jax_flags + extra + [
            "--metrics_jsonl", str(tmp_path / f"{name}.jsonl")])
        jtrainer = JaxTrainer(jcfg, jax_get_logger(logger_name=name), jw)
        jds = {s: jax_build_dataset(p, *photos, jw, jcfg) for s, p in data.items()}
        jtrainer.fit(jds["train"], jds["valid"], str(tmp_path / name), _stop_after_batches=stop)
        runs[name] = jtrainer
    jtest = runs["jax"].test(jds["test"], str(tmp_path / "jax"))

    cfg = Config(RUN + SHAPE + ["--resume_path", str(tmp_path / "jax_cut"),
                                "--metrics_jsonl", str(tmp_path / "port.jsonl")])
    w2v = Word2vec(glove)
    trainer = Trainer(cfg, logging.getLogger("port-from-jax"), w2v)
    assert (trainer.start_epoch, trainer.start_batch_in_epoch, trainer.batch_counter) \
        == (0, 2, 2)
    ds = {s: build_dataset(p, *photos, w2v, cfg) for s, p in data.items()}
    trainer.fit(ds["train"], ds["valid"], str(tmp_path / "jax_cut"))
    test_mse = trainer.test(ds["test"], str(tmp_path / "jax_cut"))
    assert trainer.batch_counter == runs["jax"].batch_counter >= 8

    ours = after_resume(_events(tmp_path / "port.jsonl"), 2)
    theirs = after_resume(_events(tmp_path / "jax.jsonl"), 2)[:-1]  # its test event comes later
    assert [(e["event"], e["batch"]) for e in ours[:-1]] == \
        [(e["event"], e["batch"]) for e in theirs]
    for key in ("valid_mse", "train_loss"):
        pick = lambda ev: [e[key] for e in ev if key in e]
        assert len(pick(theirs)) >= 2
        np.testing.assert_allclose(pick(ours[:-1]), pick(theirs), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(test_mse, jtest, rtol=1e-4, atol=1e-4)


def test_port_written_last_restores_in_jax(tmp_path):
    cfg_flags = BASE + ["--review_net_only", "True", "--save_every_batches", "3"]
    trainer = Trainer(Config(cfg_flags), logging.getLogger("port-last"), _W2v())
    trainer.fit(packed_dataset(40, seed=0), packed_dataset(8, seed=1), str(tmp_path),
                _stop_after_batches=4)
    meta = json.load(open(tmp_path / "last" / "meta.json"))
    assert meta == {"epoch": 0, "batch_counter": 3, "best_loss": 100.0,
                    "batch_in_epoch": 3}

    jcfg = JaxConfig(argv=cfg_flags + ["--multi_gpu", "False", "--device_dataset", "off",
                                       "--resume_path", str(tmp_path)])
    params = init_umpr(jax.random.PRNGKey(0), JaxDims.from_config(jcfg), _W2v.embedding)
    like, _ = split_frozen(params)
    jtrainable, jstate, jmeta = jckpt.restore_last(str(tmp_path), like,
                                                   jax_make_optimizer(1e-3).init(like))
    assert jmeta == meta and int(jstate[1].count) == 3
    # the files hold the state at the save (batch 3), one step before the stop
    saved = np.load(tmp_path / "last" / "arrays.npz")
    keys = json.load(open(tmp_path / "last" / "structure.json"))["keys"]
    on_disk = {k: saved[f"leaf_{i:05d}"] for i, k in enumerate(keys)}
    restored = {"['trainable']" + jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(jtrainable)[0]}
    restored.update({"['opt_state']" + jax.tree_util.keystr(p): np.asarray(v)
                     for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]})
    assert restored.keys() == on_disk.keys()
    for k in restored:
        np.testing.assert_array_equal(restored[k], on_disk[k], err_msg=k)

    jtrainer = JaxTrainer(jcfg, jax_get_logger(logger_name="jax-from-port"), _W2v())
    assert (jtrainer.start_epoch, jtrainer.start_batch_in_epoch,
            jtrainer.batch_counter) == (0, 3, 3)


@pytest.mark.parametrize("every,epochs", [(1, [1, 2, 3, 4, 5]), (2, [2, 4, 5]), (9, [5])])
def test_epoch_cadence_thins_saves(every, epochs, tmp_path, monkeypatch):
    calls = []
    save_last = ckpt.save_last
    monkeypatch.setattr(ckpt, "save_last",
                        lambda *a, **kw: (calls.append(kw["epoch"]), save_last(*a, **kw)))
    cfg = Config(["--device", "cpu", "--review_net_only", "True", "--batch_size", "8",
                  "--train_epochs", "5", "--eval_every", "1000", "--min_sent_count", "1",
                  "--seed", "2", "--save_last_every_epochs", str(every)])
    Trainer(cfg, logging.getLogger("cadence"), _W2v()).fit(
        packed_dataset(24), packed_dataset(8), str(tmp_path))
    assert calls == epochs  # the final epoch always saves
    assert json.load(open(tmp_path / "last" / "meta.json"))["epoch"] == 5


def test_async_checkpoint_equals_sync(tmp_path):
    files = {}
    for mode in ("True", "False"):
        cfg = Config(BASE + ["--review_net_only", "True", "--train_epochs", "3",
                             "--eval_every", "2", "--async_checkpoint", mode,
                             "--save_every_batches", "2"])
        trainer = Trainer(cfg, logging.getLogger(f"async{mode}"), _W2v())
        assert (trainer._saver is not None) == (mode == "True")
        trainer.fit(packed_dataset(24), packed_dataset(8), str(tmp_path / mode))
        files[mode] = {name: dict(np.load(tmp_path / mode / name / "arrays.npz"))
                       for name in ("best", "last")}
        files[mode]["meta"] = json.load(open(tmp_path / mode / "last" / "meta.json"))
    assert files["True"]["meta"] == files["False"]["meta"]
    for name in ("best", "last"):
        a, b = files["True"][name], files["False"][name]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")


def test_device_dataset_on_raises_in_trainer():
    flags = ["--device", "cpu", "--review_net_only", "True"]
    with pytest.raises(NotImplementedError, match="A5"):
        Trainer(Config(flags + ["--device_dataset", "on"]), logging.getLogger("on"), _W2v())
    for mode in ("auto", "off"):  # the host loader streams every batch
        Trainer(Config(flags + ["--device_dataset", mode]), logging.getLogger(mode), _W2v())
