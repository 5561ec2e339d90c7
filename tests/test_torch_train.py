"""The port's UMPR-R training path on the CPU against the JAX package: one
train step against ``make_train_step`` (use_pallas=True, the Pallas GRU
kernels interpreted), the shuffled loader order, the weight-decay mask,
a short ``Trainer.fit`` + ``test`` against the JAX Trainer, and the
``umpr_tpu_torch.main`` CLI, for UMPR-R and full UMPR (64 px photos).
Tolerances: one train step 1e-5, logged MSEs 1e-4 (PARITY.md)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_splits
from tests.ref_oracle import random_batch
from tests.test_checkpoint_loader import small_dataset
from tests.test_torch_model import _kill_rows
from umpr_tpu.config import Config as JaxConfig
from umpr_tpu.data.dataset import build_dataset as jax_build_dataset
from umpr_tpu.data.loader import BatchLoader as JaxBatchLoader
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu.text.vocab import Word2vec as JaxWord2vec
from umpr_tpu.train import checkpoint as jckpt
from umpr_tpu.train.optim import _no_bias_mask, merge_params, split_frozen
from umpr_tpu.train.optim import make_optimizer as jax_make_optimizer
from umpr_tpu.train.step import make_train_step
from umpr_tpu.train import trainer as jax_trainer_module
from umpr_tpu.train.trainer import Trainer as JaxTrainer
from umpr_tpu.utils.logging import get_logger as jax_get_logger
from umpr_tpu_torch import main as port_main
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.data.loader import BatchLoader, to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims, masked_sq_sum
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.optim import make_optimizer, param_groups
from umpr_tpu_torch.train.step import train_step
from umpr_tpu_torch.train.trainer import Trainer
from umpr_tpu_torch.utils.logging import get_logger

VOCAB, EMB = 40, 16


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_and_port_models(seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((VOCAB, EMB)).astype(np.float32)
    jdims = JaxDims(review_net_only=True, use_pallas=True, gru_size=64,
                    self_atte_size=16)
    jparams = jax.tree.map(np.asarray,
                           init_umpr(jax.random.PRNGKey(seed), jdims, emb))
    model = UMPR(ModelDims(gru_size=64, self_atte_size=16), emb)
    model.load_state_dict(params_from_jax(jparams))
    return jparams, jdims, model


@pytest.mark.parametrize("dead", [0, 1])
def test_train_step_matches_jax_make_train_step(dead):
    jparams, jdims, model = _jax_and_port_models(seed=3)
    batch = random_batch(np.random.default_rng(11), B=2, S=3, L=7, S_ui=2,
                         vocab=VOCAB, emb=EMB, max_len=7)
    if dead:
        batch = _kill_rows(batch, dead)
    l2, lr = 1e-3, 1e-3

    tx = jax_make_optimizer(l2)
    trainable, frozen = split_frozen(jparams)
    step = make_train_step(jdims, tx, donate=False)
    jtrained, _, jloss, jaux = step(
        trainable, frozen, tx.init(trainable),
        {k: jnp.asarray(v) for k, v in batch.items()}, lr, None)

    opt = make_optimizer(model, l2, lr)
    loss, n_real = train_step(model, opt, to_device(batch, "cpu"), lr)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    assert float(n_real) == float(jaux["n_real"]) == 2 - dead

    want = _flat(merge_params(jax.device_get(jtrained), frozen))
    got = _flat(params_to_jax(model.state_dict()))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    moved = _flat(jparams)
    assert any(not np.array_equal(got[k], moved[k]) for k in got if "gru" in k)


def test_nan_prediction_on_a_dead_row_leaves_loss_and_grads_finite():
    pred = torch.tensor([1.5, float("nan"), 2.0], requires_grad=True)
    labels = torch.tensor([1.0, 3.0, 4.0], requires_grad=True)
    mask = torch.tensor([1.0, 0.0, 1.0])
    loss = masked_sq_sum(pred, labels, mask) / mask.sum()
    loss.backward()
    assert torch.isfinite(loss) and loss.item() == pytest.approx((0.25 + 4.0) / 2)
    assert torch.isfinite(pred.grad).all() and torch.isfinite(labels.grad).all()
    assert pred.grad[1] == 0 and labels.grad[1] == 0
    # the select after the square is NaN-free forward, not backward
    p2 = pred.detach().requires_grad_()
    torch.where(mask > 0, (p2 - labels.detach()) ** 2, 0.0).sum().backward()
    assert torch.isnan(p2.grad[1])


@pytest.mark.parametrize("seed", [0, 7])
def test_shuffled_order_equals_jax_loader(seed):
    ds = small_dataset(n=11)
    for start in (0, 1):
        ours = list(BatchLoader(ds, 4, shuffle=True, seed=seed, start_batch=start))
        theirs = list(JaxBatchLoader(ds, 4, shuffle=True, seed=seed,
                                     ignore_photos=True, start_batch=start))
        assert len(ours) == len(theirs) == 3 - start
        for a, b in zip(ours, theirs):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    first = np.concatenate([b["ratings"] for b in BatchLoader(ds, 4, shuffle=True,
                                                               seed=seed)])
    assert not np.array_equal(first[:11], ds.ratings)  # it did shuffle


def test_weight_decay_set_equals_jax_no_bias_mask():
    jparams, _, model = _jax_and_port_models(seed=1)
    decay, no_decay = param_groups(model, 1e-3)
    assert decay["weight_decay"] == 1e-3 and no_decay["weight_decay"] == 0.0
    def keys(group):
        ids = {id(p) for p in group["params"]}
        return set(_flat(params_to_jax({n: p for n, p in model.named_parameters()
                                        if id(p) in ids})))

    got, got_no = keys(decay), keys(no_decay)
    trainable, _ = split_frozen(jparams)
    mask = _flat(_no_bias_mask(trainable))
    assert got == {k for k, v in mask.items() if v}
    assert got_no == {k for k, v in mask.items() if not v}
    n_params = len(list(model.parameters()))
    assert n_params == len(decay["params"]) + len(no_decay["params"]) + 1
    assert not model.embedding.weight.requires_grad  # frozen, in no group


def _splits(tmp_path):
    glove = write_splits(tmp_path, seed=2, shards=5, users=6, items=6,
                         per_user=4, vocab=300, dim=EMB)
    return str(glove)


SHAPE = ["--batch_size", "8", "--max_sent_count", "6", "--max_sent_length",
         "10", "--max_ui_sent_count", "2", "--min_sent_count", "3",
         "--gru_size", "64", "--self_atte_size", "16"]
RUN = ["--device", "cpu", "--review_net_only", "True", "--train_epochs", "2",
       "--eval_every", "2", "--learning_rate", "1e-3", "--seed", "4"]


def _events(path):
    return [json.loads(line) for line in open(path)]


def test_fit_and_test_match_jax_trainer(tmp_path):
    glove = _splits(tmp_path)
    data = {s: str(tmp_path / f"{s}.csv") for s in ("train", "valid", "test")}
    photos = (str(tmp_path / "photos.json"), str(tmp_path / "photos"))

    jcfg = JaxConfig(argv=RUN + SHAPE + [
        "--use_pallas", "False", "--multi_gpu", "False", "--device_dataset", "off",
        "--async_checkpoint", "False", "--metrics_jsonl", str(tmp_path / "jax.jsonl")])
    jw = JaxWord2vec(glove)
    jtrainer = JaxTrainer(jcfg, jax_get_logger(logger_name="jax-fit"), jw)
    init = jax.device_get(jtrainer._checkpoint_params())  # before fit moves it
    jds = {s: jax_build_dataset(p, *photos, jw, jcfg) for s, p in data.items()}
    jtrainer.fit(jds["train"], jds["valid"], str(tmp_path / "jax_model"))
    jtest = jtrainer.test(jds["test"], str(tmp_path / "jax_model"))

    cfg = Config(RUN + SHAPE + ["--metrics_jsonl", str(tmp_path / "port.jsonl")])
    w2v = Word2vec(glove)
    trainer = Trainer(cfg, get_logger(logger_name="port-fit"), w2v)
    trainer.model.load_state_dict(params_from_jax(init))
    ds = {s: build_dataset(p, *photos, w2v, cfg) for s, p in data.items()}
    model_dir = str(tmp_path / "port_model")
    trainer.fit(ds["train"], ds["valid"], model_dir)
    test_mse = trainer.test(ds["test"], model_dir)

    assert trainer.batch_counter == jtrainer.batch_counter >= 8
    ours, theirs = _events(tmp_path / "port.jsonl"), _events(tmp_path / "jax.jsonl")
    pick = lambda ev, key: [e[key] for e in ev if key in e]
    assert [e["event"] for e in ours] == [e["event"] for e in theirs]
    assert pick(ours, "batch") == pick(theirs, "batch")
    for key in ("valid_mse", "train_loss", "test_mse"):
        np.testing.assert_allclose(pick(ours, key), pick(theirs, key),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(test_mse, jtest, rtol=1e-4, atol=1e-4)
    assert len(pick(ours, "valid_mse")) > 2  # eval points were reached

    # best/ is in the JAX package's format
    restored = jckpt.restore_best(model_dir, init)
    best = UMPR(ModelDims.from_config(cfg), w2v.embedding)
    ckpt.restore_best(model_dir, best)
    got = _flat(params_to_jax(best.state_dict()))
    for k, v in _flat(restored).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_main_cli_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main.main(["--review_net_only", "True", "--data_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # nothing was trained or written


def test_main_cli_trains_tests_and_reloads(tmp_path):
    glove = _splits(tmp_path)
    model_dir = tmp_path / "run"
    argv = RUN + SHAPE + ["--data_dir", str(tmp_path), "--word2vec_file", glove,
                          "--model_path", str(model_dir),
                          "--log_path", str(tmp_path / "log" / "train.txt"),
                          "--metrics_jsonl", str(tmp_path / "m.jsonl")]
    trainer = port_main.main(argv)
    assert trainer.batch_counter >= 8
    assert (model_dir / "best" / "arrays.npz").exists()
    meta = json.load(open(model_dir / "last" / "meta.json"))  # the final epoch saves
    assert meta == {"epoch": 2, "batch_counter": trainer.batch_counter,
                    "best_loss": trainer.best_loss, "batch_in_epoch": 0}
    log = (tmp_path / "log" / "train.txt").read_text()
    for line in ("Initial validation mse is", "Epoch   1 done; train loss",
                 "End of training!", "Test end, test mse is"):
        assert line in log, line
    test_mse = _events(tmp_path / "m.jsonl")[-1]["test_mse"]
    assert np.isfinite(test_mse)

    port_main.main(argv + ["--test_only", "True"])
    again = _events(tmp_path / "m.jsonl")[-1]
    assert again["event"] == "test" and again["test_mse"] == test_mse


def _write_photos(root):
    """A JPEG for every photo that photos.json names."""
    import cv2
    rng = np.random.default_rng(0)
    (root / "photos").mkdir()
    for line in open(root / "photos.json"):
        pid = json.loads(line)["photo_id"]
        img = rng.integers(0, 256, (48, 56, 3)).astype(np.uint8)
        assert cv2.imwrite(str(root / "photos" / f"{pid}.jpg"), img)


FULL = ["--device", "cpu", "--review_net_only", "False", "--photo_size", "64",
        "--kernel_count", "8", "--train_epochs", "1", "--eval_every", "4",
        "--learning_rate", "1e-3", "--seed", "1"]


def test_full_umpr_cli_trains_tests_reloads_and_starts_at_the_jax_valid_mse(
        tmp_path, monkeypatch):
    glove = _splits(tmp_path)
    _write_photos(tmp_path)
    model_dir = tmp_path / "run"
    argv = FULL + SHAPE + ["--vgg_fused_pool", "True", "--data_workers", "2",
                           "--data_dir", str(tmp_path), "--word2vec_file", glove,
                           "--model_path", str(model_dir),
                           "--log_path", str(tmp_path / "train.txt"),
                           "--metrics_jsonl", str(tmp_path / "m.jsonl")]
    trainer = port_main.main(argv)
    assert trainer.batch_counter >= 4 and trainer.photo_cache.hits > 0
    assert (model_dir / "best" / "arrays.npz").exists()
    events = _events(tmp_path / "m.jsonl")
    values = [e[k] for e in events for k in ("valid_mse", "train_loss", "test_mse")
              if k in e]
    assert len(values) >= 4 and all(v is not None and np.isfinite(v) for v in values)
    port_main.main(argv + ["--test_only", "True"])
    again = _events(tmp_path / "m.jsonl")[-1]
    assert again["event"] == "test" and again["test_mse"] == events[-1]["test_mse"]

    # the initial validation MSE against the JAX Trainer on the same weights
    # (its own init replaced by the port's) and the same decoded photos
    cfg = trainer.config
    w2v = Word2vec(glove)
    init = UMPR(ModelDims.from_config(cfg), w2v.embedding,
                torch.Generator().manual_seed(cfg.seed))
    monkeypatch.setattr(jax_trainer_module, "init_umpr",
                        lambda key, dims, emb: params_to_jax(init.state_dict()))
    jcfg = JaxConfig(argv=FULL + SHAPE + [
        "--use_pallas", "False", "--multi_gpu", "False", "--device_dataset", "off",
        "--async_checkpoint", "False"])
    jw = JaxWord2vec(glove)
    jtrainer = JaxTrainer(jcfg, jax_get_logger(logger_name="jax-full"), jw)
    photos = (str(tmp_path / "photos.json"), str(tmp_path / "photos"))
    jvalid = jax_build_dataset(str(tmp_path / "valid.csv"), *photos, jw, jcfg)
    jmse = jtrainer._evaluate(jtrainer._loader(jvalid))
    np.testing.assert_allclose(events[0]["valid_mse"], jmse, rtol=1e-4, atol=1e-4)
    zero_mse = float(np.mean(jvalid.ratings ** 2))  # a head clamped to 0
    assert abs(jmse - zero_mse) > 1e-2
