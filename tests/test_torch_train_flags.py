"""The training flags the port took over from the JAX package, on the CPU:

- the port's Adam (train/optim.py) against ``umpr_tpu.train.optim.
  make_optimizer`` on the same gradients, 5 steps, in its four modes
  (float32 moments; bfloat16 mu; factored nu; both), over a Linear
  kernel, a conv kernel, a GRU weight, a 2-D plain parameter, an (in, 1)
  head and a bias: parameters within 1e-5 (PARITY.md's one-Adam-step
  tolerance), a bf16 mu within one bf16 ulp, factored (row, col) within
  1e-6 relative, each nu leaf at its optax key;
- ``last/`` with bf16 mu or factored nu across packages, both ways: the
  dtype record, the ``.nu[i][j]`` keys, and the values;
- ``--rnet_pretrained``: the R-Net equals a JAX-written subtree; a bad
  path logs the failure and training goes on;
- ``--profile_dir``: a Chrome trace at k = 1 and at k = 6 (eval_every 6,
  as tests/test_e2e_train.py's profile test).

The CPU's thread count is fixed, so that oneDNN's reductions keep one
order."""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_device_dataset import EMB, VOCAB, packed_dataset
from umpr_tpu.config import Config as JaxConfig
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu.train import checkpoint as jckpt
from umpr_tpu.train.optim import make_optimizer as jax_make_optimizer
from umpr_tpu.train.optim import split_frozen
from umpr_tpu.train.trainer import Trainer as JaxTrainer
from umpr_tpu.utils.logging import get_logger as jax_get_logger
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import adam_to_jax, params_from_jax, params_to_jax
from umpr_tpu_torch.ops.gru import BiGRU
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train.optim import make_optimizer
from umpr_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True)
def fixed_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


class _Net(nn.Module):
    """One parameter of each layout the factoring has to get right."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc = nn.Linear(6, 5)             # kernel (in, out) = (6, 5)
        self.conv = nn.Conv2d(3, 4, 3)        # kernel HWIO (3, 3, 3, 4)
        self.gru = BiGRU(4, 3, generator=g)   # w_ih (4, 9), w_hh (3, 9)
        self.head = nn.Linear(5, 1)           # (5, 1): not factored
        self.M = nn.Parameter(torch.randn(3, 7, generator=g))


MODES = [("float32", False), ("bfloat16", False), ("float32", True), ("bfloat16", True)]


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bf16_ulp(x):
    x = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("moment_dtype,factored", MODES)
def test_adam_matches_optax_for_five_steps(moment_dtype, factored):
    net = _Net()
    l2, lr = 1e-2, 1e-2
    opt = make_optimizer(net, l2, lr, moment_dtype, factored)
    # copies: a numpy view of a CPU parameter would follow its in-place steps
    params = jax.tree.map(lambda a: jnp.asarray(np.array(a)), params_to_jax(net.state_dict()))
    tx = jax_make_optimizer(l2, moment_dtype, factored)
    state = tx.init(params)
    rng = np.random.default_rng(4)
    for _ in range(5):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                             params)
        for name, g in params_from_jax(grads).items():
            dict(net.named_parameters())[name].grad = g
        opt.step()
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = jax.tree.map(lambda p, u: p - lr * u, params, updates)

    got, want = _flat(params_to_jax(net.state_dict())), _flat(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    count, mu, nu = adam_to_jax(net, opt)
    assert count == int(state[1].count) == 5
    gmu, wmu = _flat(mu), _flat(state[1].mu)
    for k in wmu:
        if moment_dtype == "bfloat16":
            assert state[1].mu is not None and str(jax.tree.leaves(state[1].mu)[0].dtype) \
                == "bfloat16"
            assert (np.abs(gmu[k] - wmu[k]) <= _bf16_ulp(wmu[k])).all(), k
        else:
            np.testing.assert_allclose(gmu[k], wmu[k], rtol=1e-5, atol=1e-6, err_msg=k)
    gnu, wnu = _flat(nu), _flat(state[1].nu)
    assert gnu.keys() == wnu.keys()
    if factored:
        # the Linear, conv, GRU and plain 2-D leaves factor; the head and
        # the biases keep a full nu
        pairs = [leaf for leaf in state[1].nu if len(leaf) == 2]
        assert len(pairs) == 7 and len(state[1].nu) == 15
        assert [[tuple(x.shape) for x in leaf] for leaf in state[1].nu[:3]] == [
            [(3,), (7,)], [(4,)], [(3, 3, 3), (4,)]]  # M, conv bias, conv kernel
    for k in wnu:
        np.testing.assert_allclose(gnu[k], wnu[k], rtol=1e-6 if factored else 1e-5,
                                   atol=1e-12, err_msg=k)


BASE = ["--device", "cpu", "--batch_size", "8", "--train_epochs", "1", "--eval_every", "4",
        "--learning_rate", "0.01", "--min_sent_count", "1", "--seed", "2",
        "--review_net_only", "True", "--save_every_batches", "2"]


class _W2v:
    embedding = np.random.default_rng(1).standard_normal((VOCAB, EMB)).astype(np.float32)


def _adam_flags(moment_dtype, factored):
    return ["--adam_moment_dtype", moment_dtype, "--adam_factored_nu", str(factored)]


def _on_disk(root):
    meta = json.load(open(os.path.join(root, "last", "structure.json")))
    with np.load(os.path.join(root, "last", "arrays.npz")) as z:
        arrays = {k: z[f"leaf_{i:05d}"] for i, k in enumerate(meta["keys"])}
    return arrays, dict(zip(meta["keys"], meta["dtypes"]))


def _check_record(dtypes, moment_dtype, factored):
    mu = [d for k, d in dtypes.items() if ".mu[" in k]
    assert mu and set(mu) == {moment_dtype}
    nu_keys = [k for k in dtypes if ".nu[" in k]
    if factored:
        assert "['opt_state'][1].nu[0][0]" in nu_keys
        assert any(k.endswith("][1]") for k in nu_keys)  # a (row, col) pair
    else:
        assert "['opt_state'][1].nu['linear_fusion']['kernel']" in nu_keys


@pytest.mark.parametrize("moment_dtype,factored", [("bfloat16", False), ("float32", True)])
def test_jax_written_last_resumes_in_port(moment_dtype, factored, tmp_path):
    flags = BASE + _adam_flags(moment_dtype, factored)
    train, valid = packed_dataset(40, seed=0), packed_dataset(8, seed=1)
    jcfg = JaxConfig(argv=flags + ["--multi_gpu", "False", "--device_dataset", "off",
                                   "--async_checkpoint", "False"])
    JaxTrainer(jcfg, jax_get_logger(logger_name="jax-last"), _W2v()).fit(
        train, valid, str(tmp_path), _stop_after_batches=3)
    arrays, dtypes = _on_disk(tmp_path)
    _check_record(dtypes, moment_dtype, factored)

    trainer = Trainer(Config(flags + ["--resume_path", str(tmp_path)]),
                      logging.getLogger("port-from-jax-last"), _W2v())
    assert trainer.batch_counter == 2
    count, mu, nu = adam_to_jax(trainer.model, trainer.opt)
    assert count == 2 and trainer.opt.count.dtype == torch.int32
    for field, tree in (("mu", mu), ("nu", nu)):
        got = {f"['opt_state'][1].{field}" + ckpt.keystr(p): a
               for p, a in ckpt.leaves_with_path(tree)}
        assert got.keys() == {k for k in arrays if f"].{field}[" in k}
        for k, a in got.items():
            np.testing.assert_array_equal(a, arrays[k], err_msg=k)
    if moment_dtype == "bfloat16":
        assert all(trainer.opt.state[p]["exp_avg"].dtype == torch.bfloat16
                   for p in trainer.opt.params)
    trainer.fit(train, valid, str(tmp_path))  # and it trains on
    assert trainer.batch_counter == 5


@pytest.mark.parametrize("moment_dtype,factored", [("bfloat16", False), ("float32", True)])
def test_port_written_last_restores_in_jax(moment_dtype, factored, tmp_path):
    flags = BASE + _adam_flags(moment_dtype, factored)
    trainer = Trainer(Config(flags), logging.getLogger("port-last-flags"), _W2v())
    trainer.fit(packed_dataset(40, seed=0), packed_dataset(8, seed=1), str(tmp_path),
                _stop_after_batches=2)
    arrays, dtypes = _on_disk(tmp_path)
    _check_record(dtypes, moment_dtype, factored)

    jcfg = JaxConfig(argv=flags + ["--multi_gpu", "False", "--device_dataset", "off"])
    params = init_umpr(jax.random.PRNGKey(0), JaxDims.from_config(jcfg), _W2v.embedding)
    like, _ = split_frozen(params)
    tx = jax_make_optimizer(1e-3, moment_dtype, factored)
    jtrainable, jstate, _ = jckpt.restore_last(str(tmp_path), like, tx.init(like))
    assert int(jstate[1].count) == 2
    assert {str(x.dtype) for x in jax.tree.leaves(jstate[1].mu)} == {moment_dtype}
    restored = {"['opt_state']" + jax.tree_util.keystr(p): np.asarray(v, np.float32)
                for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    restored.update({"['trainable']" + jax.tree_util.keystr(p): np.asarray(v)
                     for p, v in jax.tree_util.tree_flatten_with_path(jtrainable)[0]})
    assert restored.keys() == arrays.keys()
    for k in restored:
        np.testing.assert_array_equal(restored[k], arrays[k], err_msg=k)


def test_rnet_pretrained_is_loaded_or_the_failure_logged(tmp_path, caplog):
    cfg = JaxConfig(argv=BASE + ["--multi_gpu", "False"])
    params = init_umpr(jax.random.PRNGKey(7), JaxDims.from_config(cfg), _W2v.embedding)
    rnet = jax.tree.map(np.asarray, params["review_net"]["rnet"])
    jckpt.save_pytree(str(tmp_path / "rnet"), rnet)  # as umpr_tpu/pretrain/rnet.py saves it

    with caplog.at_level(logging.INFO, logger="rnet-ok"):
        trainer = Trainer(Config(BASE + ["--rnet_pretrained", str(tmp_path / "rnet")]),
                          logging.getLogger("rnet-ok"), _W2v())
    assert f'Loaded R-Net pre-trained weights from "{tmp_path / "rnet"}"' in caplog.text
    got = trainer.model.review_net.rnet.state_dict()
    want = params_from_jax(rnet)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k

    bad = str(tmp_path / "nowhere")
    with caplog.at_level(logging.INFO, logger="rnet-bad"):
        trainer = Trainer(Config(BASE + ["--rnet_pretrained", bad]),
                          logging.getLogger("rnet-bad"), _W2v())
    assert f'Failed to load R-Net pre-trained weights from "{bad}"' in caplog.text
    trainer.fit(packed_dataset(16, seed=0), packed_dataset(8, seed=1), str(tmp_path / "run"))
    assert trainer.batch_counter == 2  # training went on


@pytest.mark.parametrize("k", [1, 6])
def test_profile_dir_writes_a_chrome_trace(k, tmp_path):
    profile_dir = tmp_path / "trace"
    cfg = Config(["--device", "cpu", "--review_net_only", "True", "--batch_size", "8",
                  "--train_epochs", "1", "--eval_every", "6", "--learning_rate", "0.01",
                  "--min_sent_count", "1", "--seed", "2", "--steps_per_dispatch", str(k),
                  "--profile_dir", str(profile_dir)])
    trainer = Trainer(cfg, logging.getLogger(f"profile-{k}"), _W2v())
    trainer.fit(packed_dataset(96, seed=0), packed_dataset(8, seed=1), str(tmp_path / "m"))
    assert trainer.batch_counter == 12
    traces = [f for f in os.listdir(profile_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1, traces
    events = json.load(open(profile_dir / traces[0]))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
