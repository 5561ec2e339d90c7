"""``--steps_per_dispatch k`` in the port on the CPU, where a chunk of k
steps is a plain loop of single steps (on a card, one CUDA graph replay):

- k = 4 gives k = 1's bits: parameters, Adam's state, the logged losses
  and validation MSEs, and test()'s MSE (UMPR-R);
- k = 4 against the JAX Trainer at k = 4, at the tolerance of
  tests/test_e2e_train.py's multi-step test (rtol 1e-5, atol 1e-6), at a
  learning rate of 1e-4 (see the test);
- a run saved every 2 batches at k = 2, stopped and resumed, ends with the
  uninterrupted run's bits;
- a full-UMPR Predictor at k = 4 gives k = 1's predictions over requests
  with remainder batches and a photo bank that grows between them;
- the card's graph path (static buffers, dropout masks drawn before each
  replay, the graphs' outputs copied, a graph per evaluated model),
  replayed eagerly by a stand-in for the CUDA graph, gives k = 1's bits
  too, for full UMPR (32 px, dropout: chunk step j takes step j's masks)
  in training, test() and serving;
- chunk_stream's chunks and remainders, and the guards: eval_every must be
  a multiple of k, and grad_accum_steps excludes it.

The CPU's thread count is fixed, so that oneDNN's reductions keep one
order."""

import logging

import jax
import numpy as np
import pytest
import torch

from tests.test_device_dataset import packed_dataset
from tests.test_torch_resume import _with_photos
from tests.test_torch_serve_full import EMBEDDING, FLAGS as SERVE_FLAGS
from tests.test_torch_serve_full import FakeW2v, _request
from tests.test_torch_train_flags import _W2v
from umpr_tpu.config import Config as JaxConfig
from umpr_tpu.train.trainer import Trainer as JaxTrainer
from umpr_tpu.utils.logging import get_logger as jax_get_logger
from umpr_tpu_torch import serve
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import adam_to_jax, params_from_jax, params_to_jax
from umpr_tpu_torch.data.loader import chunk_stream
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.train import checkpoint as ckpt
from umpr_tpu_torch.train import step
from umpr_tpu_torch.train.trainer import Trainer
from tests.test_torch_train import _events


@pytest.fixture(autouse=True)
def fixed_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


BASE = ["--device", "cpu", "--batch_size", "8", "--train_epochs", "1", "--eval_every", "4",
        "--learning_rate", "0.01", "--min_sent_count", "1", "--seed", "2"]
FULL = ["--review_net_only", "False", "--photo_size", "32", "--kernel_count", "8",
        "--vgg_fused_pool", "True"]


def _run(tmp_path, name, flags, train, valid, stop=0):
    cfg = Config(BASE + flags + ["--metrics_jsonl", str(tmp_path / f"{name}.jsonl")])
    trainer = Trainer(cfg, logging.getLogger(f"dispatch-{name}"), _W2v())
    trainer.fit(train, valid, str(tmp_path / name), _stop_after_batches=stop)
    return trainer


def _state_equal(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for x, y in zip(adam_to_jax(a.model, a.opt), adam_to_jax(b.model, b.opt)):
        fx, fy = (dict(ckpt.leaves_with_path(t)) if isinstance(t, dict) else {(): t}
                  for t in (x, y))
        for k in fx:
            np.testing.assert_array_equal(fx[k], fy[k], err_msg=str(k))


def _values(path):
    return [{k: v for k, v in e.items() if k not in ("ts", "elapsed_s")}
            for e in _events(path)]


def test_four_steps_per_dispatch_equal_single_steps_bit_for_bit(tmp_path):
    # 9 batches: two chunks of 4 and a remainder; valid and test 3 batches
    train, valid = packed_dataset(72, seed=0), packed_dataset(24, seed=1)
    test = packed_dataset(24, seed=3)
    flags = ["--review_net_only", "True"]
    one = _run(tmp_path, "k1", flags, train, valid)
    four = _run(tmp_path, "k4", flags + ["--steps_per_dispatch", "4"], train, valid)
    assert one.batch_counter == four.batch_counter == 9
    _state_equal(one, four)
    events = _values(tmp_path / "k1.jsonl")
    assert events == _values(tmp_path / "k4.jsonl")
    assert sum("train_loss" in e for e in events) >= 2
    assert one.test(test, str(tmp_path / "k1")) == four.test(test, str(tmp_path / "k4"))


def test_four_steps_per_dispatch_match_the_jax_trainer(tmp_path):
    # lr 1e-4 (the reference's default is 1e-6): Adam's normalisation turns
    # the packages' different f32 rounding of a near-zero gradient into an
    # update difference of up to lr.  Over these 9 steps that drift is the
    # same at k = 1 as at k = 4; it leaves 1 element past the tolerance at
    # lr 1e-3 (1.35x) and 813 at 1e-2, and at 1e-4 the worst is 0.13x.
    flags = BASE + ["--review_net_only", "True", "--steps_per_dispatch", "4",
                    "--learning_rate", "1e-4"]
    train, valid = packed_dataset(72, seed=0), packed_dataset(24, seed=1)
    jcfg = JaxConfig(argv=flags + ["--multi_gpu", "False", "--device_dataset", "off",
                                   "--use_pallas", "False", "--async_checkpoint", "False"])
    jtrainer = JaxTrainer(jcfg, jax_get_logger(logger_name="jax-k4"), _W2v())
    init = jax.device_get(jtrainer._checkpoint_params())
    jtrainer.fit(train, valid, str(tmp_path / "jax"))

    trainer = Trainer(Config(flags), logging.getLogger("port-k4"), _W2v())
    trainer.model.load_state_dict(params_from_jax(init))
    trainer.fit(train, valid, str(tmp_path / "port"))
    assert trainer.batch_counter == jtrainer.batch_counter == 9
    got = dict(ckpt.leaves_with_path(params_to_jax(trainer.model.state_dict())))
    want = dict(ckpt.leaves_with_path(jax.device_get(jtrainer._checkpoint_params())))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=str(k))


def test_chunked_run_resumes_bit_for_bit(tmp_path):
    flags = ["--review_net_only", "True", "--train_epochs", "2", "--steps_per_dispatch", "2",
             "--save_every_batches", "2"]
    train, valid = packed_dataset(48, seed=0), packed_dataset(8, seed=1)
    whole = _run(tmp_path, "whole", flags, train, valid)
    _run(tmp_path, "cut", flags, train, valid, stop=3)  # two chunks: saved at 2 and 4
    resumed = _run(tmp_path, "resumed", flags + ["--resume_path", str(tmp_path / "cut")],
                   train, valid)
    assert whole.batch_counter == resumed.batch_counter == 12
    _state_equal(whole, resumed)


def _predictor(root, k):
    return serve.Predictor(Config(SERVE_FLAGS + ["--steps_per_dispatch", str(k)]),
                           FakeW2v(EMBEDDING), root)


def test_predictor_k4_equals_k1_with_remainders_and_a_growing_bank(tmp_path):
    root = str(tmp_path / "model")
    cfg = Config(SERVE_FLAGS)
    ckpt.save_best(root, UMPR(ModelDims.from_config(cfg), EMBEDDING,
                              torch.Generator().manual_seed(2)))
    one, four = _predictor(root, 1), _predictor(root, 4)
    # 45 samples: a chunk of 4 batches and a remainder of 2; then new photos
    for ds in (_request(tmp_path, 45, 3, range(4)), _request(tmp_path, 21, 9, range(3, 9))):
        held = four._bank.shape[0]
        a, rows_a = one.predict_dataset(ds)
        b, rows_b = four.predict_dataset(ds)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(rows_a, rows_b)
    assert four._bank_enabled and four._bank.shape[0] > held  # the bank grew


class EagerGraph:
    """DispatchGraph's protocol with fn run again at every replay, where a
    CUDA graph replays its capture: the same static buffers and warm-up."""

    def __init__(self, fn, inputs, warmup=None):
        self.static = {k: v.clone() for k, v in inputs.items()}
        (warmup or fn)(self.static)
        self.fn, self.replays = fn, 0

    def replay(self, inputs):
        for key, v in inputs.items():
            self.static[key].copy_(v)
        self.replays += 1
        return self.fn(self.static)


def test_graph_path_replayed_eagerly_equals_single_steps(tmp_path, monkeypatch):
    train, valid, test = (_with_photos(packed_dataset(n, seed=s), tmp_path)
                          for n, s in ((32, 0), (16, 1), (16, 3)))
    one = _run(tmp_path, "k1", FULL, train, valid)
    monkeypatch.setattr(step, "graphed", lambda t: True)
    monkeypatch.setattr(step, "DispatchGraph", EagerGraph)
    two = _run(tmp_path, "k2", FULL + ["--steps_per_dispatch", "2"], train, valid)
    assert two.multi_train_step.graph.replays == 2
    _state_equal(one, two)
    assert _values(tmp_path / "k1.jsonl") == _values(tmp_path / "k2.jsonl")
    assert one.test(test, str(tmp_path / "k1")) == two.test(test, str(tmp_path / "k2"))
    assert len(two.multi_eval_step.graphs) == 2  # the training model's, test()'s

    root = str(tmp_path / "k1")
    ds = _request(tmp_path, 37, 3, range(4))  # a chunk of 4 and a remainder
    np.testing.assert_array_equal(_predictor(root, 4).predict_dataset(ds)[0],
                                  _predictor(root, 1).predict_dataset(ds)[0])


def test_chunk_stream_stacks_chunks_and_ships_remainders_alone():
    batches = [{"x": np.full((2,), i)} for i in range(7)]
    out = list(chunk_stream(batches, 3, lambda s: ("chunk", s["x"].shape),
                            lambda b: ("single", b["x"].shape), extract=lambda b: int(b["x"][0])))
    assert out == [(("chunk", (3, 2)), [0, 1, 2], True), (("chunk", (3, 2)), [3, 4, 5], True),
                   (("single", (2,)), [6], False)]


def test_eval_every_must_be_a_multiple_of_steps_per_dispatch():
    with pytest.raises(ValueError, match="divide --eval_every"):
        Trainer(Config(BASE + ["--review_net_only", "True", "--steps_per_dispatch", "3"]),
                logging.getLogger("guard"), _W2v())
    with pytest.raises(ValueError, match="mutually exclusive"):
        Config(BASE + ["--steps_per_dispatch", "2", "--grad_accum_steps", "2"])
