"""The device-resident training corpus (``--device_dataset auto|on``) in the
port on the CPU:

- ``Trainer._index_stream`` follows ``BatchLoader``'s order, start batch
  and chunking for k = 1 and 3, and pads evaluation's last chunk with
  all-dead batches;
- ``step.gather_batch`` gives the loader's batch field for field
  (``torch.equal``, dead rows included), photos from the bank, each
  distinct photo decoded once;
- a resident ``fit`` gives a streaming one's bits (parameters, Adam's
  state, ``--metrics_jsonl`` values, ``best/``): UMPR-R at k = 1 and 2,
  full UMPR with the bank at k = 1;
- the resident train and eval steps against ``make_train_step_resident`` /
  ``make_eval_step_resident`` on the same weights and rows (1e-5);
- the ``auto`` / ``on`` gate, and ``on`` not honoured under
  ``--grad_accum_steps 2`` (logged);
- a second ``fit`` uploads its own datasets and bank and drops every graph
  captured over the first's (the card's graph path, replayed eagerly);
- an all-dead evaluation batch adds (0, 0);
- a mid-epoch resume in resident mode ends with the uninterrupted run's
  bits, and the progress totals count its dispatches.

The CPU's thread count is fixed, so that oneDNN's reductions keep one
order."""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import after_resume
from tests.test_device_dataset import packed_dataset
from tests.test_torch_dispatch import EagerGraph, _values
from tests.test_torch_resume import _with_photos
from tests.test_torch_train import _events
from tests.test_torch_train_flags import _W2v
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu.train.optim import make_optimizer as jax_make_optimizer
from umpr_tpu.train.optim import merge_params, split_frozen
from umpr_tpu.train.step import make_eval_step_resident, make_train_step_resident
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_from_jax, params_to_jax
from umpr_tpu_torch.data.loader import BatchLoader, to_device
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.train import step
from umpr_tpu_torch.train import trainer as trainer_module
from umpr_tpu_torch.train.optim import make_optimizer
from umpr_tpu_torch.train.step import RESIDENT_FIELDS, eval_step, gather_batch, train_step
from umpr_tpu_torch.train.trainer import Trainer, dispatch_items


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
UMPR_R = ["--review_net_only", "True"]
FULL = ["--review_net_only", "False", "--photo_size", "32", "--kernel_count", "8",
        "--vgg_fused_pool", "True"]


def _trainer(tmp_path, name, *flags):
    metrics = ["--metrics_jsonl", str(tmp_path / f"{name}.jsonl")] if tmp_path else []
    return Trainer(Config(BASE + list(flags) + metrics), logging.getLogger(f"devds-{name}"),
                   _W2v())


def _state_equal(a, b):
    """Two Trainers' parameters and Adam state (f32 moments), bit for bit."""
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert torch.equal(a.opt.count, b.opt.count)
    for p, q in zip(a.opt.params, b.opt.params):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.opt.state[p][key], b.opt.state[q][key]), key


def _rows(items):
    """(idx, n_real) per batch of an index stream."""
    out = []
    for kind, p in items:
        if kind == "chunk":
            out += [(p["idx"][j], int(p["n_real"][j])) for j in range(len(p["idx"]))]
        else:
            out.append((p["idx"], int(p["n_real"])))
    return out


@pytest.mark.parametrize("k,start,shuffle", [(1, 0, True), (3, 2, True), (3, 0, False)])
def test_index_stream_follows_the_loader_order(k, start, shuffle):
    ds = packed_dataset(52)  # 7 batches of 8, the last of 4 rows
    t = _trainer(None, f"order{k}", *UMPR_R, "--steps_per_dispatch", str(k),
                 "--eval_every", str(3 * k))
    items = list(t._index_stream(len(ds), 7, start, shuffle=shuffle))
    n = 7 - start
    assert [kind for kind, _ in items] == ["chunk"] * (n // k if k > 1 else 0) + \
        ["single"] * (n % k if k > 1 else n)
    batches = list(BatchLoader(ds, 8, shuffle=shuffle, seed=7, start_batch=start))
    rows = _rows(items)
    assert len(rows) == len(batches) == n
    for hb, (idx, n_real) in zip(batches, rows):
        assert idx.dtype == np.int32 and (idx[n_real:] == 0).all()
        np.testing.assert_array_equal(hb["u_tokens"], ds.u_tokens[idx])
        np.testing.assert_array_equal(hb["sample_mask"], np.arange(8) < n_real)


def test_evaluation_pads_its_last_chunk_with_dead_batches():
    t = _trainer(None, "pad", *UMPR_R, "--steps_per_dispatch", "3", "--eval_every", "3")
    items = list(t._index_stream(40, 0, 0, shuffle=False, pad_final_chunk=True))
    assert [kind for kind, _ in items] == ["chunk", "chunk"]  # 5 batches: 3, then 2 + 1 dead
    np.testing.assert_array_equal(items[1][1]["n_real"], [8, 8, 0])
    assert not items[1][1]["idx"][2].any()
    assert dispatch_items(5, 3, pad_final_chunk=True) == len(items)
    assert dispatch_items(4, 3, pad_final_chunk=True) == 2  # a lone rest stays single
    # training never pads: the rest runs as single steps
    assert [kind for kind, _ in t._index_stream(40, 0, 0, shuffle=False)] == \
        ["chunk", "single", "single"]


def test_gather_batch_equals_the_loader_batch_field_for_field(tmp_path, monkeypatch):
    decoded = []
    real = trainer_module.load_photo_batch
    monkeypatch.setattr(trainer_module, "load_photo_batch",
                        lambda paths, *a: decoded.extend(paths.ravel()) or real(paths, *a))
    ds = _with_photos(packed_dataset(20, seed=3), tmp_path)  # 3 batches, the last of 4
    t = _trainer(None, "gather", *FULL, "--data_workers", "2")
    assert t._resident_mode(ds, ds) and t._bank_uniq[0] == ""
    data = t._device_data(ds)
    # every distinct path once ('' and the missing file give zeros)
    assert sorted(decoded) == sorted(set(ds.photo_paths.ravel()) | {""})
    assert data["photo_bank"].dtype == torch.uint8 and not data["photo_bank"][0].any()
    loader = BatchLoader(ds, 8, shuffle=True, seed=3, ignore_photos=False, resize=(32, 32))
    for hb, (idx, n_real) in zip(loader, _rows(t._index_stream(len(ds), 3, 0))):
        want = to_device(hb, "cpu")
        got = gather_batch(data, torch.from_numpy(idx), torch.tensor(n_real, dtype=torch.int32))
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key
    assert n_real == 4


def _files(root, names=("best", "last")):
    return {name: dict(np.load(root / name / "arrays.npz")) for name in names}


@pytest.mark.parametrize("model,k", [("umpr_r", 1), ("umpr_r", 2), ("full", 1)])
def test_resident_fit_equals_streaming_fit_bit_for_bit(model, k, tmp_path):
    flags = (UMPR_R if model == "umpr_r" else FULL) + ["--steps_per_dispatch", str(k)]
    # UMPR-R: 5 batches, the last partial (a chunk, a single and dead rows
    # at k = 2); full UMPR: 2, the last partial
    train, valid = packed_dataset(36, seed=0), packed_dataset(20, seed=1)
    if model == "full":
        train, valid = (_with_photos(packed_dataset(n, seed=s), tmp_path)
                        for n, s in ((12, 0), (8, 1)))
    runs = {}
    for mode in ("off", "on"):
        t = _trainer(tmp_path, mode, *flags, "--device_dataset", mode)
        t.fit(train, valid, str(tmp_path / mode))
        assert t._resident == (mode == "on") and t.batch_counter == -(-len(train) // 8)
        runs[mode] = t
    assert (runs["on"]._bank_uniq is not None) == (model == "full")
    _state_equal(runs["off"], runs["on"])
    assert _values(tmp_path / "off.jsonl") == _values(tmp_path / "on.jsonl")
    # last/ holds the parameters and Adam's state compared above
    a, b = (_files(tmp_path / mode, ("best",))["best"] for mode in runs)
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(a[key], b[key]), key


def test_resident_steps_match_the_jax_resident_steps():
    emb = _W2v.embedding
    # use_pallas=False: the JAX package's plain GRU (its Pallas kernels are
    # held against it in tests/test_gru_pallas.py)
    jdims = JaxDims(review_net_only=True, use_pallas=False, gru_size=64, self_atte_size=16)
    jparams = jax.tree.map(np.asarray, init_umpr(jax.random.PRNGKey(5), jdims, emb))
    model = UMPR(ModelDims(gru_size=64, self_atte_size=16), emb)
    model.load_state_dict(params_from_jax(jparams))
    ds = packed_dataset(12, seed=4)
    # lr 1e-4, as in tests/test_torch_dispatch.py: Adam's first step turns
    # the packages' different f32 rounding of a near-zero gradient into an
    # update difference of up to lr
    idx, n_real, lr, l2 = np.array([3, 7, 1, 10, 0, 0], np.int32), 4, 1e-4, 1e-3
    jdata = {f: jnp.asarray(getattr(ds, f)) for f in RESIDENT_FIELDS}
    data = {f: torch.from_numpy(getattr(ds, f)) for f in RESIDENT_FIELDS}
    rows = (torch.from_numpy(idx), torch.tensor(n_real, dtype=torch.int32))

    trainable, frozen = split_frozen(jparams)
    jsq, jn = make_eval_step_resident(jdims)(trainable, frozen, jdata, jnp.asarray(idx),
                                             jnp.int32(n_real))
    sq, n = eval_step(model, gather_batch(data, *rows))
    assert float(n) == float(jn) == n_real
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-5, atol=1e-5)

    tx = jax_make_optimizer(l2)
    jtrained, _, jloss, jaux = make_train_step_resident(jdims, tx, donate=False)(
        trainable, frozen, tx.init(trainable), jdata, jnp.asarray(idx), jnp.int32(n_real),
        lr, None)
    loss, n = train_step(model, make_optimizer(model, l2, lr), gather_batch(data, *rows), lr)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    assert float(n) == float(jaux["n_real"]) == n_real
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(merge_params(jtrained, frozen))[0]}
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(params_to_jax(model.state_dict()))[0]}
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_auto_and_on_gate_as_the_jax_trainer(caplog):
    train, valid = packed_dataset(20), packed_dataset(8)
    text = sum(getattr(d, f).nbytes for d in (train, valid) for f in RESIDENT_FIELDS)
    t = _trainer(None, "gate", *UMPR_R)
    assert t.config.device_dataset == "auto" and t._resident_mode(train, valid)
    t.config.device_dataset_mb = 0  # the packed text does not fit: auto streams
    assert text > 0 and not t._resident_mode(train, valid)
    t.config.device_dataset = "on"  # on skips the size gate
    assert t._resident_mode(train, valid)
    # full UMPR: a bank of every distinct photo ('' only here, a 1-row bank)
    t.config.review_net_only, t.config.device_dataset = False, "auto"
    assert not t._resident_mode(train, valid)
    t.config.device_dataset_mb = 4096
    assert t._resident_mode(train, valid) and list(t._bank_uniq) == [""]
    t.config.device_dataset = "off"
    assert not t._resident_mode(train, valid) and t._bank_uniq is None

    for mode in ("on", "auto"):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=f"devds-accum-{mode}"):
            t = _trainer(None, f"accum-{mode}", *UMPR_R, "--grad_accum_steps", "2",
                         "--device_dataset", mode)
            assert not t._resident_mode(train, valid)
        assert ("device_dataset=on not honored (grad_accum_steps uses the streaming "
                "micro-batch step); streaming." in caplog.text) == (mode == "on")


def test_second_fit_uploads_its_own_corpus_and_drops_the_first_graphs(tmp_path, monkeypatch):
    monkeypatch.setattr(step, "graphed", lambda t: True)
    monkeypatch.setattr(step, "DispatchGraph", EagerGraph)
    (tmp_path / "a").mkdir(), (tmp_path / "b").mkdir()
    # other photo files in each directory: a stale bank would show
    corpora = [(_with_photos(packed_dataset(16, seed=s), tmp_path / d),
                _with_photos(packed_dataset(16, seed=s + 1), tmp_path / d))
               for s, d in ((3, "a"), (11, "b"))]
    t = _trainer(tmp_path, "refit", *FULL, "--steps_per_dispatch", "2",
                 "--device_dataset", "on", "--photo_cache_mb", "0")
    fits = []
    for i, (train, valid) in enumerate(corpora):
        # one chunk of 2 steps: no epoch end, no checkpoint to write
        t.fit(train, valid, str(tmp_path / f"fit{i}"), _stop_after_batches=2)
        assert t._resident and set(t._dev_data) == {id(train), id(valid)}
        dev_train, dev_valid = (t._dev_data[id(d)][1] for d in (train, valid))
        assert dev_train["photo_bank"] is t._bank
        # the graphs of this fit read this fit's tensors, and only them
        assert t.multi_train_step.graph_data is dev_train
        assert [e[1] is dev_valid for e in t.multi_eval_step.graphs.values()] == [True]
        fits.append((t._bank, t.multi_train_step.graph))
    assert fits[0][0] is not fits[1][0] and fits[0][1] is not fits[1][1]
    assert t.multi_train_step.graph.replays == 1
    # the second fit's batches are its own corpus's, photos included
    loader = BatchLoader(valid, 8, ignore_photos=False, resize=(32, 32))
    for hb, (idx, n_real) in zip(loader, _rows(t._index_stream(len(valid), 0, 0,
                                                               shuffle=False))):
        got = gather_batch(dev_valid, torch.from_numpy(idx), torch.tensor(n_real))
        assert torch.equal(got["photos"], torch.from_numpy(hb["photos"]))
        assert got["photos"].any()


def test_an_all_dead_evaluation_batch_adds_nothing(tmp_path):
    ds = packed_dataset(12, seed=0)
    t = _trainer(None, "dead", *UMPR_R)
    assert t._resident_mode(ds)
    data = t._device_data(ds)
    dead = gather_batch(data, torch.zeros(8, dtype=torch.int32), torch.tensor(0))
    assert not dead["sample_mask"].any() and not dead["u_counts"].any()
    sq, n = eval_step(t.model, dead)
    assert float(sq) == 0.0 and float(n) == 0.0
    # a padded last chunk at k = 3 (2 live batches and a dead one) gives the
    # streaming MSE
    mses = {}
    for mode in ("off", "on"):
        t = _trainer(None, f"dead-{mode}", *UMPR_R, "--steps_per_dispatch", "3",
                     "--eval_every", "3", "--device_dataset", mode)
        t._resident = t._resident_mode(ds)
        if t._resident:
            t._device_data(ds)
        mses[mode] = t._evaluate(t._loader(ds))
    assert np.isfinite(mses["on"]) and mses["on"] == mses["off"]


def test_resident_mid_epoch_resume_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    bars = []

    def recording(it, desc, total):
        bar = [desc, total, 0]
        bars.append(bar)
        for item in it:
            bar[2] += 1
            yield item

    monkeypatch.setattr(trainer_module, "progress", recording)
    flags = [*UMPR_R, "--device_dataset", "on", "--train_epochs", "2", "--steps_per_dispatch",
             "3", "--eval_every", "3", "--save_every_batches", "3"]
    train, valid = packed_dataset(40, seed=0), packed_dataset(40, seed=1)  # 5 batches each
    whole = _trainer(tmp_path, "whole", *flags)
    whole.fit(train, valid, str(tmp_path / "whole"))
    _trainer(tmp_path, "cut", *flags).fit(train, valid, str(tmp_path / "cut"),
                                          _stop_after_batches=3)
    bars.clear()
    resumed = _trainer(tmp_path, "resumed", *flags, "--resume_path", str(tmp_path / "cut"))
    resumed.fit(train, valid, str(tmp_path / "cut"))
    assert whole._resident and resumed._resident
    assert whole.batch_counter == resumed.batch_counter == 10
    _state_equal(whole, resumed)
    a, b = _files(tmp_path / "whole"), _files(tmp_path / "cut")
    for name in a:
        for key in a[name]:
            assert np.array_equal(a[name][key], b[name][key]), (name, key)
    want = after_resume(_events(tmp_path / "whole.jsonl"), 3)
    assert [e["batch"] for e in want] == [5, 8, 9, 10]
    assert after_resume(_events(tmp_path / "resumed.jsonl"), 3) == want
    # epoch 0 from batch 3: 2 singles; epoch 1: a chunk and 2 singles; every
    # evaluation: a chunk and a padded chunk
    train_bars = [(d, t) for d, t, _ in bars if d.startswith("Training")]
    assert train_bars == [("Training epoch 0", 2), ("Training epoch 1", 3)]
    assert all(t == 2 for d, t, _ in bars if d == "Evaluate")
    assert all(n == t for _, t, n in bars)
    assert json.load(open(tmp_path / "cut" / "last" / "meta.json"))["batch_counter"] == 10
