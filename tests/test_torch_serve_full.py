"""Full-UMPR serving in the port on the CPU (32 px photos, batch 8):
the Predictor against ``umpr_tpu.serve.Predictor`` on one JAX-written
``best/`` (1e-4, the full-forward tolerance of PARITY.md), the resident
photo bank against streaming photos (the same bits), its overflow and
capacity gates, the Coalescer and the HTTP and CSV front ends.  Photos
are JPEGs written here with cv2, plus a missing file and empty slots."""

import json
import threading
import urllib.request

import cv2
import jax
import numpy as np
import pandas as pd
import pytest

from chip_smoke import write_corpus
from tests.test_device_dataset import EMB, VOCAB, packed_dataset
from umpr_tpu.config import Config as JaxConfig
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu.serve import Predictor as JaxPredictor
from umpr_tpu.train import checkpoint as jckpt
from umpr_tpu_torch import serve
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.text.vocab import Word2vec

FLAGS = ["--device", "cpu", "--review_net_only", "False", "--photo_size", "32",
         "--views", "['unknown']", "--photo_count", "1", "--batch_size", "8",
         "--kernel_count", "8"]
CKPT_SEED = 2  # the ReLU head is above 0 on most rows of these requests


class FakeW2v:
    def __init__(self, emb):
        self.embedding = emb


EMBEDDING = np.random.default_rng(0).standard_normal((VOCAB, EMB)).astype(np.float32)


def _photos(tmp_path, names):
    """JPEGs named p<i>.jpg for i in names; their paths."""
    rng = np.random.default_rng(sum(names))
    paths = []
    for i in names:
        p = tmp_path / f"p{i}.jpg"
        if not p.exists():
            assert cv2.imwrite(str(p), rng.integers(0, 256, (40, 50, 3)).astype(np.uint8))
        paths.append(str(p))
    return paths


def _request(tmp_path, n, seed, names):
    """A packed dataset whose samples name the JPEGs `names`, a missing
    file (every 7th) and an empty slot (every 5th)."""
    files = _photos(tmp_path, names)
    ds = packed_dataset(n, seed=seed)
    paths = np.full((n, 1, 1), "", dtype="<U256")
    for i in range(n):
        if i % 5 == 4:
            continue
        paths[i, 0, 0] = (str(tmp_path / "missing.jpg") if i % 7 == 6
                          else files[i % len(files)])
    ds.photo_paths = paths
    return ds


@pytest.fixture
def jax_best(tmp_path):
    """A JAX-written best/ of full UMPR at 32 px; its run directory."""
    cfg = JaxConfig(argv=FLAGS)
    params = init_umpr(jax.random.PRNGKey(CKPT_SEED), JaxDims.from_config(cfg), EMBEDDING)
    root = str(tmp_path / "model")
    jckpt.save_best(root, params)
    return root


def _port(root, *flags):
    return serve.Predictor(Config(FLAGS + list(flags)), FakeW2v(EMBEDDING), root)


def test_full_umpr_predictor_matches_jax_predictor(tmp_path, jax_best):
    ds = _request(tmp_path, 12, 3, range(4))
    jcfg = JaxConfig(argv=FLAGS + ["--device_dataset", "off"])
    jpreds, jrows = JaxPredictor(jcfg, FakeW2v(EMBEDDING), jax_best).predict_dataset(ds)
    for mode in ("auto", "off"):  # bank, streaming
        preds, rows = _port(jax_best, "--device_dataset", mode).predict_dataset(ds)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_allclose(preds, jpreds, rtol=1e-4, atol=1e-4, err_msg=mode)
    assert (preds > 0).mean() >= 0.5 and preds.std() > 1e-3  # not clamped to 0


def test_photo_bank_equals_streaming_over_two_requests(tmp_path, jax_best):
    first = _request(tmp_path, 12, 3, range(4))
    second = _request(tmp_path, 7, 9, range(2, 6))  # p4, p5 are new
    bank, stream = _port(jax_best), _port(jax_best, "--device_dataset", "off")
    assert bank._bank_enabled and not stream._bank_enabled
    for ds, rows in ((first, 6), (second, 8), (first, 8)):  # '' + missing + JPEGs
        np.testing.assert_array_equal(bank.predict_dataset(ds)[0],
                                      stream.predict_dataset(ds)[0])
        assert len(bank._bank_rows) == rows and bank._bank.shape[0] == 8
    # every distinct photo was decoded once, by the bank
    assert bank._photo_cache.misses == 7 and bank._photo_cache.hits == 0
    assert stream._photo_cache.misses == 8 and stream._photo_cache.hits > 0  # and ''


def test_photo_bank_overflow_streams_the_same_predictions(tmp_path, jax_best, capsys):
    ds = _request(tmp_path, 12, 3, range(4))
    want = _port(jax_best, "--device_dataset", "off").predict_dataset(ds)[0]
    tiny = _port(jax_best, "--device_dataset_mb", "0")
    for _ in range(2):
        np.testing.assert_array_equal(tiny.predict_dataset(ds)[0], want)
    assert not tiny._bank_enabled and tiny._bank is None
    assert capsys.readouterr().out.count("streaming photos from here on") == 1


def _paths_dataset(tmp_path, n, start=0):
    """n samples, one distinct (missing) photo file each."""
    ds = packed_dataset(n, seed=0)
    ds.photo_paths = np.array([str(tmp_path / f"ph{i}.jpg") for i in range(start, start + n)],
                              dtype="<U256").reshape(n, 1, 1)
    return ds


def test_photo_bank_capacity_gate_at_its_boundary(tmp_path, jax_best):
    """At 32 px a row is 3,072 bytes.  301 photos (302 rows with '') take a
    512-row bank, 1.5 MB: a 1 MB budget refuses it before decoding
    anything, 2 MB takes it.  Growth counts the old bank beside the new
    one: 200 photos (256 rows) then 150 more (512) hold 768 rows, 2.25 MB,
    past 2 MB, though 512 rows alone would fit."""
    pred = _port(jax_best, "--device_dataset_mb", "1")
    assert pred._bank_idx(_paths_dataset(tmp_path, 301)) is None
    assert not pred._bank_enabled and pred._photo_cache.misses == 0

    pred = _port(jax_best, "--device_dataset_mb", "2")
    idx = pred._bank_idx(_paths_dataset(tmp_path, 301))
    assert pred._bank_enabled and pred._bank.shape[0] == 512
    np.testing.assert_array_equal(np.sort(idx.ravel()), np.arange(1, 302))  # one row each

    pred = _port(jax_best, "--device_dataset_mb", "2")
    assert pred._bank_idx(_paths_dataset(tmp_path, 200)) is not None
    assert pred._bank.shape[0] == 256
    assert pred._bank_idx(_paths_dataset(tmp_path, 150, start=200)) is None
    assert not pred._bank_enabled


def test_coalesced_full_umpr_requests_equal_solo(tmp_path, jax_best):
    a = _request(tmp_path, 5, 3, range(4))
    b = _request(tmp_path, 3, 9, range(2, 6))
    predictor = _port(jax_best)
    solo_a, solo_b = predictor.predict_dataset(a)[0], predictor.predict_dataset(b)[0]
    merged = serve._ConcatDatasets([a, b])
    np.testing.assert_array_equal(merged.photo_paths,
                                  np.concatenate([a.photo_paths, b.photo_paths]))
    dispatches = []
    inner = predictor._predict_packed
    predictor._predict_packed = lambda ds: (dispatches.append(len(ds)), inner(ds))[1]
    co = serve.Coalescer(predictor, window_s=1.0)
    results = {}
    threads = [threading.Thread(target=lambda: results.update(a=co.predict(a, 120))),
               threading.Thread(target=lambda: results.update(b=co.predict(b, 120)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert dispatches == [8]
    np.testing.assert_array_equal(results["a"][0], solo_a)
    np.testing.assert_array_equal(results["b"][0], solo_b)


def test_full_umpr_http_and_csv_round_trip(tmp_path):
    glove, csv, shards = write_corpus(tmp_path, seed=3, shards=2, users=6, items=6,
                                      per_user=4, vocab=300, dim=8)
    (tmp_path / "photos").mkdir()
    rng = np.random.default_rng(4)
    for line in open(tmp_path / "photos.json"):
        pid = json.loads(line)["photo_id"]
        assert cv2.imwrite(str(tmp_path / "photos" / f"{pid}.jpg"),
                           rng.integers(0, 256, (40, 50, 3)).astype(np.uint8))
    w2v = Word2vec(str(glove))
    argv = FLAGS + ["--data_dir", str(tmp_path), "--word2vec_file", str(glove),
                    "--max_sent_count", "6", "--max_sent_length", "10",
                    "--model_path", str(tmp_path / "m")]
    cfg = Config(argv)
    dims = JaxDims.from_config(JaxConfig(argv=FLAGS))
    jckpt.save_best(str(tmp_path / "m"), init_umpr(jax.random.PRNGKey(CKPT_SEED), dims,
                                                   w2v.embedding))
    predictor = serve.Predictor(cfg, w2v, str(tmp_path / "m"))
    df = pd.read_csv(csv).iloc[shards[0]]
    server = serve.make_http_server(predictor, cfg, w2v, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        rows = df[["userID", "itemID", "review", "rating"]].to_dict("records")
        req = urllib.request.Request(f"{base}/predict",
                                     data=json.dumps({"rows": rows}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.load(r)["predictions"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()

    d = df.reset_index(drop=True)
    d["user_num"] = pd.factorize(d["userID"])[0]
    d["item_num"] = pd.factorize(d["itemID"])[0]
    ds = build_dataset(None, str(tmp_path / "photos.json"), str(tmp_path / "photos"),
                       w2v, cfg, df=d)
    preds, src = predictor.predict_dataset(ds)
    want = [None] * len(df)
    for p, r in zip(preds.tolist(), src.tolist()):
        want[r] = p
    assert got == want and sum(p is None for p in got) > 0 and len(preds) > 8

    # CSV mode over the same rows: a Predictor of its own, the same scores
    d.to_csv(tmp_path / "in.csv", index=False)
    serve.main(argv + ["--input", str(tmp_path / "in.csv"),
                       "--output", str(tmp_path / "out.csv")])
    out = pd.read_csv(tmp_path / "out.csv")["prediction"].to_numpy()
    np.testing.assert_array_equal(np.isfinite(out), [p is not None for p in got])
    np.testing.assert_array_equal(out[src].astype(np.float32), preds)  # f32 scores
