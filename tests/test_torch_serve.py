"""The port's serving path on the CPU against the JAX package: Predictor on
one JAX-written checkpoint, build_dataset arrays, the HTTP scorer, the
Coalescer, the device rule and the port's import isolation."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from chip_smoke import write_corpus
from tests.test_checkpoint_loader import small_dataset
from umpr_tpu.config import Config as JaxConfig
from umpr_tpu.data.dataset import build_dataset as jax_build_dataset
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import init_umpr
from umpr_tpu.serve import Predictor as JaxPredictor
from umpr_tpu.text.vocab import Word2vec as JaxWord2vec
from umpr_tpu.train import checkpoint as jckpt
from umpr_tpu_torch import serve
from umpr_tpu_torch.config import Config, resolve_device
from umpr_tpu_torch.data.dataset import build_dataset
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["--device", "cpu", "--review_net_only", "True", "--batch_size", "8"]


class FakeW2v:
    def __init__(self, emb):
        self.embedding = emb


def test_predictor_matches_jax_predictor_on_jax_checkpoint(tmp_path):
    emb = np.random.default_rng(0).standard_normal((25, 8)).astype(np.float32)
    jcfg = JaxConfig(argv=CPU8)
    params = init_umpr(jax.random.PRNGKey(2), JaxDims.from_config(jcfg), emb)
    root = str(tmp_path / "m")
    jckpt.save_best(root, params)
    ds = small_dataset(n=10)

    jpreds, jrows = JaxPredictor(jcfg, FakeW2v(emb), root).predict_dataset(ds)
    predictor = serve.Predictor(Config(CPU8), FakeW2v(np.zeros_like(emb)), root)
    preds, rows = predictor.predict_dataset(ds)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_allclose(preds, jpreds, rtol=1e-4, atol=1e-4)
    assert (preds >= 0).all() and np.isfinite(preds).all()
    np.testing.assert_array_equal(preds, predictor.predict_dataset(ds)[0])


def _corpus(tmp_path):
    glove, csv, shards = write_corpus(tmp_path, seed=3, shards=2, users=6,
                                      items=6, per_user=4, vocab=300, dim=8)
    return str(glove), str(csv), shards


def test_build_dataset_arrays_equal_jax(tmp_path):
    glove, csv, _ = _corpus(tmp_path)
    flags = ["--device", "cpu", "--max_sent_count", "6", "--max_sent_length",
             "10", "--max_ui_sent_count", "2", "--min_sent_count", "8"]
    jw, w = JaxWord2vec(glove), Word2vec(glove)
    np.testing.assert_array_equal(w.embedding, jw.embedding)
    assert w.word2index == jw.word2index
    df = pd.read_csv(csv)
    args = (str(tmp_path / "photos.json"), str(tmp_path / "photos"))
    jds = jax_build_dataset(None, *args, jw, JaxConfig(flags), df=df.copy())
    ds = build_dataset(None, *args, w, Config(flags + ["--review_net_only", "True"]),
                       df=df.copy())
    assert 0 < len(ds) < len(df)  # the photo and history filters both fired
    for field in jds.__dataclass_fields__:
        a, b = getattr(ds, field), getattr(jds, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def _port_predictor(tmp_path, glove, extra=()):
    w2v = Word2vec(glove)
    cfg = Config(CPU8 + ["--data_dir", str(tmp_path), "--max_sent_count", "6",
                         "--max_sent_length", "10", *extra])
    root = str(tmp_path / "m")
    ckpt.save_best(root, UMPR(ModelDims.from_config(cfg), w2v.embedding,
                              torch.Generator().manual_seed(5)))
    return serve.Predictor(cfg, w2v, root), cfg, w2v


def test_http_predict_round_trip(tmp_path):
    glove, csv, shards = _corpus(tmp_path)
    predictor, cfg, w2v = _port_predictor(tmp_path, glove)
    df = pd.read_csv(csv).iloc[shards[0]]
    server = serve.make_http_server(predictor, cfg, w2v, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            assert json.load(r) == {"status": "ok"}
        rows = df[["userID", "itemID", "review", "rating"]].to_dict("records")
        req = urllib.request.Request(f"{base}/predict",
                                     data=json.dumps({"rows": rows}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.load(r)["predictions"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    # the same request, built and scored directly (request-local ids)
    d = df.reset_index(drop=True)
    d["user_num"] = pd.factorize(d["userID"])[0]
    d["item_num"] = pd.factorize(d["itemID"])[0]
    ds = build_dataset(None, str(tmp_path / "photos.json"),
                       str(tmp_path / "photos"), w2v, cfg, df=d)
    preds, src = predictor.predict_dataset(ds)
    want = [None] * len(df)
    for p, r in zip(preds.tolist(), src.tolist()):
        want[r] = p
    assert got == want
    assert sum(p is None for p in got) > 0 and len(preds) > cfg.batch_size


def test_coalescer_matches_solo_requests(tmp_path):
    glove, _, _ = _corpus(tmp_path)
    predictor, _, _ = _port_predictor(tmp_path, glove)
    ds_a, ds_b = small_dataset(n=3, S=6, L=10), small_dataset(n=2, S=6, L=10)
    solo_a, _ = predictor.predict_dataset(ds_a)
    solo_b, _ = predictor.predict_dataset(ds_b)
    dispatches = []
    inner = predictor._predict_packed
    predictor._predict_packed = lambda ds: (dispatches.append(len(ds)), inner(ds))[1]
    co = serve.Coalescer(predictor, window_s=1.0)
    results = {}
    threads = [threading.Thread(target=lambda: results.update(a=co.predict(ds_a, 120))),
               threading.Thread(target=lambda: results.update(b=co.predict(ds_b, 120)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert dispatches == [5]
    np.testing.assert_array_equal(results["a"][0], solo_a)
    np.testing.assert_array_equal(results["b"][0], solo_b)


def test_default_device_is_cuda_and_raises_without_a_card():
    assert Config.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        Config(["--review_net_only", "True"])
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


# the ids keep the numbers the cases had while --compute_dtype bfloat16
# raised in three more of them (flags0, flags1, flags3); flags6 asked for
# --mesh_shape while ROADMAP A7 was not ported, and now holds its one
# check that needs no world: a mesh of 8 ranks over a world of 1 raises
# ValueError
@pytest.mark.parametrize("flags,item,exc", [
    pytest.param(["--review_net_only", "True", "--checkpoint_backend", "orbax"], "A4",
                 NotImplementedError, id="flags2-A4"),
    pytest.param(["--review_net_only", "False", "--compute_dtype", "bfloat16",
                  "--checkpoint_backend", "orbax"], "A4", NotImplementedError,
                 id="flags4-A4"),
    pytest.param(["--review_net_only", "False", "--checkpoint_backend", "orbax"], "A4",
                 NotImplementedError, id="flags5-A4"),
    pytest.param(["--review_net_only", "True", "--mesh_shape", "[8]"],
                 r"--mesh_shape \[8\] lays out 8 ranks .* the world has 1 rank",
                 ValueError, id="flags6-A7"),
    pytest.param(["--review_net_only", "True", "--checkpoint_backend", "orbax",
                  "--adam_factored_nu", "True"], "A4", NotImplementedError, id="flags7-A4"),
    pytest.param(["--review_net_only", "True", "--use_pallas", "False"], "CUDA kernels",
                 NotImplementedError, id="flags8-CUDA kernels"),
])
def test_unported_flags_raise_naming_the_roadmap_item(flags, item, exc, tmp_path):
    """Through serve.main, which reads the flags with Config first, and
    through Config itself: the flags of NOT_PORTED raise, as does a
    --mesh_shape that the world does not fill."""
    with pytest.raises(exc, match=item):
        serve.main(["--device", "cpu", "--model_path", str(tmp_path),
                    "--input", str(tmp_path / "in.csv")] + flags)
    with pytest.raises(exc, match=item):
        Config(["--device", "cpu"] + flags)


def test_full_umpr_predictor_serves(tmp_path):
    """Full UMPR serves (ROADMAP A2, once the item that raised here): the
    Predictor builds from a checkpoint and scores finite predictions."""
    emb = np.random.default_rng(1).standard_normal((40, 8)).astype(np.float32)
    cfg = Config(["--device", "cpu", "--review_net_only", "False", "--photo_size", "32",
                  "--kernel_count", "8", "--batch_size", "4", "--max_sent_count", "6",
                  "--max_sent_length", "10"])
    ckpt.save_best(str(tmp_path), UMPR(ModelDims.from_config(cfg), emb,
                                       torch.Generator().manual_seed(2)))
    predictor = serve.Predictor(cfg, FakeW2v(emb), str(tmp_path))
    ds = small_dataset(n=5, S=6, L=10)
    preds, rows = predictor.predict_dataset(ds)
    assert preds.shape == (5,) and np.isfinite(preds).all() and (preds >= 0).all()
    np.testing.assert_array_equal(rows, np.arange(5))
    assert predictor._bank_enabled and len(predictor._bank_rows) == 1  # '' only


def test_every_flag_is_read_or_raises():
    """A flag the port accepts at a non-default value is one it reads: the
    flags of NOT_PORTED raise, and every other one appears in the package's
    code as ``config.<flag>``/``cfg.<flag>``."""
    import re
    from pathlib import Path
    from umpr_tpu_torch.config import NOT_PORTED
    src = "".join(p.read_text() for p in Path(REPO, "umpr_tpu_torch").rglob("*.py")
                  if p.name != "config.py")
    read = set(re.findall(r"\b(?:config|cfg)\.([a-z_0-9]+)", src))
    read |= {"device", "multi_gpu", "review_net_only", "review_level",
             "use_pallas"}  # config.py
    flags = {k for k, _ in Config._attributes()}
    assert set(NOT_PORTED) <= flags
    assert flags - set(NOT_PORTED) == read & flags, (
        sorted(flags - set(NOT_PORTED) - read), sorted(read & set(NOT_PORTED)))
    defaults = dict(Config._attributes())
    for key in sorted(NOT_PORTED):  # the defaults themselves are taken
        val = defaults[key]
        Config(["--device", "cpu", "--review_net_only", "True",
                f"--{key}", val if isinstance(val, str) else repr(val)])


def test_port_imports_neither_jax_nor_umpr_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import umpr_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(umpr_tpu_torch.__path__, 'umpr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'umpr_tpu' or m.startswith('umpr_tpu.')]\n"
        "assert not bad, bad\n"
        "native = sys.modules['umpr_tpu_torch.native']\n"
        "assert native._lib is None  # nothing compiles at import\n"
        "print(len([m for m in sys.modules if m.startswith('umpr_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every module was imported
