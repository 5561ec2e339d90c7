"""AOT export in the port (umpr_tpu_torch/export.py) on the CPU: the
artifact round trip against the port's kernel-free forward (rtol 1e-6),
against the JAX package's artifact and umpr_forward(use_pallas=False) on
the same converted parameters (1e-5 in f32; in bf16 the tolerances of
tests/test_torch_bf16.py: predictions 2e-2 absolute, and at most half as
far from JAX's bf16 ones as those are from JAX's f32 ones), the sidecar
read by either package, the CLI from a checkpoint the port's trainer
wrote.  The long-history route (both packages' attention threshold
lowered to 1): the artifact holds K7/K8's custom ops once each and nothing
(B, P, P)-shaped, and scores within 1e-4 of the JAX package's predict at
use_pallas=False (its B9 interpreted; bf16: 2e-2 absolute) and within
1e-6 of the port's eager kernel-free model; it loads in a process that
imports only umpr_tpu_torch.export; the CLI traces the (64, 8192) shape,
and check_exportable raises past the P ceiling."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ref_oracle import random_batch
from umpr_tpu import export as jexport
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import umpr_forward
from umpr_tpu.ops import attention as jattention
from umpr_tpu_torch import export
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_to_jax
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.ops import attention, attention_cuda

REPO = Path(__file__).resolve().parents[1]
OPS = ["umpr_tpu_torch::affinity_finish", "umpr_tpu_torch::affinity_tiles"]


class Cfg:
    batch_size = 8
    max_sent_count = 5
    max_sent_length = 10
    max_ui_sent_count = 2
    photo_count = 1


DIMS = dict(self_atte_size=16, kernel_count=8, photo_size=32)


def _model(full, dtype, seed=3):
    emb = np.random.default_rng(seed).standard_normal((40, 16)).astype(np.float32)
    model = UMPR(ModelDims(review_net_only=not full, compute_dtype=dtype, use_kernels=False,
                           **DIMS), emb, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.linear_fusion.bias.fill_(3.0)  # predictions > 0: the ReLU head passes them
    return model


def _batch(full, seed=1):
    return random_batch(np.random.default_rng(seed), B=8, S=5, L=10, S_ui=2, vocab=40,
                        emb=16, with_photos=full, img=32)


def _jax_tree(model):
    return jax.tree.map(jnp.asarray, params_to_jax(model.state_dict()))


def _jax_dims(full, dtype):
    return JaxDims(review_net_only=not full, use_pallas=False, compute_dtype=dtype,
                   view_size=1, vgg_fold_w=False, **DIMS)


@pytest.mark.parametrize("full,dtype", [(False, "float32"), (False, "bfloat16"),
                                        (True, "float32")])
def test_export_roundtrip_matches_port_and_jax(tmp_path, full, dtype):
    model = _model(full, dtype)
    spec = export.batch_spec(Cfg, model.dims)
    batch = _batch(full)
    assert {k: (v.shape, v.dtype) for k, v in batch.items()} == {
        k: (s, np.dtype(str(d).removeprefix("torch."))) for k, (s, d) in spec.items()}
    path = str(tmp_path / "model.pt2")
    export.save_artifact(path, export.export_predict(model, spec, "cpu"), model.state_dict(),
                         {"compute_dtype": dtype})
    if full:  # the weights are inputs: the program holds none of them
        assert os.path.getsize(path) < os.path.getsize(path + ".params.npz") / 10
    predict, params = export.load_predict(path)
    for n, t in model.state_dict().items():
        assert torch.equal(params[n], t), n
    got = predict(params, batch)
    assert got.dtype == torch.float32 and got.shape == (8,)
    with torch.no_grad():
        want = model({k: torch.as_tensor(v) for k, v in batch.items()})[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = _jax_tree(model)
    preds = {}
    for dt in {"float32", dtype}:
        jdims = _jax_dims(full, dt)
        if full:  # the JAX artifact of full UMPR is a slow test of the JAX package
            preds[dt] = np.asarray(umpr_forward(jparams, jbatch, jdims, train=False)[0])
        else:
            jpath = str(tmp_path / f"jax_{dt}.jexp")
            jspec = jexport.batch_spec(Cfg, jdims)
            jexport.save_artifact(jpath, jexport.export_predict(jparams, jdims, jspec), jparams)
            jpredict, jloaded = jexport.load_predict(jpath)
            preds[dt] = np.asarray(jpredict(jloaded, jbatch))
    got = got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, preds["float32"], rtol=1e-5, atol=1e-5)
    else:
        j16, j32 = preds["bfloat16"], preds["float32"]
        assert (j16 > 0).all()
        np.testing.assert_allclose(got, j16, rtol=0, atol=2e-2)
        assert np.linalg.norm(got - j16) <= 0.5 * np.linalg.norm(j16 - j32)


def test_sidecar_loads_into_either_package(tmp_path):
    """The port's sidecar is the JAX package's params tree (its keys and
    layout), and the JAX package's sidecar loads into the port's artifact,
    which then predicts what it predicts on its own sidecar."""
    model = _model(True, "float32")
    spec = export.batch_spec(Cfg, model.dims)
    path = str(tmp_path / "port.pt2")
    export.save_artifact(path, export.export_predict(model, spec, "cpu"), model.state_dict())
    jparams = _jax_tree(model)
    with np.load(path + ".params.npz") as z:
        keys = set(z.files)
        tree = jexport._unflatten({k: jnp.asarray(z[k]) for k in z.files})
    jkeys = {"/".join(jexport._key_part(k) for k in kp)
             for kp, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert keys == jkeys
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 jparams, tree)

    jpath = str(tmp_path / "jax.jexp")
    jexport.save_artifact(jpath, b"", jparams)  # the JAX package's sidecar writer
    from_jax = export.load_params(jpath)
    assert from_jax.keys() == model.state_dict().keys()
    for n, t in model.state_dict().items():
        assert torch.equal(from_jax[n], t), n
    predict, params = export.load_predict(path)
    batch = _batch(True, seed=4)
    assert torch.equal(predict(from_jax, batch), predict(params, batch))


def test_cli_exports_a_trained_checkpoint(tmp_path):
    """python -m umpr_tpu_torch.export --device cpu on the best/ of a run of
    the port's trainer: an artifact, a sidecar and metadata; its
    predictions on a loader batch are the trained model's on the kernel
    path (runtime maxima, as the artifact takes them)."""
    from chip_smoke import write_splits
    from umpr_tpu_torch import main as port_main
    from umpr_tpu_torch.data.dataset import build_dataset
    from umpr_tpu_torch.data.loader import BatchLoader, to_device
    from umpr_tpu_torch.text.vocab import Word2vec

    glove = write_splits(tmp_path, seed=3, shards=4, users=6, items=6, per_user=4,
                         vocab=300, dim=8)
    flags = ["--device", "cpu", "--review_net_only", "True", "--data_dir", str(tmp_path),
             "--word2vec_file", str(glove), "--batch_size", "8", "--max_sent_count", "6",
             "--max_sent_length", "10", "--min_sent_count", "3", "--self_atte_size", "16",
             "--model_path", str(tmp_path / "run")]
    trainer = port_main.main(flags + ["--train_epochs", "1", "--eval_every", "2",
                                      "--learning_rate", "1e-3", "--cache_dataset", "False",
                                      "--log_path", str(tmp_path / "log.txt")])
    out = str(tmp_path / "umpr_r.pt2")
    assert export.main(flags + ["--output", out]) == out
    meta = json.load(open(out + ".json"))
    assert meta == {"batch_size": 8, "review_net_only": True, "device": "cpu",
                    "compute_dtype": "float32",
                    "input_keys": sorted(export.batch_spec(Config(flags), trainer.model.dims)),
                    "custom_ops": []}
    predict, params = export.load_predict(out, "cpu")
    config = Config(flags)
    ds = build_dataset(str(tmp_path / "test.csv"), str(tmp_path / "photos.json"),
                       str(tmp_path / "photos"), Word2vec(str(glove)), config)
    batch = next(iter(BatchLoader(ds, 8)))
    got = predict(params, {k: batch[k] for k in meta["input_keys"]})
    with torch.no_grad():
        want = trainer.model.eval()(to_device(batch, "cpu"))[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _graph_targets(program):
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_history_export_matches_jax_and_port(monkeypatch, tmp_path, dtype):
    monkeypatch.setattr(jattention, "TILED_BYTES_THRESHOLD", 1)
    monkeypatch.setattr(attention, "TILED_BYTES_THRESHOLD", 1)
    model = _model(False, dtype)
    spec = export.batch_spec(Cfg, model.dims)
    program = export.export_predict(model, spec, "cpu")
    targets = _graph_targets(program)
    assert [t for t in targets if t.startswith("umpr_tpu_torch.")] == [
        "umpr_tpu_torch.affinity_tiles.default", "umpr_tpu_torch.affinity_finish.default"]
    P = Cfg.max_sent_count * Cfg.max_sent_length
    shapes = [tuple(n.meta["val"].shape) for n in program.graph.nodes
              if isinstance(n.meta.get("val"), torch.Tensor)]
    assert not [s for s in shapes if s[-2:] == (P, P)]
    path = str(tmp_path / "long.pt2")
    export.save_artifact(path, program, model.state_dict(), {"compute_dtype": dtype})
    assert json.load(open(path + ".json"))["custom_ops"] == OPS
    predict, params = export.load_predict(path, "cpu")
    batch = _batch(False)
    got = predict(params, batch)
    with torch.no_grad():
        want = model({k: torch.as_tensor(v) for k, v in batch.items()})[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    from umpr_tpu.ops import attention_pallas
    calls, tiled = [], attention_pallas.affinity_attention_tiled
    monkeypatch.setattr(attention_pallas, "affinity_attention_tiled",
                        lambda *a: calls.append(1) or tiled(*a))
    jpred = np.asarray(umpr_forward(_jax_tree(model), {k: jnp.asarray(v) for k, v in
                                                       batch.items()},
                                    _jax_dims(False, dtype), train=False)[0])
    assert calls == [1]  # B9
    atol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), jpred, rtol=0, atol=atol)


def test_long_history_artifact_loads_with_the_export_module_alone(monkeypatch, tmp_path):
    """A fresh process that imports umpr_tpu_torch.export alone loads the
    artifact (its custom ops registered by that import, no kernel built)
    and predicts what this process predicts."""
    monkeypatch.setattr(attention, "TILED_BYTES_THRESHOLD", 1)
    model = _model(False, "float32", seed=5)
    path = str(tmp_path / "long.pt2")
    export.save_artifact(path, export.export_predict(model, export.batch_spec(Cfg, model.dims),
                                                     "cpu"), model.state_dict())
    batch = _batch(False, seed=6)
    np.savez(tmp_path / "batch.npz", **batch)
    predict, params = export.load_predict(path)
    want = predict(params, batch).numpy()
    code = ("import sys, numpy as np\n"
            "from umpr_tpu_torch.export import load_predict\n"
            "predict, params = load_predict(sys.argv[1])\n"
            "batch = dict(np.load(sys.argv[2]))\n"
            "np.save(sys.argv[3], predict(params, batch).numpy())\n"
            "from umpr_tpu_torch.ops import _build\n"
            "assert not _build._libs  # registering the ops built nothing\n")
    out = subprocess.run([sys.executable, "-c", code, path, str(tmp_path / "batch.npz"),
                          str(tmp_path / "got.npy")], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "got.npy"), want)


def test_artifact_below_the_threshold_holds_no_custom_op():
    """P = 400 (the reference's 20 x 20) at B = 8: the composite attention,
    no custom op (trace only)."""
    class Ref(Cfg):
        max_sent_count = max_sent_length = 20

    model = _model(False, "float32")
    program = export.export_predict(model, export.batch_spec(Ref, model.dims), "cpu")
    assert export.custom_ops(program) == []
    assert not [t for t in _graph_targets(program) if "umpr_tpu_torch" in t]


def test_custom_ops_pass_opcheck():
    g = torch.Generator().manual_seed(0)
    T, U, I = (torch.randn(2, 300, 16, generator=g) for _ in range(3))
    exists = torch.rand(300, generator=g) < 0.9
    parts = torch.ops.umpr_tpu_torch.affinity_tiles(T, U, exists)
    for got, want in zip(parts, attention_cuda.affinity_tiles_ref(T, U, exists)):
        assert torch.equal(got, want)
    assert [t.dtype for t in parts] == [torch.float32, torch.int32] * 2
    out = torch.ops.umpr_tpu_torch.affinity_finish(parts[0], parts[1], parts[2], exists, U, I)
    assert [t.dtype for t in out] == [torch.float32] * 5 + [torch.int32]
    for op, args in ((torch.ops.umpr_tpu_torch.affinity_tiles.default, (T, U, exists)),
                     (torch.ops.umpr_tpu_torch.affinity_finish.default,
                      (*parts[:3], exists, U, I))):
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result


def test_cli_exports_the_long_history_shape(tmp_path):
    """python -m umpr_tpu_torch.export at --max_sent_count 128
    --max_sent_length 64, B = 64 (P = 8192) on the CPU: traced with K7/K8's
    custom ops, no forward at that size; past the P ceiling
    check_exportable raises."""
    glove = tmp_path / "glove.txt"
    rng = np.random.default_rng(0)
    glove.write_text("".join(f"w{i} " + " ".join(f"{v:.4f}" for v in rng.standard_normal(8))
                             + "\n" for i in range(30)))
    flags = ["--device", "cpu", "--review_net_only", "True", "--word2vec_file", str(glove),
             "--gru_size", "8", "--self_atte_size", "8", "--model_path", str(tmp_path / "m")]
    long_flags = ["--max_sent_count", "128", "--max_sent_length", "64"]
    from umpr_tpu_torch.text.vocab import Word2vec
    from umpr_tpu_torch.train import checkpoint as ckpt
    config = Config(flags + long_flags)
    ckpt.save_best(str(tmp_path / "m"), UMPR(ModelDims.from_config(config),
                                             Word2vec(str(glove)).embedding,
                                             torch.Generator().manual_seed(0)))
    out = str(tmp_path / "long.pt2")
    assert export.main(flags + long_flags + ["--output", out]) == out
    meta = json.load(open(out + ".json"))
    assert meta["batch_size"] == 64 and meta["custom_ops"] == OPS
    with pytest.raises(NotImplementedError, match="ceiling"):
        export.check_exportable(Config(flags + ["--max_sent_count", "400",
                                                "--max_sent_length", "64"]))
    export.check_exportable(Config(flags))  # P = 400 exports
