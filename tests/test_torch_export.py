"""AOT export in the port (umpr_tpu_torch/export.py) on the CPU: the
artifact round trip against the port's kernel-free forward (rtol 1e-6),
against the JAX package's artifact and umpr_forward(use_pallas=False) on
the same converted parameters (1e-5 in f32; in bf16 the tolerances of
tests/test_torch_bf16.py: predictions 2e-2 absolute, and at most half as
far from JAX's bf16 ones as those are from JAX's f32 ones), the sidecar
read by either package, the CLI from a checkpoint the port's trainer
wrote, and the long-history route raising."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ref_oracle import random_batch
from umpr_tpu import export as jexport
from umpr_tpu.models.umpr import ModelDims as JaxDims
from umpr_tpu.models.umpr import umpr_forward
from umpr_tpu_torch import export
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_to_jax
from umpr_tpu_torch.models.umpr import UMPR, ModelDims


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
                    "input_keys": sorted(export.batch_spec(Config(flags), trainer.model.dims))}
    predict, params = export.load_predict(out, "cpu")
    config = Config(flags)
    ds = build_dataset(str(tmp_path / "test.csv"), str(tmp_path / "photos.json"),
                       str(tmp_path / "photos"), Word2vec(str(glove)), config)
    batch = next(iter(BatchLoader(ds, 8)))
    got = predict(params, {k: batch[k] for k in meta["input_keys"]})
    with torch.no_grad():
        want = trainer.model.eval()(to_device(batch, "cpu"))[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_long_history_export_raises_naming_the_item(tmp_path):
    flags = ["--device", "cpu", "--review_net_only", "True", "--max_sent_count", "128",
             "--max_sent_length", "64", "--model_path", str(tmp_path),
             "--output", str(tmp_path / "x.pt2")]
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        export.main(flags)
    export.check_exportable(Config(flags[:-6]))  # P = 400 exports
