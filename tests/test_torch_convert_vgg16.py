"""The port's VGG16 converter (umpr_tpu_torch/convert_vgg16.py) against
tools/convert_vgg16.py: a seeded state dict under torchvision's keys,
saved with ``torch.save``, converted by both; and at VGG16's real channel
widths (32 px photos), loaded through ``--vgg16_weights`` by the port's
Trainer to the bits of the JAX package's VGG16 restored from the JAX
converter's output."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import log_lines
from tools import convert_vgg16 as jconvert
from umpr_tpu.models.visual_net import init_vgg16
from umpr_tpu.train.checkpoint import restore_pytree
from umpr_tpu_torch import convert_vgg16
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.convert import params_to_jax
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train.trainer import Trainer

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


def torchvision_state_dict(widths, fc, n_out=1000, spatial=1, seed=0):
    """A VGG16 state dict under torchvision's names: features.<i> for the
    13 convs at their Sequential positions (ReLUs and pools between),
    classifier.{0,3,6} for the three Linears; values from `seed`."""
    g = torch.Generator().manual_seed(seed)
    sd, pos, in_ch = {}, 0, 3
    for v in widths:
        if v == "M":
            pos += 1
            continue
        sd[f"features.{pos}.weight"] = torch.randn((v, in_ch, 3, 3), generator=g)
        sd[f"features.{pos}.bias"] = torch.randn((v,), generator=g)
        pos += 2  # the conv and its ReLU
        in_ch = v
    for i, (d_in, d_out) in zip((0, 3, 6), ((in_ch * spatial * spatial, fc), (fc, fc),
                                            (fc, n_out))):
        sd[f"classifier.{i}.weight"] = torch.randn((d_out, d_in), generator=g) * 0.01
        sd[f"classifier.{i}.bias"] = torch.randn((d_out,), generator=g)
    return sd


def _read(path):
    with open(os.path.join(path, "structure.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return meta, {k: z[f"leaf_{i:05d}"] for i, k in enumerate(meta["keys"])}


@pytest.mark.parametrize("seed", [0, 1])
def test_both_converters_write_the_same_arrays(tmp_path, seed):
    cut = tuple(v if v == "M" else v // 16 for v in VGG16_CFG)  # 4 .. 32 channels
    pth = str(tmp_path / "vgg16.pth")
    torch.save(torchvision_state_dict(cut, fc=24, n_out=10, spatial=2, seed=seed), pth)
    convert_vgg16.main(["--pth", pth, "--out", str(tmp_path / "port")])
    jconvert.convert(pth, str(tmp_path / "jax"))
    (meta, got), (jmeta, want) = _read(tmp_path / "port"), _read(tmp_path / "jax")
    assert meta["keys"] == jmeta["keys"] and meta["dtypes"] == jmeta["dtypes"]
    assert len(got) == 2 * (13 + 3)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["['features'][0]['kernel']"].shape == (3, 3, 3, 4)  # HWIO
    assert got["['classifier'][2]['kernel']"].shape == (24, 10)    # (in, out)


def test_real_widths_load_through_vgg16_weights_to_the_jax_bits(tmp_path):
    pth = str(tmp_path / "vgg16.pth")
    torch.save(torchvision_state_dict(VGG16_CFG, fc=4096, spatial=1), pth)
    convert_vgg16.convert(pth, str(tmp_path / "port"))
    jconvert.convert(pth, str(tmp_path / "jax"))
    like = jax.eval_shape(lambda: init_vgg16(jax.random.PRNGKey(0), img_size=32))
    want = restore_pytree(str(tmp_path / "jax"), like)

    table = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    w2v = Word2vec(source="arrays", vocab=[f"w{i}" for i in range(5)], vectors=table[3:])
    cfg = Config(["--device", "cpu", "--review_net_only", "False", "--photo_size", "32",
                  "--gru_size", "8", "--self_atte_size", "8", "--kernel_count", "8",
                  "--vgg16_weights", str(tmp_path / "port")])
    with log_lines("port-vgg16-weights") as (lines, logger):
        trainer = Trainer(cfg, logger, w2v)
    assert f'Loaded VGG16 pretrained weights from "{tmp_path / "port"}"' in lines
    got = params_to_jax(trainer.model.visual_net.vgg16.state_dict())
    assert [len(got["features"]), len(got["classifier"])] == [13, 3]
    for part in ("features", "classifier"):
        for i, (g, w) in enumerate(zip(got[part], want[part])):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(g[leaf], np.asarray(w[leaf]),
                                              err_msg=f"{part}[{i}].{leaf}")
