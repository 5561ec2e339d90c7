"""``--remat_vgg`` in the port on the CPU: each VGG16 block recomputed in
the backward (``torch.utils.checkpoint``) gives the loss and gradients of
the plain forward bit for bit, with the fused pool (K5/K6's plain
versions, K5 run again in the recompute) and without it; the flag reaches
VGG16 through the Trainer, whose full-UMPR train step then keeps the bits
too.

The CPU's thread count is fixed, so that oneDNN's reductions keep one
order."""

import copy
import logging

import numpy as np
import pytest
import torch

from tests.test_device_dataset import packed_dataset
from tests.test_torch_resume import _with_photos
from tests.test_torch_train_flags import _W2v
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.models.visual_net import VGG16
from umpr_tpu_torch.ops import pool_cuda
from umpr_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True)
def fixed_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("fused", [True, False])
def test_remat_gives_the_loss_and_gradients_bit_for_bit(fused, monkeypatch):
    calls = []
    for name in ("bias_relu_pool_ref", "bias_relu_pool_bwd_ref"):
        real = getattr(pool_cuda, name)
        monkeypatch.setattr(pool_cuda, name,
                            lambda *a, real=real, name=name: calls.append(name) or real(*a))
    # 64 px: block 1 closes with the fused pool (H = 64 >= 56)
    plain = VGG16(img_size=64, fused_pool=fused, generator=torch.Generator().manual_seed(3))
    remat = VGG16(img_size=64, fused_pool=fused, remat=True)
    remat.load_state_dict(plain.state_dict())
    images = torch.from_numpy(np.random.default_rng(4).random((2, 64, 64, 3), np.float32))
    out = {}
    for name, net in (("plain", plain), ("remat", remat)):
        calls.clear()
        logits = net(images)
        # a loss whose gradient reaches every logit with its own weight
        loss = (logits * torch.linspace(-1, 1, logits.shape[1])).square().sum()
        loss.backward()
        out[name] = (loss, {n: p.grad for n, p in net.named_parameters()}, list(calls))
    (l1, g1, c1), (l2, g2, c2) = out["plain"], out["remat"]
    assert torch.equal(l1, l2) and g1.keys() == g2.keys()
    for n in g1:
        assert torch.equal(g1[n], g2[n]), n
    assert any(g.abs().sum() > 0 for n, g in g1.items() if n.startswith("features.0"))
    # K5 forward once more in the recompute, K6 once
    assert c1 == (["bias_relu_pool_ref", "bias_relu_pool_bwd_ref"] if fused else [])
    assert c2 == (["bias_relu_pool_ref"] * 2 + ["bias_relu_pool_bwd_ref"] if fused else [])
    with torch.no_grad():  # evaluation does not recompute
        calls.clear()
        remat(images)
        assert calls == (["bias_relu_pool_ref"] if fused else [])


def test_trainer_steps_with_remat_keep_the_bits(tmp_path):
    train = _with_photos(packed_dataset(8, seed=0), tmp_path)
    flags = ["--device", "cpu", "--review_net_only", "False", "--photo_size", "32",
             "--kernel_count", "8", "--batch_size", "4", "--train_epochs", "1",
             "--eval_every", "100", "--learning_rate", "0.01", "--min_sent_count", "1",
             "--seed", "2", "--vgg_fused_pool", "True"]
    runs = {}
    for remat in ("False", "True"):
        t = Trainer(Config(flags + ["--remat_vgg", remat]), logging.getLogger(f"remat-{remat}"),
                    _W2v())
        assert t.model.visual_net.vgg16.remat == (remat == "True")
        t.fit(train, copy.deepcopy(train), str(tmp_path / remat), _stop_after_batches=1)
        runs[remat] = t.model.state_dict()
    for k, v in runs["False"].items():
        assert torch.equal(v, runs["True"][k]), k
