"""The port's control network (models/control_net.py) and conv1d-same layer
against the JAX package on the same weights, at small shapes, with the
JAX GRU on its Pallas kernels (interpreted).  Tolerance 1e-5 (PARITY.md,
masked GRU), the eq. 18 routing exactly at a view score of 0.5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.ref_oracle import random_batch
from umpr_tpu.models import control_net as jcontrol
from umpr_tpu.models.layers import conv1d_same
from umpr_tpu.ops import masking as jmasking
from umpr_tpu_torch.convert import params_to_jax
from umpr_tpu_torch.models.control_net import ControlNet
from umpr_tpu_torch.models.layers import Conv1dSame
from umpr_tpu_torch.ops import masking

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, EMB, H = 40, 12, 64


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_conv1d_same_matches_jax(k):
    conv = Conv1dSame(6, 5, k, torch.Generator().manual_seed(k))
    x = np.random.default_rng(k).standard_normal((3, 7, 6)).astype(np.float32)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    want = np.asarray(conv1d_same(params_to_jax(conv.state_dict()), jnp.asarray(x)))
    assert got.shape == want.shape == (3, 7 - (k + 1) % 2, 5)
    np.testing.assert_allclose(got, want, **TOL)
    bound = 1 / np.sqrt(6 * k)  # nn.Conv1d's default init range
    assert 0.5 * bound < np.abs(conv.weight.detach().numpy()).max() <= bound


def _net(seed, k=3):
    net = ControlNet(EMB, H, kernel_count=8, kernel_size=k, view_size=2,
                     atte_size=16, generator=torch.Generator().manual_seed(seed))
    return net, params_to_jax(net.state_dict())


def _inputs(seed, B=3, S=4, S_ui=3, L=8):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((VOCAB, EMB)).astype(np.float32)
    b = random_batch(rng, B=B, S=S, L=L, S_ui=S_ui, vocab=VOCAB, emb=EMB,
                     max_count=S - 1, max_len=L - 1)
    exists = masking.exists_mask(max(b["u_counts"].max(), b["i_counts"].max()),
                                 max(b["u_lengths"].max(), b["i_lengths"].max()),
                                 S, L, "cpu")
    ui_exists = masking.exists_mask(b["ui_counts"].max(), b["ui_lengths"].max(),
                                    S_ui, L, "cpu")
    both = np.concatenate([emb[b["u_tokens"]], emb[b["i_tokens"]]])
    args = (both, emb[b["ui_tokens"]], b["u_lengths"], b["i_lengths"],
            b["ui_lengths"], exists.numpy(), ui_exists.numpy())
    return args, b


def _run_both(net, jparams, args, threshold=0.35):
    want = jcontrol.control_net(jparams, *(jnp.asarray(a) for a in args),
                                threshold, use_pallas=True)
    with torch.no_grad():
        got = net(*(torch.from_numpy(np.asarray(a)) for a in args), threshold)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 2)])
def test_control_net_matches_jax(seed, k):
    net, jparams = _net(seed, k)
    args, _ = _inputs(seed)
    got, want = _run_both(net, jparams, args)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 2)
        np.testing.assert_allclose(g, w, **TOL)
    assert all(np.isfinite(g).all() for g in got)
    # the threshold zeroes views: at 0.99 every prefer is 0
    got, want = _run_both(net, jparams, args, threshold=0.99)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert not got[2].any() and not got[3].any()


def test_cnet_matches_jax_including_the_output_length_mask():
    net, jparams = _net(2, k=2)  # even k: the conv output is one shorter
    args, b = _inputs(2)
    ui_emb, ui_len, ui_exists = args[1], args[4], args[6]
    jout = jcontrol.cnet(jparams["cnet"], jnp.asarray(ui_emb), jnp.asarray(ui_len),
                         jnp.asarray(ui_exists), 0.35, use_pallas=True)
    with torch.no_grad():
        out = net.cnet(torch.from_numpy(ui_emb), torch.from_numpy(ui_len),
                       torch.from_numpy(ui_exists), 0.35)
    for g, w in zip(out, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    s_ok = ui_exists[:, 0]
    assert not out[1].numpy()[:, ~s_ok].any()  # missing sentences: view_p 0


def test_routing_at_a_view_score_of_exactly_one_half(monkeypatch):
    """Every view probability is 1 (C-Net's linear pinned to sigmoid(30)),
    one ui sentence exists, and S-Net's sentiment is fixed per sample:
    fl(1 + 1e-4) / 2 gives a view score of exactly 0.5, where q_pos and
    q_neg both survive their masks with value 0 and q_p is 0."""
    net, _ = _net(3)
    with torch.no_grad():
        net.cnet.linear.weight.zero_()
        net.cnet.linear.bias.fill_(30.0)
    jparams = params_to_jax(net.state_dict())
    args, b = _inputs(3)
    args = list(args)
    args[6] = np.array(jmasking.exists_mask(1, b["ui_lengths"][:, 0].max(), 3, 8))
    half = np.float32(np.float32(1.0) + np.float32(1e-4)) / np.float32(2.0)
    senti = np.array([0.2, half, 0.9], np.float32)[:, None, None] * np.ones((1, 3, 1),
                                                                            np.float32)
    monkeypatch.setattr(jcontrol, "ssnet", lambda p, s: jnp.asarray(senti))
    monkeypatch.setattr(net.ssnet, "forward", lambda s: torch.from_numpy(senti))
    got, want = _run_both(net, jparams, args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    c_net_out = 1.0  # one existing sentence, view_p 1
    np.testing.assert_array_equal(got[2][1], 0.0)  # prefer_pos at 0.5
    np.testing.assert_array_equal(got[3][1], 0.0)  # prefer_neg at 0.5
    assert (got[2][0] == 0).all() and (got[3][0] > 0).all()  # below 0.5
    assert (got[2][2] > 0).all() and (got[3][2] == 0).all()  # above 0.5
    np.testing.assert_allclose(got[3][0], c_net_out * 4 * (0.5 - 0.2 / (1 + 1e-4)) ** 2,
                               rtol=1e-5)
