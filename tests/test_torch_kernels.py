"""The CUDA kernels K1 and K2 against their plain versions at ragged and
full shapes.  They need the card (a CUDA kernel has no CPU mode): the
``cuda`` fixture skips them elsewhere.  On a machine with a card (no JAX
needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from umpr_tpu_torch.ops import gru_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("M,E,N", [(1, 50, 384), (130, 17, 100), (51200, 50, 384)])
def test_gru_input_proj_matches_plain(cuda, M, E, N):
    g = torch.Generator().manual_seed(M)
    x, w, b = (torch.randn(s, generator=g).to(cuda) for s in ((M, E), (E, N), (N,)))
    before = gru_cuda.gru_input_proj.launches
    out = gru_cuda.gru_input_proj(x, w, b)
    torch.cuda.synchronize()
    assert gru_cuda.gru_input_proj.launches == before + 1
    torch.testing.assert_close(out, gru_cuda.gru_input_proj_ref(x, w, b),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,L,H", [(1, 1, 64), (37, 5, 32), (300, 20, 64), (50, 9, 128)])
def test_bigru_recurrence_matches_plain(cuda, N, L, H):
    g = torch.Generator().manual_seed(N)
    xg = torch.randn(N, L, 6 * H, generator=g).to(cuda)
    lengths = torch.randint(1, L + 1, (N,), generator=g, dtype=torch.int32)
    lengths[0] = L
    lengths[-1] = 1
    lengths = lengths.to(cuda)
    w_hh = (torch.rand(2, H, 3 * H, generator=g) / H ** 0.5).to(cuda)
    b_hh = (torch.rand(2, 3 * H, generator=g) / H ** 0.5).to(cuda)
    y = gru_cuda.bigru_recurrence(xg, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y, gru_cuda.bigru_recurrence_ref(xg, lengths, w_hh, b_hh),
        rtol=1e-5, atol=1e-5)
    past = torch.arange(L, device=cuda)[None, :] >= lengths[:, None]
    assert (y[past] == 0).all()


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 4, device=cuda)
    w = torch.randn(4, 12, device=cuda)
    b = torch.randn(12, device=cuda)
    with pytest.raises(TypeError):
        gru_cuda.gru_input_proj(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError):
        gru_cuda.gru_input_proj(x, w.t().contiguous().t(), b)
    H = 192
    with pytest.raises(ValueError):
        gru_cuda.bigru_recurrence(
            torch.zeros(2, 3, 6 * H, device=cuda),
            torch.ones(2, dtype=torch.int32, device=cuda),
            torch.zeros(2, H, 3 * H, device=cuda), torch.zeros(2, 3 * H, device=cuda))
    with pytest.raises(TypeError):
        gru_cuda.bigru_recurrence(
            torch.zeros(2, 3, 6, device=cuda), torch.ones(2, device=cuda),
            torch.zeros(2, 1, 3, device=cuda), torch.zeros(2, 3, device=cuda))
