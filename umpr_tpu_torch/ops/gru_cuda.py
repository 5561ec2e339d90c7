"""The bi-GRU forward kernels: wrappers, plain versions, launch counts.

Two CUDA C++ kernels for Hopper carry the forward of the JAX package's
Pallas GRU stack (``bigru_pallas_split_nodx``, umpr_tpu/ops/gru_pallas.py):

- K1 ``gru_input_proj`` (csrc/gru_input_proj.cu) replaces B5 (stack-pad)
  and B3 (input projection): xg = x @ [W_ih_f | W_ih_b] + b_ih in true time;
- K2 ``bigru_recurrence`` (csrc/bigru_recurrence.cu) replaces B1 (the
  masked recurrence, ``emit_hs=False``) and B6 (output repack): y in true
  time, exact zeros past each length.

Each wrapper takes its plain PyTorch version for CPU tensors and only
then.  For CUDA tensors it launches the kernel or raises; it never falls
back.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from umpr_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


def gru_input_proj_ref(x, w, b):
    """Plain version of K1: x (M, E) @ w (E, 6H) + b (6H,) -> (M, 6H)."""
    return x @ w + b


def bigru_recurrence_ref(xg, lengths, w_hh, b_hh):
    """Plain version of K2, a Python loop over time with selects.

    xg (N, L, 6H) as [fwd r z n | bwd r z n]; lengths (N,) int; w_hh
    (2, H, 3H); b_hh (2, 3H) -> y (N, L, 2H) = [fwd | bwd] in true time."""
    N, L, _ = xg.shape
    H = w_hh.shape[1]
    y = xg.new_zeros(N, L, 2 * H)
    for d, steps in ((0, range(L)), (1, range(L - 1, -1, -1))):
        h = xg.new_zeros(N, H)
        for t in steps:
            x = xg[:, t, 3 * H * d:3 * H * (d + 1)]
            hg = h @ w_hh[d] + b_hh[d]
            r = torch.sigmoid(x[:, :H] + hg[:, :H])
            z = torch.sigmoid(x[:, H:2 * H] + hg[:, H:2 * H])
            c = torch.tanh(x[:, 2 * H:] + r * hg[:, 2 * H:])
            h_new = (1.0 - z) * c + z * h
            valid = (t < lengths)[:, None]
            h = torch.where(valid, h_new, h)
            y[:, t, H * d:H * (d + 1)] = torch.where(valid, h_new, 0.0)
    return y


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype} only")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name, argtypes, *args):
    fn, error_string = _build.kernel_function(name, argtypes)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(err).decode()}")


def gru_input_proj(x, w, b):
    """K1: x (M, E) f32 @ w (E, 6H) f32 + b (6H,) f32 -> xg (M, 6H) f32."""
    if x.device.type == "cpu":
        return gru_input_proj_ref(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"gru_input_proj: unsupported device {x.device}")
    for name, t, nd in (("x", x, 2), ("w", w, 2), ("b", b, 1)):
        _check(name, t, torch.float32, nd, x.device)
    M, E = x.shape
    if w.shape[0] != E or b.shape[0] != w.shape[1]:
        raise ValueError(f"gru_input_proj: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)} disagree")
    if M > 65535 * 64:
        raise ValueError(f"gru_input_proj: {M} rows exceed the grid")
    out = torch.empty(M, w.shape[1], device=x.device, dtype=torch.float32)
    _launch("gru_input_proj", [_P] * 4 + [_I] * 3 + [_P],
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            M, E, w.shape[1])
    gru_input_proj.launches += 1
    return out


gru_input_proj.launches = 0


def bigru_recurrence(xg, lengths, w_hh, b_hh):
    """K2: xg (N, L, 6H) f32, lengths (N,) int32, w_hh (2, H, 3H) f32,
    b_hh (2, 3H) f32 -> y (N, L, 2H) f32."""
    if xg.device.type == "cpu":
        return bigru_recurrence_ref(xg, lengths, w_hh, b_hh)
    if xg.device.type != "cuda":
        raise ValueError(f"bigru_recurrence: unsupported device {xg.device}")
    _check("xg", xg, torch.float32, 3, xg.device)
    _check("lengths", lengths, torch.int32, 1, xg.device)
    _check("w_hh", w_hh, torch.float32, 3, xg.device)
    _check("b_hh", b_hh, torch.float32, 2, xg.device)
    N, L, G6 = xg.shape
    H = w_hh.shape[1]
    if (G6 != 6 * H or tuple(w_hh.shape) != (2, H, 3 * H)
            or tuple(b_hh.shape) != (2, 3 * H) or lengths.shape[0] != N):
        raise ValueError(
            f"bigru_recurrence: shapes xg {tuple(xg.shape)}, lengths "
            f"{tuple(lengths.shape)}, w_hh {tuple(w_hh.shape)}, b_hh "
            f"{tuple(b_hh.shape)} disagree")
    if H > 128:
        raise ValueError(f"bigru_recurrence: H={H} > 128 does not fit the "
                         "block's shared memory")
    y = torch.empty(N, L, 2 * H, device=xg.device, dtype=torch.float32)
    _launch("bigru_recurrence", [_P] * 5 + [_I] * 3 + [_P],
            xg.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), y.data_ptr(), N, L, H)
    bigru_recurrence.launches += 1
    return y


bigru_recurrence.launches = 0

KERNELS = (gru_input_proj, bigru_recurrence)


def reset_launches():
    for k in KERNELS:
        k.launches = 0
