"""The pool kernels: wrappers, plain versions, launch counts.

Two CUDA C++ kernels for Hopper carry the Pallas fused bias + ReLU + 2x2/2
max-pool of the JAX package (umpr_tpu/ops/pool_pallas.py), which closes
the VGG16 blocks whose conv output is at least 56 pixels high and even
(models/visual_net.py: blocks 1-3 at 224 px) at ``--vgg_fused_pool True``:

- K5 ``bias_relu_pool`` (csrc/bias_relu_pool.cu) replaces B8a: the
  pooled relu(x + b) and the window's first argmax, from one read of the
  conv's raw output;
- K6 ``bias_relu_pool_bwd`` (csrc/bias_relu_pool_bwd.cu) replaces B8b:
  dx scattered to the argmax corner (full size, zeros written) and db.

Both take NHWC tensors (N, H, W, C) with H and W even: the JAX layout,
and a free view of a ``channels_last`` conv output.  They take float32
or, under ``--compute_dtype bfloat16``, bfloat16 (the ``<name>_bf16`` C
entry points; ``.launches_bf16`` counts those launches), with the JAX
kernels' rounding points (pool_pallas.py:67-83, :109, :189): x + b
rounded once to bf16, yp and dx bf16 (exact), db the f32 sum rounded
once.  Window corners are taken in the order (2h, 2w), (2h, 2w+1),
(2h+1, 2w), (2h+1, 2w+1); a tie goes to the first
(``pool_pallas.py:78-81``).

Each wrapper takes its plain PyTorch version for CPU tensors and only
then.  For CUDA tensors it launches the kernel or raises; it never falls
back.  On a non-CPU device the wrappers raise on an input that requires
grad: ``ops.pool.FusedBiasReluPool`` calls them on detached tensors and
gives the graph its backward.  ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from umpr_tpu_torch.ops.gru_cuda import _io, _launch, _widen

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

POOL_THREADS = 256  # threads per block (channel vectors x positions)
POOL_ITERS = 8      # positions each thread row takes per block


def bias_relu_pool_ref(x, b):
    """Plain version of K5: x (N, H, W, C), b (C,) -> (yp (N, H/2, W/2, C),
    idx (same) uint8), written from the maths: ReLU keeps NaN, the max
    propagates NaN, ties go to the first corner.  The add rounds in x's
    type (one rounding in bf16); the rest is exact."""
    v = _widen(x + b)
    y = torch.where(v < 0, 0.0, v)
    a0, a1 = y[:, 0::2, 0::2], y[:, 0::2, 1::2]
    a2, a3 = y[:, 1::2, 0::2], y[:, 1::2, 1::2]
    yp = torch.maximum(torch.maximum(a0, a1), torch.maximum(a2, a3))
    idx = torch.where(a0 >= yp, 0, torch.where(a1 >= yp, 1, torch.where(a2 >= yp, 2, 3)))
    return yp.to(x.dtype), idx.to(torch.uint8)


def bias_relu_pool_bwd_ref(dyp, idx, yp):
    """Plain version of K6: dyp, yp (N, H2, W2, C), idx (same) uint8 ->
    (dx (N, 2*H2, 2*W2, C), db (C,)) in dyp's type; db summed in f32 and
    rounded once."""
    N, H2, W2, C = dyp.shape
    g = torch.where(yp > 0, dyp, 0.0)
    parts = [torch.where(idx == k, g, 0.0) for k in range(4)]
    dx = torch.stack([torch.stack(parts[:2], dim=3), torch.stack(parts[2:], dim=3)], dim=2)
    return (dx.reshape(N, 2 * H2, 2 * W2, C),
            _widen(g).sum(dim=(0, 1, 2)).to(dyp.dtype))


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype} here")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NHWC)")


def _device_kernel(name, *tensors):
    """For a non-CPU call: raise unless the tensors are CUDA tensors that
    need no graph (a kernel's output would silently cut it)."""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel's output would "
            "carry no graph; call it through ops.pool.FusedBiasReluPool, "
            "which gives the kernels their backward")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")


def _pooled_shape(name, shape):
    if len(shape) != 4:
        raise ValueError(f"{name}: expected (N, H, W, C), got {tuple(shape)}")
    N, H, W, C = shape
    if H % 2 or W % 2:
        raise ValueError(f"{name}: H={H} and W={W} must be even")
    return N, H // 2, W // 2, C


def launch_shape(C, io, *tensors):
    """(vec, block_y, pix_per_block) of a K5/K6 launch: one 16-byte access
    of channels per thread (4 in f32, 8 in bf16) when C is a multiple of
    it and every pointer is 16-byte aligned, else 1 channel; blocks of
    about POOL_THREADS threads, POOL_ITERS positions per thread row."""
    per = 16 // torch.empty(0, dtype=io).element_size()
    vec = per if C % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1
    lanes = C // vec
    if lanes > 1024:
        raise ValueError(f"C={C} needs {lanes} threads per position; the "
                         "kernels take at most 1024")
    block_y = max(1, POOL_THREADS // lanes)
    return vec, block_y, block_y * POOL_ITERS


def bias_relu_pool(x, b):
    """K5: x (N, H, W, C) NHWC, b (C,), both float32 or both bfloat16 ->
    (yp (N, H/2, W/2, C) in their type, idx (same) uint8)."""
    N, H2, W2, C = _pooled_shape("bias_relu_pool", x.shape)
    if x.device.type == "cpu":
        return bias_relu_pool_ref(x, b)
    _device_kernel("bias_relu_pool", x, b)
    io = _io("bias_relu_pool", x)
    _check("x", x, io, x.shape, x.device)
    _check("b", b, io, (C,), x.device)
    yp = torch.empty(N, H2, W2, C, device=x.device, dtype=io)
    idx = torch.empty(N, H2, W2, C, device=x.device, dtype=torch.uint8)
    vec, block_y, ppb = launch_shape(C, io, x, b, yp, idx)
    _launch("bias_relu_pool", [_P] * 4 + [_L] + [_I] * 5 + [_P],
            x.data_ptr(), b.data_ptr(), yp.data_ptr(), idx.data_ptr(),
            N * H2 * W2, W2, C, vec, block_y, ppb, io=io)
    bias_relu_pool.launches += 1
    bias_relu_pool.launches_bf16 += io == torch.bfloat16
    return yp, idx


bias_relu_pool.launches = bias_relu_pool.launches_bf16 = 0


def bias_relu_pool_bwd(dyp, idx, yp):
    """K6: dyp (N, H2, W2, C), idx (same) uint8, yp (same), dyp and yp
    float32 or bfloat16 -> (dx (N, 2*H2, 2*W2, C), db (C,)) in dyp's type.

    Each block writes one f32 db partial; they are summed here in a fixed
    order (no atomics), so the result is the same on every run, and the
    sum is rounded once to dyp's type."""
    if dyp.device.type == "cpu":
        return bias_relu_pool_bwd_ref(dyp, idx, yp)
    _device_kernel("bias_relu_pool_bwd", dyp, yp)
    if dyp.dim() != 4:
        raise ValueError(f"bias_relu_pool_bwd: dyp has shape {tuple(dyp.shape)}, "
                         "expected (N, H2, W2, C)")
    N, H2, W2, C = dyp.shape
    io = _io("bias_relu_pool_bwd", dyp)
    _check("dyp", dyp, io, dyp.shape, dyp.device)
    _check("idx", idx, torch.uint8, dyp.shape, dyp.device)
    _check("yp", yp, io, dyp.shape, dyp.device)
    dx = torch.empty(N, 2 * H2, 2 * W2, C, device=dyp.device, dtype=io)
    vec, block_y, ppb = launch_shape(C, io, dyp, idx, yp, dx)
    pixels = N * H2 * W2
    db_part = torch.empty(-(-pixels // ppb), C, device=dyp.device, dtype=torch.float32)
    _launch("bias_relu_pool_bwd", [_P] * 5 + [_L] + [_I] * 5 + [_P],
            dyp.data_ptr(), idx.data_ptr(), yp.data_ptr(), dx.data_ptr(),
            db_part.data_ptr(), pixels, W2, C, vec, block_y, ppb, io=io)
    bias_relu_pool_bwd.launches += 1
    bias_relu_pool_bwd.launches_bf16 += io == torch.bfloat16
    return dx, db_part.sum(0).to(io)


bias_relu_pool_bwd.launches = bias_relu_pool_bwd.launches_bf16 = 0

KERNELS = (bias_relu_pool, bias_relu_pool_bwd)


def reset_launches():
    for k in KERNELS:
        k.launches = k.launches_bf16 = 0
