"""The Plenoxels step's dense TV gradient and RMSProp update in one pass.

``csrc/tv_rmsprop.cu`` replaces no TPU kernel: the JAX package leaves the
total variation (``tv_loss`` through ``jax.grad``) and RMSProp to XLA.  On
the card the trainer's autograd ``tv_loss`` and ``_rmsprop`` ran as a dozen
full passes of PyTorch's elementwise kernels over the grid; the kernel
computes the TV gradient as a stencil, adds it to the data gradient and
applies RMSProp in the same sweep, writing the new parameters into a second
buffer (``out``) and the RMSProp state in place.  The TV's alive rule comes
from ``live_pairs``: a byte a cell whose bit d says that the pair with
neighbour d counts, computed once for the grid's fields by a small kernel.

``live_pairs`` and ``tv_rmsprop`` launch their kernels on CUDA tensors (or
raise) and run ``live_pairs_plain`` and ``tv_rmsprop_plain``, the same
functions in plain torch ops (the sweep in the kernel's order of
operations), on CPU tensors.  ``SWEEP_LAUNCHES`` and ``PAIRS_LAUNCHES``
count the launches, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flnerf_tpu_torch.ops import _build

SWEEP_LAUNCHES = 0
PAIRS_LAUNCHES = 0

EPS = 1e-8   # optim_kernel.cu:28 rmsprop_step's epsilon, as the trainer's _rmsprop
# neighbour d of a cell, in the kernels' order: (dim, step)
NEIGHBOURS = ((0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1))

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launch_counts() -> None:
    global SWEEP_LAUNCHES, PAIRS_LAUNCHES
    SWEEP_LAUNCHES = 0
    PAIRS_LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("tv_rmsprop")
    if lib.tv_rmsprop.argtypes is None:
        lib.tv_pairs.restype = ctypes.c_int
        lib.tv_pairs.argtypes = [_P, _P, _I, _I, _I, _P]
        lib.tv_rmsprop.restype = ctypes.c_int
        lib.tv_rmsprop.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _F, _F, _F, _F, _F, _P]
        lib.tv_rmsprop_lrp.restype = ctypes.c_int
        lib.tv_rmsprop_lrp.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _F, _F, _F, _P, _F, _P]
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_range(shape) -> None:
    x, y, z = shape[:3]
    c = 1 if len(shape) == 3 else shape[3]
    if y * z * c >= 2 ** 31 or x > 65535:
        raise ValueError(f"grid {tuple(shape)} out of the kernels' range")


def _f32(v: float) -> float:
    """``v`` rounded to float32, as torch rounds a Python scalar operand."""
    return float(np.float32(v))


def _scalars(shape, lam: float, beta: float):
    """(coef, beta, 1 - beta, eps), each rounded to float32:
    coef = 2 * lam / (X * Y * Z) is tv_loss's gradient factor."""
    n = shape[0] * shape[1] * shape[2]
    return tuple(_f32(v) for v in (2.0 * lam / n, beta, 1.0 - beta, EPS))


def _neighbour(t: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """t[i + step] along ``dim`` at i (the edge wraps: masked out)."""
    return torch.roll(t, -step, dim)


def _exists(shape, dim: int, step: int, device) -> torch.Tensor:
    """[X, Y, Z] bool: the cells whose neighbour i + step along ``dim`` lies
    inside the grid."""
    i = torch.arange(shape[dim], device=device)
    ok = (i + step >= 0) & (i + step < shape[dim])
    view = [1, 1, 1]
    view[dim] = shape[dim]
    return ok.reshape(view).expand(tuple(shape[:3]))


def live_pairs_plain(alive: torch.Tensor) -> torch.Tensor:
    """``live_pairs`` in plain torch ops."""
    bits = torch.zeros(alive.shape, dtype=torch.uint8, device=alive.device)
    for d, (dim, step) in enumerate(NEIGHBOURS):
        pair = alive & _neighbour(alive, dim, step) & _exists(alive.shape, dim, step,
                                                              alive.device)
        bits |= pair.to(torch.uint8) << d
    return bits


def live_pairs(alive: torch.Tensor) -> torch.Tensor:
    """uint8 [X, Y, Z] from the bool [X, Y, Z] ``alive`` mask: bit d of a
    cell (``NEIGHBOURS[d]``) set when the cell and that neighbour lie inside
    the grid and are both alive, i.e. when their difference counts in
    ``tv_loss``.  CUDA tensors launch the kernel; CPU tensors take
    ``live_pairs_plain``; any other device raises."""
    global PAIRS_LAUNCHES
    dev = alive.device
    if alive.dim() != 3:
        raise ValueError(f"alive must be [X, Y, Z], got {tuple(alive.shape)}")
    _build.check_tensor(alive, "alive", alive.shape, torch.bool, dev)
    if dev.type == "cpu":
        return live_pairs_plain(alive)
    if dev.type != "cuda":
        raise ValueError(f"no live_pairs for device {dev}")
    _check_range(alive.shape)
    bits = torch.empty(alive.shape, dtype=torch.uint8, device=dev)
    if alive.numel() == 0:
        return bits
    rc = _lib().tv_pairs(alive.data_ptr(), bits.data_ptr(), *alive.shape, _stream(dev))
    PAIRS_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"tv_pairs launch failed: cudaError {rc}")
    return bits


def tv_rmsprop_plain(param, grad, rms, pairs, lam: float, lr, beta: float,
                     out: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops, in its order of operations
    (each rounded on its own), so the two agree bit for bit on the card
    (on the CPU torch's sqrt, MKL's, may differ by an ulp): the TV
    gradient of ``tv_loss`` times ``lam`` from the 6-neighbour stencil
    (x-1, x+1, y-1, y+1, z-1, z+1; a pair counts where ``pairs``, from
    ``live_pairs``, has its bit), added to ``grad``, then RMSProp.  Updates
    ``rms`` in place and writes the new parameters into ``out``; returns
    ``out``."""
    coef, b, omb, eps = _scalars(param.shape, lam, beta)
    # a tensor lr (a float32 scalar) as a 0-d tensor, which the same
    # float32 operations take as they take the float
    neg_lr = -lr.reshape(()) if isinstance(lr, torch.Tensor) else _f32(-lr)
    chan = (lambda m: m) if param.dim() == 3 else (lambda m: m[..., None])
    acc = torch.zeros_like(param)
    if coef != 0.0:
        for d, (dim, step) in enumerate(NEIGHBOURS):
            pair = ((pairs >> d) & 1).bool()
            acc = torch.where(chan(pair), acc + (param - _neighbour(param, dim, step)), acc)
    gg = grad + coef * acc
    rms.mul_(b).add_((omb * gg) * gg)
    return torch.add(param, neg_lr * (gg / (rms.sqrt() + eps)), out=out)


def _check(param, grad, rms, pairs, lam, lr, out) -> None:
    dev = param.device
    if param.dim() not in (3, 4):
        raise ValueError(f"param must be [X, Y, Z] or [X, Y, Z, C], got {tuple(param.shape)}")
    f32 = torch.float32
    _build.check_tensor(param, "param", param.shape, f32, dev)
    for t, name in ((grad, "grad"), (rms, "rms"), (out, "out")):
        _build.check_tensor(t, name, param.shape, f32, dev)
    if pairs is None and lam != 0.0:
        raise ValueError("a TV weight needs the grid's live_pairs")
    if pairs is not None:
        _build.check_tensor(pairs, "pairs", param.shape[:3], torch.uint8, dev)
    if isinstance(lr, torch.Tensor) and (lr.numel() != 1 or lr.dtype != f32
                                         or lr.device != dev):
        raise ValueError(f"a tensor lr must be one float32 on {dev}, got "
                         f"{lr.dtype} {tuple(lr.shape)} on {lr.device}")
    ptrs = [t.data_ptr() for t in (param, grad, rms, out)]
    if len(set(ptrs)) != 4:
        raise ValueError("param, grad, rms and out must be four separate buffers")


def tv_rmsprop(param, grad, rms, pairs, lam: float, lr, beta: float,
               out: torch.Tensor = None) -> torch.Tensor:
    """One step of the dense TV-regularised RMSProp on ``param`` ([X, Y, Z]
    density or [X, Y, Z, C] SH, f32, contiguous) with its data gradient
    ``grad`` and state ``rms`` (same shape; updated in place) and the
    grid's ``live_pairs`` (None only where ``lam`` is 0): TV weight ``lam``
    (0: RMSProp alone), learning rate ``lr``, decay ``beta``.  The new
    parameters go to ``out`` (a fourth buffer of param's shape; allocated
    when None), which is returned; ``param`` is left as it was.

    ``lr`` is a float, or a one-element float32 tensor on param's device
    that the kernel reads when it runs (so a CUDA graph that captured the
    launch takes whatever rate is written there before each replay); both
    give the same result for the same value.

    CUDA tensors launch the kernel (on the current stream, no sync); CPU
    tensors take ``tv_rmsprop_plain``; any other device raises."""
    global SWEEP_LAUNCHES
    if out is None:
        out = torch.empty_like(param)
    _check(param, grad, rms, pairs, lam, lr, out)
    dev = param.device
    if dev.type == "cpu":
        return tv_rmsprop_plain(param, grad, rms, pairs, lam, lr, beta, out)
    if dev.type != "cuda":
        raise ValueError(f"no tv_rmsprop for device {dev}")
    _check_range(param.shape)
    if param.numel() == 0:
        return out
    x, y, z = param.shape[:3]
    c = 1 if param.dim() == 3 else param.shape[3]
    coef, b, omb, eps = _scalars(param.shape, lam, beta)
    ptrs = (param.data_ptr(), grad.data_ptr(), rms.data_ptr(),
            None if pairs is None else pairs.data_ptr(), out.data_ptr(), x, y, z, c,
            coef, b, omb)
    if isinstance(lr, torch.Tensor):
        rc = _lib().tv_rmsprop_lrp(*ptrs, lr.data_ptr(), eps, _stream(dev))
    else:
        rc = _lib().tv_rmsprop(*ptrs, _f32(-lr), eps, _stream(dev))
    SWEEP_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"tv_rmsprop launch failed: cudaError {rc}")
    return out
