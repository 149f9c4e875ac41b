"""The dense TV gradient + RMSProp kernel (flnerf_tpu_torch/ops/csrc/tv_rmsprop.cu)
on the card: bit for bit its plain version (ops/tv_rmsprop.py) run on the
card, whose torch ops round as the kernel's (on the CPU torch's sqrt is
MKL's, within an ulp),
within f32 rounding of today's autograd ``tv_loss`` + ``_rmsprop``, and three
``PlenoxelsTrainer`` steps on CUDA against the same steps through the
autograd path.  Skips without a CUDA device: the kernel has no CPU mode.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tv_rmsprop_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from flnerf_tpu_torch.models import voxel_sh as vs
from flnerf_tpu_torch.ops import tv_rmsprop as tr
from flnerf_tpu_torch.ops import voxel_kernel
from flnerf_tpu_torch.train import plenoxels_trainer as pt

BETA = 0.95


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tv_rmsprop kernel has no CPU mode")
    return torch.device("cuda")


def _fields(shape, c, alive_frac, seed=0, rms_lo=0.5):
    """CPU param, grad, rms ([X, Y, Z] for c = 0, else [X, Y, Z, c]) and alive."""
    rng = np.random.default_rng(seed)
    full = shape if c == 0 else shape + (c,)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    p = t(rng.standard_normal(full))
    g = t(0.1 * rng.standard_normal(full))
    rms = t(0.01 * rng.uniform(rms_lo, 1.5, full)) if rms_lo > 0 else torch.zeros(full)
    alive = torch.tensor(rng.random(shape) < alive_frac)
    return p, g, rms, alive


def _lam(shape):
    return 0.02 * shape[0] * shape[1] * shape[2]


CASES = [((37, 20, 19), 0), ((37, 20, 19), 27), ((16, 16, 16), 27), ((24, 20, 16), 4),
         ((3, 1, 130), 27), ((1, 1, 1), 27)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c", CASES)
@pytest.mark.parametrize("alive_frac", [1.0, 0.6])
@pytest.mark.parametrize("with_tv", [True, False])
@pytest.mark.parametrize("rate", ["float", "table"])
def test_kernel_is_its_plain_version_bit_for_bit(cuda, shape, c, alive_frac, with_tv, rate):
    """Odd lines (not a multiple of any vector width), 1, 4 and 27 channels,
    random alive masks, faces and lam = 0: every operation is rounded on its
    own in the same order on both sides.  The rate by value, or read by the
    kernel from one float32 of a [K, 2] device table (the rest NaN), as the
    trainer's CUDA graph replays give it."""
    p, g, rms, alive = _fields(shape, c, alive_frac, seed=len(shape) + c)
    lam = _lam(shape) if with_tv else 0.0
    pd, gd, rd, ad = (t.to(cuda) for t in (p, g, rms, alive))
    lr = 0.01
    if rate == "table":
        table = torch.full((8, 2), float("nan"), device=cuda)
        table[5, 1] = lr
        lr = table[5, 1]
    before = tr.SWEEP_LAUNCHES, tr.PAIRS_LAUNCHES
    pairs = tr.live_pairs(ad)
    assert torch.equal(pairs.cpu(), tr.live_pairs_plain(alive))
    rms_plain = rd.clone()
    want = tr.tv_rmsprop_plain(pd, gd, rms_plain, pairs, lam, 0.01, BETA, torch.empty_like(pd))
    got = tr.tv_rmsprop(pd, gd, rd, pairs, lam, lr, BETA)
    torch.cuda.synchronize()
    assert (tr.SWEEP_LAUNCHES, tr.PAIRS_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(pd.cpu(), p)             # param is left as it was
    assert torch.equal(rd, rms_plain)
    assert torch.equal(got, want)
    # and the CPU's plain version within an ulp or two (its sqrt)
    rms_cpu = rms.clone()
    want_cpu = tr.tv_rmsprop(p, g, rms_cpu, tr.live_pairs(alive), lam, 0.01, BETA)
    torch.testing.assert_close(got.cpu(), want_cpu, rtol=3e-7, atol=1e-6 * 0.01)
    assert torch.equal(rd.cpu(), rms_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [0, 27])
def test_steps_in_a_row_swap_buffers(cuda, c):
    """Four sweeps in a row, the output and the parameters swapping each
    step as the trainer swaps them, starting from rms = 0: bit for bit the
    plain version's four steps."""
    shape = (37, 20, 19)
    p, _, rms, alive = _fields(shape, c, 0.8, rms_lo=0.0)
    rng = np.random.default_rng(5)
    grads = [torch.tensor(0.1 * rng.standard_normal(p.shape), dtype=torch.float32)
             for _ in range(4)]
    pairs = tr.live_pairs(alive.to(cuda))
    pc, rc, spare_c = p.to(cuda), rms.to(cuda), torch.empty_like(p, device=cuda)
    pd, rd, spare_d = pc.clone(), rc.clone(), torch.empty_like(spare_c)
    for k, g in enumerate(grads):
        lr = 0.01 / (k + 1)
        g = g.to(cuda)
        new_c = tr.tv_rmsprop_plain(pc, g, rc, pairs, _lam(shape), lr, BETA, spare_c)
        new_d = tr.tv_rmsprop(pd, g, rd, pairs, _lam(shape), lr, BETA, out=spare_d)
        assert new_d.data_ptr() == spare_d.data_ptr()
        pc, spare_c = new_c, pc
        pd, spare_d = new_d, pd
    torch.cuda.synchronize()
    assert torch.equal(pd, pc) and torch.equal(rd, rc)
    assert float((pc.cpu() - p).abs().min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c", [((37, 20, 19), 0), ((37, 20, 19), 27)])
def test_kernel_matches_autograd_tv_and_rmsprop_on_card(cuda, shape, c):
    """Today's path on the card: lam * tv_loss through autograd, added to
    the gradient, _rmsprop.  f32 rounding in another order (as the CPU test
    of the plain version)."""
    p, g, rms, alive = _fields(shape, c, 0.7, seed=3)
    pd, gd, rd, ad = (t.to(cuda) for t in (p, g, rms, alive))
    lam, lr = _lam(shape), 0.01
    r_k = rd.clone()
    out = tr.tv_rmsprop(pd, gd, r_k, tr.live_pairs(ad), lam, lr, BETA)
    leaf = pd.clone().requires_grad_(True)
    (tv_grad,) = torch.autograd.grad(lam * vs.tv_loss(leaf, ad), [leaf])
    p_ref, r_ref = pd.clone(), rd.clone()
    pt.PlenoxelsTrainer._rmsprop(SimpleNamespace(cfg=SimpleNamespace(rms_beta=BETA)),
                                 p_ref, r_ref, gd + tv_grad, lr)
    torch.testing.assert_close(r_k, r_ref, rtol=2e-6, atol=0)
    torch.testing.assert_close(out, p_ref, rtol=1e-6, atol=1e-5 * lr)


def _trainer(cuda, fused: bool, tv_sparsity=1.0):
    reso = 32
    gcfg = vs.VoxelGridConfig(reso=(reso,) * 3, radius=(1.2,) * 3,
                              max_steps=int(3.5 * reso / 0.5), step_size=0.5)
    tcfg = pt.PlenoxelsTrainConfig(batch_size=256, tv_sparsity=tv_sparsity)
    t = pt.PlenoxelsTrainer(gcfg, tcfg, device=cuda)
    assert t.fused_sweep and t.use_kernel
    assert t._sweep_tv == (tv_sparsity >= 1.0)
    t.fused_sweep = fused
    t._sweep_tv = fused and tv_sparsity >= 1.0
    rng = np.random.default_rng(0)
    s = (reso,) * 3
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    grid = vs.VoxelGrid(f(rng.random(s) * 2.0), f(rng.standard_normal(s + (27,)) * 0.3),
                        torch.tensor(rng.random(s) > 0.1, device=cuda))
    t.state = pt.PlenoxelsState(grid, torch.zeros(s, device=cuda),
                                torch.zeros(s + (27,), device=cuda), 0)
    batches = []
    for _ in range(3):
        u = rng.standard_normal((256, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        d = u + 0.3 * rng.standard_normal((256, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        batches.append((f(-2.5 * u), f(d), f(rng.random((256, 3))),
                        torch.zeros(256, dtype=torch.long, device=cuda),
                        torch.ones(256, device=cuda)))
    return t, batches


@pytest.mark.cuda
@pytest.mark.parametrize("tv_sparsity", [1.0, 0.25])
def test_trainer_steps_on_card_match_the_autograd_path(cuda, tv_sparsity):
    """Three steps of the trainer on CUDA with the sweep (one launch for
    density and one for SH a step, the live pairs once) against the same steps through autograd
    ``tv_loss`` + ``_rmsprop``, from the same grid and batches."""
    states = []
    for fused in (True, False):
        t, batches = _trainer(cuda, fused, tv_sparsity)
        first = (t.state.grid.density, t.state.grid.sh)
        p0 = [x.cpu() for x in first]
        tr.reset_launch_counts()
        voxel_kernel.reset_launch_counts()
        err = (torch.zeros(4, device=cuda), torch.zeros(4, device=cuda))
        for b in batches:
            t._step(*b, *err)
        torch.cuda.synchronize()
        assert tr.SWEEP_LAUNCHES == (6 if fused else 0)
        # the pairs once for the grid's alive mask, not once a step
        assert tr.PAIRS_LAUNCHES == (1 if fused and tv_sparsity == 1.0 else 0)
        assert voxel_kernel.BWD_LAUNCHES == 3
        if fused:
            # the buffers swapped each step: after 3 the state holds the
            # first step's new buffer, and the grid's first is the spare
            assert t.state.grid.density is not first[0]
            assert t._spare["density"] is first[0] and t._spare["sh"] is first[1]
        states.append([x.cpu() for x in (t.state.grid.density, t.state.grid.sh,
                                         t.state.rms_density, t.state.rms_sh)])
    # f32 rounding of the TV and of K2's atomics, carried through 3 steps:
    # 1e-5 of the change norm-wise, 1e-4 of the largest change cell by cell
    for k, (a, b) in enumerate(zip(*states)):
        ref = b - p0[k] if k < 2 else b
        assert float(torch.linalg.vector_norm(a - b)) <= 1e-5 * float(torch.linalg.vector_norm(ref))
        assert float((a - b).abs().max()) <= 1e-4 * float(ref.abs().max())
