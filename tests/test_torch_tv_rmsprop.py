"""The dense TV gradient + RMSProp sweep (flnerf_tpu_torch/ops/tv_rmsprop.py)
on the CPU: its plain version against the JAX package (``jax.grad`` of its
``tv_loss`` and its trainer's RMSProp) and against autograd of the port's
``tv_loss`` and the trainer's ``_rmsprop``, the wrapper's checks, and the CPU
trainer, which keeps the autograd path bit for bit and never launches the
kernel.  tests/test_torch_tv_rmsprop_cuda.py holds the kernel to the plain
version bit for bit on the card."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flnerf_tpu.models import voxel_sh as vs_ref
from flnerf_tpu.train import plenoxels_trainer as pt_ref
from flnerf_tpu_torch.core.logging_utils import RECORDER
from flnerf_tpu_torch.models import voxel_sh as vs
from flnerf_tpu_torch.ops import tv_rmsprop as tr
from flnerf_tpu_torch.train import plenoxels_trainer as pt

torch.set_num_threads(1)

BETA = 0.95


def _fields(shape, c, alive_frac, seed=0, rms_lo=0.5):
    """param, grad, rms ([X, Y, Z] for c = 0, else [X, Y, Z, c]) and alive."""
    rng = np.random.default_rng(seed)
    full = shape if c == 0 else shape + (c,)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    p = t(rng.standard_normal(full))
    g = t(0.1 * rng.standard_normal(full))
    # rms > 0: the update's sensitivity to its gradient's last bits is
    # lr / sqrt(rms), so the comparison measures rounding, not 1 / eps
    rms = t(0.01 * rng.uniform(rms_lo, 1.5, full)) if rms_lo > 0 else torch.zeros(full)
    alive = torch.tensor(rng.random(shape) < alive_frac)
    return p, g, rms, alive


def _autograd_step(p, g, rms, alive, lam, lr):
    """Today's trainer arithmetic: lam * tv_loss through autograd, added to
    the gradient, then PlenoxelsTrainer._rmsprop; returns (p, rms)."""
    p, rms = p.clone(), rms.clone()
    leaf = p.clone().requires_grad_(True)
    (tv_grad,) = torch.autograd.grad(lam * vs.tv_loss(leaf, alive), [leaf])
    holder = SimpleNamespace(cfg=SimpleNamespace(rms_beta=BETA))
    pt.PlenoxelsTrainer._rmsprop(holder, p, rms, g + tv_grad, lr)
    return p, rms


def _lam(shape):
    # a TV gradient of the data gradient's size: 2 lam / n * (a few O(1) diffs) ~ 0.1
    return 0.02 * shape[0] * shape[1] * shape[2]


@pytest.mark.parametrize("shape", [(7, 5, 6), (1, 4, 3), (37, 20, 19)])
@pytest.mark.parametrize("c", [0, 27])
@pytest.mark.parametrize("alive_frac", [1.0, 0.7])
@pytest.mark.parametrize("with_tv", [True, False])
def test_plain_matches_autograd_tv_and_rmsprop(shape, c, alive_frac, with_tv):
    p, g, rms, alive = _fields(shape, c, alive_frac)
    lam, lr = (_lam(shape) if with_tv else 0.0), 0.01
    rms_plain, p0 = rms.clone(), p.clone()
    out = tr.tv_rmsprop(p, g, rms_plain, tr.live_pairs(alive), lam, lr, BETA)
    assert torch.equal(p, p0)                     # param is left as it was
    p_ref, rms_ref = _autograd_step(p, g, rms, alive, lam, lr)
    # f32 rounding of ~10 operations in another order: the state to 2e-6
    # relative; the update (up to ~lr * 0.5 / sqrt(0.95 * 0.005) ~ 7 lr)
    # to 1e-5 lr, besides p's own last bits
    torch.testing.assert_close(rms_plain, rms_ref, rtol=2e-6, atol=0)
    torch.testing.assert_close(out, p_ref, rtol=1e-6, atol=1e-5 * lr)
    moved = (out - p).abs()
    assert float(moved.min()) > 0                 # every cell is updated
    if with_tv:
        _, rms_no_tv = _autograd_step(p, g, rms, alive, 0.0, lr)
        # the TV term moved the state wherever a live pair exists
        assert float((rms_ref - rms_no_tv).abs().max()) > 1e-4


def _jax_step(p, g, rms, alive, lam, lr):
    """The JAX package's arithmetic on the same inputs: ``jax.grad`` of
    lam * tv_loss added to the data gradient, then RMSProp as its trainer
    writes it (flnerf_tpu/train/plenoxels_trainer.py, the rmsprop_step of
    optim_kernel.cu:28); returns (p, rms)."""
    pj, aj = jnp.asarray(p.numpy()), jnp.asarray(alive.numpy())
    gg = jnp.asarray(g.numpy()) + jax.grad(lambda f: lam * vs_ref.tv_loss(f, aj))(pj)
    b = BETA
    rms_new = b * jnp.asarray(rms.numpy()) + (1 - b) * gg ** 2
    new = pj - lr * gg / (jnp.sqrt(rms_new) + 1e-8)
    return torch.from_numpy(np.array(new)), torch.from_numpy(np.array(rms_new))


@pytest.mark.parametrize("shape", [(1, 4, 3), (2, 7, 3), (37, 20, 19)])
@pytest.mark.parametrize("c", [0, 1, 27])
@pytest.mark.parametrize("alive_frac", [1.0, 0.6])
@pytest.mark.parametrize("with_tv", [True, False])
def test_plain_matches_the_jax_package(shape, c, alive_frac, with_tv):
    """The sweep the card runs, through its plain version, against the JAX
    package's TV gradient and RMSProp, at the same float32 learning rate
    (its expon_lr at step 1000 of syn.json's SH schedule), over thin grids
    whose cells are mostly on a face, random alive masks and a TV weight
    of 0."""
    p, g, rms, alive = _fields(shape, c, alive_frac, seed=3)
    lam = _lam(shape) if with_tv else 0.0
    lr_j = pt_ref.expon_lr(jnp.float32(1000.0), 1e-2, 5e-6, 0, 1.0, 250000)
    rms_ours = rms.clone()
    out = tr.tv_rmsprop(p, g, rms_ours, tr.live_pairs(alive), lam, float(lr_j), BETA)
    p_ref, rms_ref = _jax_step(p, g, rms, alive, lam, lr_j)
    # f32 rounding of ~10 operations in another order, as against autograd
    lr = float(lr_j)
    torch.testing.assert_close(rms_ours, rms_ref, rtol=2e-6, atol=0)
    torch.testing.assert_close(out, p_ref, rtol=1e-6, atol=1e-5 * lr)
    if with_tv and alive_frac == 1.0:
        # the TV term reached the state of (almost) every entry on each of
        # the grid's six faces
        _, rms_no_tv = _jax_step(p, g, rms, alive, 0.0, lr_j)
        moved = (rms_ref != rms_no_tv).float()
        for dim in range(3):
            for i in (0, -1):
                assert float(moved.select(dim, i).mean()) > 0.95


@pytest.mark.parametrize("c", [0, 27])
def test_plain_matches_autograd_from_a_zero_state(c):
    """From rms = 0 (a fresh trainer) the new state is (1 - beta) * g^2 per
    cell: it checks the summed gradient cell by cell, TV faces included."""
    shape = (9, 6, 5)
    p, g, rms, alive = _fields(shape, c, 0.6, seed=1, rms_lo=0.0)
    out = tr.tv_rmsprop(p, g, rms, tr.live_pairs(alive), _lam(shape), 0.01, BETA)
    p_ref, rms_ref = _autograd_step(p, g, torch.zeros_like(rms), alive, _lam(shape), 0.01)
    # where the data and TV terms cancel, g^2 keeps only the rounding of
    # its terms (~1e-7 of them): 2e-6 relative, or 1e-6 of the largest state
    torch.testing.assert_close(rms, rms_ref, rtol=2e-6, atol=1e-6 * float(rms_ref.max()))
    assert torch.isfinite(out).all()


def test_dead_cells_and_faces_take_no_tv():
    """A dead cell, and a pair with a dead side, add no TV: on an all-dead
    grid with lam > 0 the sweep is RMSProp alone, bit for bit."""
    shape = (5, 4, 3)
    p, g, rms, _ = _fields(shape, 27, 1.0)
    dead = torch.zeros(shape, dtype=torch.bool)
    r1, r2 = rms.clone(), rms.clone()
    assert int(tr.live_pairs(dead).max()) == 0
    a = tr.tv_rmsprop(p, g, r1, tr.live_pairs(dead), _lam(shape), 0.01, BETA)
    b = tr.tv_rmsprop(p, g, r2, None, 0.0, 0.01, BETA)
    assert torch.equal(a, b) and torch.equal(r1, r2)


@pytest.mark.parametrize("bad", ["dtype", "shape", "noncontiguous", "pairs_dtype",
                                 "no_pairs", "aliased_out", "ndim"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    p, g, rms, alive = _fields((4, 5, 6), 27, 0.8)
    pairs, out = tr.live_pairs(alive), torch.empty_like(p)
    if bad == "dtype":
        g = g.double()
    elif bad == "shape":
        rms = rms[:, :, :5]
    elif bad == "noncontiguous":
        g = g.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "pairs_dtype":
        pairs = alive
    elif bad == "no_pairs":
        pairs = None
    elif bad == "aliased_out":
        out = p
    elif bad == "ndim":
        p, g, rms, out = (t.reshape(4, 5, 6, 27, 1) for t in (p, g, rms, out))
    with pytest.raises(ValueError):
        tr.tv_rmsprop(p, g, rms, pairs, 1.0, 0.01, BETA, out=out)


@pytest.mark.parametrize("bad", ["dtype", "ndim", "noncontiguous"])
def test_live_pairs_raises_on_what_the_kernel_does_not_take(bad):
    alive = torch.ones((4, 5, 6), dtype=torch.bool)
    alive = {"dtype": alive.to(torch.uint8), "ndim": alive[None],
             "noncontiguous": alive.transpose(0, 2)}[bad]
    with pytest.raises(ValueError):
        tr.live_pairs(alive)


@pytest.mark.parametrize("shape", [(5, 4, 3), (1, 6, 2), (3, 1, 1)])
def test_live_pairs_are_tv_losss_counted_differences(shape):
    """Bit d of a cell is set exactly when its neighbour d lies inside the
    grid and both are alive: tv_loss's rule for a forward difference."""
    alive = torch.tensor(np.random.default_rng(2).random(shape) < 0.6)
    bits = tr.live_pairs(alive).numpy()
    a = alive.numpy()
    for x, y, z in np.ndindex(*shape):
        for d, (dim, step) in enumerate(tr.NEIGHBOURS):
            n = [x, y, z]
            n[dim] += step
            inside = 0 <= n[dim] < shape[dim]
            want = bool(inside and a[x, y, z] and a[tuple(n)])
            assert bool((bits[x, y, z] >> d) & 1) == want
    assert int(bits.max()) < 64


def _cpu_trainer(tv_sparsity=1.0, seed=0):
    gcfg = vs.VoxelGridConfig(reso=(12, 12, 12), radius=(1.2,) * 3, max_steps=48,
                              step_size=0.5)
    tcfg = pt.PlenoxelsTrainConfig(batch_size=128, tv_sparsity=tv_sparsity,
                                   lambda_tv=1e-2, lambda_tv_sh=1e-1)
    t = pt.PlenoxelsTrainer(gcfg, tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    s = (12, 12, 12)
    grid = vs.VoxelGrid(torch.tensor(rng.random(s) * 2.0, dtype=torch.float32),
                        torch.tensor(rng.standard_normal(s + (27,)) * 0.3, dtype=torch.float32),
                        torch.tensor(rng.random(s) > 0.2))
    t.state = pt.PlenoxelsState(grid, torch.zeros(s), torch.zeros(s + (27,)), 0)
    u = rng.standard_normal((128, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d = u + 0.3 * rng.standard_normal((128, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    batch = (f(-2.5 * u), f(d), f(rng.random((128, 3))), torch.zeros(128, dtype=torch.long),
             torch.ones(128))
    return t, batch


def _old_cpu_step(t, batch):
    """The CPU trainer's step as it stood before the sweep: the masked MSE
    and dense TV through autograd, the gradients summed, _rmsprop in place."""
    cfg, st = t.cfg, t.state
    o, d, rgb, _, m = batch
    leaves = [st.grid.density.detach().clone().requires_grad_(True),
              st.grid.sh.detach().clone().requires_grad_(True)]
    grid = vs.VoxelGrid(leaves[0], leaves[1], st.grid.alive)
    out = vs.voxel_render_rays(grid, o, d, t.gcfg)["rgb"]
    denom = torch.clamp(torch.sum(m), min=1.0) * 3.0
    sq = torch.sum(m[:, None] * (out - rgb) ** 2)
    reg = (cfg.lambda_tv * vs.tv_loss(leaves[0], st.grid.alive)
           + cfg.lambda_tv_sh * vs.tv_loss(leaves[1], st.grid.alive))
    grads = list(torch.autograd.grad(sq / denom, leaves))
    grads = [g.add_(r) for g, r in zip(grads, torch.autograd.grad(reg, leaves))]
    p = [x.detach().clone() for x in leaves]
    rms = [st.rms_density.clone(), st.rms_sh.clone()]
    lr = lambda *a: float(pt.expon_lr(st.step, *a, cfg.lr_decay_steps))
    t._rmsprop(p[0], rms[0], grads[0], lr(cfg.lr_sigma, cfg.lr_sigma_final,
                                         cfg.lr_sigma_delay_steps, cfg.lr_sigma_delay_mult))
    t._rmsprop(p[1], rms[1], grads[1], lr(cfg.lr_sh, cfg.lr_sh_final, 0, 1.0))
    return p + rms


def test_cpu_trainer_steps_stay_bit_for_bit_and_launch_nothing():
    t, batch = _cpu_trainer()
    assert not t.fused_sweep
    tr.reset_launch_counts()
    RECORDER.reset()
    RECORDER.enable()
    try:
        err = (torch.zeros(4), torch.zeros(4))
        for _ in range(3):
            want = _old_cpu_step(t, batch)
            t._step(*batch, *err)
            st = t.state
            for got, w in zip((st.grid.density, st.grid.sh, st.rms_density, st.rms_sh), want):
                assert torch.equal(got, w)
        counters = RECORDER.snapshot()["counters"]
    finally:
        RECORDER.disable()
        RECORDER.reset()
    assert tr.SWEEP_LAUNCHES == 0
    assert "flnerf.train.fused_sweeps" not in counters
    assert t.state.step == 3


def test_cpu_trainer_keeps_its_grid_buffers_in_place():
    """On the CPU the step updates the state's tensors in place (no second
    buffer), as before the sweep, with the slab estimator too."""
    t, batch = _cpu_trainer(tv_sparsity=0.5)
    before = (t.state.grid.density, t.state.grid.sh)
    t._step(*batch, torch.zeros(4), torch.zeros(4))
    assert t.state.grid.density is before[0] and t.state.grid.sh is before[1]
    assert t._spare == {}


def test_trainer_computes_live_pairs_once_per_alive_mask():
    """The trainer keeps the live pairs of the grid's alive mask: the same
    mask gives the same tensor, a new mask (a pruned grid set from outside,
    or a resample) recomputes them."""
    t, _ = _cpu_trainer()
    alive = t.state.grid.alive
    first = t._live_pairs(alive)
    assert t._live_pairs(alive) is first
    assert torch.equal(first, tr.live_pairs(alive))
    pruned = alive & torch.tensor(np.random.default_rng(4).random(alive.shape) > 0.5)
    t.state = t.state._replace(grid=t.state.grid._replace(alive=pruned))
    again = t._live_pairs(t.state.grid.alive)
    assert torch.equal(again, tr.live_pairs(pruned)) and not torch.equal(again, first)
    t.resample((16, 16, 16), prune=False)
    assert t._pairs == (None, None)
    assert t._live_pairs(t.state.grid.alive).shape == (16, 16, 16)
