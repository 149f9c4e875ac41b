"""What the Plenoxels trainer's one-CUDA-graph-a-chunk path rests on, on the
CPU: the rule that admits a chunk (``plenoxels_trainer.graph_rule``), the
device table of learning rates (``lr_rows``) against ``expon_lr`` bit for
bit, the sweep's rate given as a tensor against the float, the grid's cached
constants (``voxel_sh.grid_constants``) against the tensors each call made
before, and the recorder's detached mode that a capture records in.  The
graph itself runs only on the card: tests/test_torch_plenoxels_graph_cuda.py."""

import numpy as np
import pytest
import torch

from flnerf_tpu_torch.core.logging_utils import PhaseTimers
from flnerf_tpu_torch.models import voxel_sh as vs
from flnerf_tpu_torch.ops import tv_rmsprop as tr
from flnerf_tpu_torch.train import plenoxels_trainer as pt

torch.set_num_threads(1)

BETA = 0.95


# -- the rule --------------------------------------------------------------
ALL_IN = dict(device="cuda", use_kernel=True, sweep_tv=True, background=False,
              learned_basis=False, lambda_tv_lumisphere=0.0, world=1, live=[True] * 8)


def test_rule_admits_a_whole_live_chunk_of_the_plain_configuration():
    assert pt.graph_rule(**ALL_IN)
    assert pt.graph_rule(**dict(ALL_IN, device=torch.device("cuda", 0)))
    assert pt.graph_rule(**dict(ALL_IN, live=[True]))


@pytest.mark.parametrize("change", [
    {"device": "cpu"},
    {"use_kernel": False},
    {"sweep_tv": False},
    {"background": True},
    {"learned_basis": True},
    {"lambda_tv_lumisphere": 1e-3},
    {"world": 2},
    {"live": [True] * 7 + [False]},
    {"live": [False] + [True] * 7},
    {"live": [False] * 8},
    {"live": []},
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items())[:40])
def test_rule_refuses_each_exclusion(change):
    assert not pt.graph_rule(**dict(ALL_IN, **change))


def _trainer(**tcfg):
    gcfg = vs.VoxelGridConfig(reso=(8, 8, 8), max_steps=56)
    return pt.PlenoxelsTrainer(gcfg, pt.PlenoxelsTrainConfig(**tcfg), device="cpu")


def test_cpu_trainer_never_takes_the_graph():
    t = _trainer()
    assert not t._graphs_chunk([True] * t.cfg.steps_per_chunk)


def test_trainer_passes_its_options_to_the_rule(monkeypatch):
    """The trainer's own configuration reaches each argument of the rule."""
    seen = []
    monkeypatch.setattr(pt, "graph_rule", lambda *a: seen.append(a) or False)
    t = _trainer(lambda_tv_lumisphere=2e-3)
    t._graphs_chunk([True, False])
    assert seen == [(t.device, t.use_kernel, False, False, False, 2e-3, 1, [True, False])]


# -- the rates on the device -----------------------------------------------
CFGS = [pt.PlenoxelsTrainConfig(),
        pt.PlenoxelsTrainConfig(lr_decay_steps=40, lr_sigma_delay_steps=60, lr_sigma=7.0,
                                lr_sigma_final=0.3, lr_sh=0.02, lr_sh_final=1e-4,
                                lr_sigma_delay_mult=0.1),
        pt.PlenoxelsTrainConfig(lr_decay_steps=100, lr_sigma_delay_steps=0)]


@pytest.mark.parametrize("cfg", CFGS, ids=["syn", "delay-past-decay", "no-delay"])
def test_rate_rows_are_expon_lr_bit_for_bit(cfg):
    """Row min(step, T) + k of ``lr_rows`` is ``float(expon_lr(step + k))``
    of either field, at steps 0, 1, the delay's end, lr_decay_steps and
    beyond, as a replay at ``step`` reads them."""
    K = 8
    rows = pt.lr_rows(cfg, K)
    T = rows.shape[0] - K
    assert T == max(cfg.lr_decay_steps, cfg.lr_sigma_delay_steps, 1)
    assert rows.dtype == torch.float32
    d = cfg.lr_sigma_delay_steps
    starts = sorted({0, 1, max(d - 3, 0), d, d + 1, cfg.lr_decay_steps - 4, cfg.lr_decay_steps,
                     T - 1, T, T + 5, 3 * T + 17})
    for s in starts:
        for k in range(K):
            got = rows[min(s, T) + k]
            want_density = pt.expon_lr(s + k, cfg.lr_sigma, cfg.lr_sigma_final, d,
                                       cfg.lr_sigma_delay_mult, cfg.lr_decay_steps)
            want_sh = pt.expon_lr(s + k, cfg.lr_sh, cfg.lr_sh_final, 0, 1.0, cfg.lr_decay_steps)
            assert float(got[0]) == float(want_density), (s, k)
            assert float(got[1]) == float(want_sh), (s, k)


def test_rate_rows_every_step_of_a_short_schedule():
    cfg = CFGS[1]
    rows = pt.lr_rows(cfg, 3)
    for s in range(rows.shape[0]):
        assert float(rows[s, 0]) == float(pt.expon_lr(
            s, cfg.lr_sigma, cfg.lr_sigma_final, cfg.lr_sigma_delay_steps,
            cfg.lr_sigma_delay_mult, cfg.lr_decay_steps))
        assert float(rows[s, 1]) == float(pt.expon_lr(s, cfg.lr_sh, cfg.lr_sh_final, 0, 1.0,
                                                      cfg.lr_decay_steps))


SYN_ROWS = pt.lr_rows(pt.PlenoxelsTrainConfig(), 8)
SHARDS = 10


@pytest.mark.parametrize("shard", range(SHARDS))
@pytest.mark.parametrize("field", ["density", "sh"])
def test_rate_rows_every_step_of_the_syn_schedule(field, shard):
    """Every row of syn.json's table (250,008 steps, in shards) against the
    0-d call the step-by-step path makes at that step: the whole-table call's
    exp, log and sin give each step's float32 value bit for bit."""
    cfg = pt.PlenoxelsTrainConfig()
    col = SYN_ROWS[:, 0 if field == "density" else 1].tolist()
    args = ((cfg.lr_sigma, cfg.lr_sigma_final, cfg.lr_sigma_delay_steps, cfg.lr_sigma_delay_mult)
            if field == "density" else (cfg.lr_sh, cfg.lr_sh_final, 0, 1.0))
    n = len(col)
    bad = [s for s in range(shard * n // SHARDS, (shard + 1) * n // SHARDS)
           if col[s] != float(pt.expon_lr(s, *args, cfg.lr_decay_steps))]
    assert not bad, (len(bad), bad[:10])


def _fields(shape, c, seed=0):
    rng = np.random.default_rng(seed)
    full = shape if c == 0 else shape + (c,)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    return (t(rng.standard_normal(full)), t(0.1 * rng.standard_normal(full)),
            t(0.01 * rng.uniform(0.5, 1.5, full)), torch.tensor(rng.random(shape) < 0.7))


@pytest.mark.parametrize("c", [0, 27])
@pytest.mark.parametrize("lam", [0.0, 30.0])
@pytest.mark.parametrize("lr", [0.01, float(np.float32(2.9671e-5)), 30.0])
def test_sweep_rate_as_a_tensor_is_the_float_bit_for_bit(c, lam, lr):
    """``tv_rmsprop_plain`` and the wrapper with ``lr`` a float32 scalar
    tensor (a view into a [K, 2] table, as a captured step gives it) against
    the float form: the same parameters and state, bit for bit."""
    shape = (7, 5, 6)
    p, g, rms, alive = _fields(shape, c, seed=c + int(lam))
    pairs = tr.live_pairs(alive)
    table = torch.tensor([[0.5, lr], [lr, 0.25]], dtype=torch.float32)
    want_rms = rms.clone()
    want = tr.tv_rmsprop_plain(p, g, want_rms, pairs, lam, lr, BETA, torch.empty_like(p))
    for fn in (lambda r, lr_t: tr.tv_rmsprop_plain(p, g, r, pairs, lam, lr_t, BETA,
                                                   torch.empty_like(p)),
               lambda r, lr_t: tr.tv_rmsprop(p, g, r, pairs, lam, lr_t, BETA)):
        for lr_t in (table[0, 1], table[1, :1], torch.tensor(lr)):
            got_rms = rms.clone()
            got = fn(got_rms, lr_t)
            assert torch.equal(got, want)
            assert torch.equal(got_rms, want_rms)


@pytest.mark.parametrize("bad", [torch.tensor([0.01, 0.02]), torch.tensor(0.01, dtype=torch.float64),
                                 torch.tensor([], dtype=torch.float32)],
                         ids=["two", "float64", "empty"])
def test_sweep_refuses_a_rate_tensor_of_the_wrong_form(bad):
    p, g, rms, alive = _fields((4, 3, 5), 0)
    with pytest.raises(ValueError, match="tensor lr"):
        tr.tv_rmsprop(p, g, rms, tr.live_pairs(alive), 1.0, bad, BETA)


# -- the grid's constants --------------------------------------------------
GCFGS = [vs.VoxelGridConfig(), vs.VoxelGridConfig(reso=(256, 256, 256), radius=(1.5, 1.5, 1.5)),
         vs.VoxelGridConfig(reso=(37, 20, 19), radius=(1.3, 0.7, 2.1), center=(0.1, -0.4, 0.25)),
         vs.VoxelGridConfig(reso=(3, 1, 130), radius=(1.0, 1.0, 3.0), center=(0.0, 0.5, 0.0))]


def _old_constants(cfg, device):
    """The tensors each call made before the cache."""
    f32 = torch.float32
    reso = torch.tensor(cfg.reso, dtype=f32, device=device)
    radius = torch.tensor(cfg.radius, dtype=f32, device=device)
    scaling = 0.5 * reso / radius
    center = torch.tensor(cfg.center, dtype=f32, device=device)
    return (reso, scaling, 0.5 * reso - center * scaling,
            torch.tensor([r - 1.0 for r in cfg.reso], device=device),
            torch.tensor(cfg.reso, dtype=torch.long, device=device))


def _old_ray_setup(cfg, rays_o, rays_d):
    """grid_ray_setup as it was, its constants made on each call."""
    reso = torch.tensor(cfg.reso, dtype=torch.float32, device=rays_o.device)
    center = torch.tensor(cfg.center, dtype=torch.float32, device=rays_o.device)
    radius = torch.tensor(cfg.radius, dtype=torch.float32, device=rays_o.device)
    scaling = 0.5 * reso / radius
    origins = rays_o * scaling + (0.5 * reso - center * scaling) - 0.5
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dirs = viewdirs * (0.5 * reso / radius)
    delta_scale = 1.0 / torch.linalg.norm(dirs, dim=-1)
    dirs = dirs * delta_scale[..., None]
    gsz = torch.tensor(cfg.reso, dtype=torch.float32, device=rays_o.device)
    parallel = torch.abs(dirs) < 1e-9
    safe_dirs = torch.where(parallel, 1e-9, dirs)
    invdirs = 1.0 / safe_dirs
    t1 = (-0.5 - origins) * invdirs
    t2 = (gsz - 0.5 - origins) * invdirs
    tmin = torch.where(parallel, -1e9, torch.minimum(t1, t2)).amax(-1)
    tmin = torch.clamp(tmin, min=cfg.near_clip)
    tmax = torch.where(parallel, 1e9, torch.maximum(t1, t2)).amin(-1)
    inside_slab = (origins >= -0.5) & (origins <= gsz - 0.5)
    miss = torch.any(parallel & ~inside_slab, dim=-1)
    tmax = torch.where(miss, tmin - 1.0, tmax)
    return origins, dirs, tmin, tmax, delta_scale, viewdirs


@pytest.mark.parametrize("cfg", GCFGS, ids=["default", "syn-256", "odd", "thin"])
def test_cached_constants_are_the_old_tensors(cfg):
    got = vs.grid_constants(cfg, "cpu")
    for a, b in zip(got, _old_constants(cfg, "cpu")):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # made once per (reso, radius, center, device), whatever else differs
    assert vs.grid_constants(cfg._replace(step_size=0.25, max_steps=9), torch.device("cpu")) is got
    assert torch.equal(vs.grid_scaling(cfg), got.scaling)


def test_cached_constants_are_normal_tensors_under_inference_mode():
    cfg = vs.VoxelGridConfig(reso=(11, 12, 13), radius=(0.9, 1.1, 1.3))
    with torch.inference_mode():
        c = vs.grid_constants(cfg, "cpu")
    assert not any(t.is_inference() for t in c)
    pts = torch.randn(4, 3, requires_grad=True)
    vs.world2grid(cfg, pts).sum().backward()
    assert torch.equal(pts.grad, c.scaling.expand(4, 3))


@pytest.mark.parametrize("cfg", GCFGS, ids=["default", "syn-256", "odd", "thin"])
def test_grid_ray_setup_is_unchanged(cfg):
    """Rays from inside, outside and along the axes (the parallel and miss
    cases) through today's grid_ray_setup and the one before the cache."""
    rng = np.random.default_rng(len(cfg.reso) + cfg.reso[0])
    o = rng.standard_normal((300, 3)) * 2.0
    d = rng.standard_normal((300, 3))
    d[:20] = np.eye(3)[rng.integers(0, 3, 20)] * rng.choice([-1.0, 1.0], (20, 1))
    o[:10] = 5.0
    rays_o = torch.tensor(o, dtype=torch.float32)
    rays_d = torch.tensor(d, dtype=torch.float32)
    for a, b in zip(vs.grid_ray_setup(cfg, rays_o, rays_d), _old_ray_setup(cfg, rays_o, rays_d)):
        assert torch.equal(a, b)


# -- the recorder's detached mode -----------------------------------------
@pytest.mark.parametrize("on", [False, True])
def test_detached_keeps_counters_and_leaves_the_recorder_as_it_was(on):
    rec = PhaseTimers()
    if on:
        rec.enable()
    with rec.span("outer"):
        rec.count("kept", 2)
        before = rec.snapshot()
        with rec.detached() as got:
            assert rec.on
            with rec.span("flnerf.train.step"):
                rec.count("flnerf.train.fused_sweeps", 2)
            rec.count("flnerf.train.fused_sweeps", 2)
        assert got == {"flnerf.train.fused_sweeps": 4}
        assert rec.on == on
        assert rec.snapshot() == before
    snap = rec.snapshot()
    assert "flnerf.train.step" not in snap["counts"]
    if on:
        assert snap["counts"] == {"outer": 1} and snap["counters"] == {"kept": 2}
        # the capture's span added no child time to the span it ran in
        assert snap["self_s"]["outer"] == snap["totals"]["outer"]
    else:
        assert snap["spans"] == [] and snap["counters"] == {}
