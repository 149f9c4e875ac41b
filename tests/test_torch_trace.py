"""The port's span and counter recorder (core/logging_utils.PhaseTimers,
``RECORDER``): off it costs a boolean check and no torch call; on, nested
spans keep their parents and self times on the profiler's clock, and both
trainers train bit for bit as with it off while recording one span per
step, refresh and transfer.  Also NGP's history stamps."""

import time

import numpy as np
import pytest
import torch

from flnerf_tpu_torch.core.logging_utils import RECORDER, PhaseTimers
from flnerf_tpu_torch.data.synthetic import load_synthetic_data
from flnerf_tpu_torch.models import hash_ngp as m
from flnerf_tpu_torch.models.voxel_sh import VoxelGridConfig
from flnerf_tpu_torch.rays.camera import get_rays_np, intrinsics_matrix
from flnerf_tpu_torch.rays.quadtree import RayBudgeter
from flnerf_tpu_torch.render import ngp as r
from flnerf_tpu_torch.train import ngp_trainer as t_ngp
from flnerf_tpu_torch.train import plenoxels_trainer as pt

torch.set_num_threads(1)


@pytest.fixture
def recorder():
    """The program's recorder, emptied, and off again afterwards."""
    RECORDER.disable()
    RECORDER.reset()
    yield RECORDER
    RECORDER.disable()
    RECORDER.reset()


def _raise(*a, **kw):
    raise AssertionError("a torch call with the recorder off")


def test_off_is_one_shared_noop(monkeypatch):
    assert not RECORDER.on                  # off by default
    rec = PhaseTimers()
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch, "sum", _raise)
    a, b = rec.span("flnerf.a"), rec.span("flnerf.b")
    assert a is b
    with a, rec.span("flnerf.c"):
        rec.count("flnerf.n", 3)
        rec.count_device("flnerf.d", torch.ones(3))

    @rec.spanned("flnerf.f")
    def f(x, y=1):
        return x + y

    assert f(1, y=2) == 3 and f.__name__ == "f"
    assert rec.take_device() == {}
    assert rec.snapshot() == {"spans": [], "totals": {}, "counts": {}, "self_s": {},
                              "counters": {}}


def test_nested_spans_parents_and_self_times():
    rec = PhaseTimers()
    rec.enable()
    with rec.span("flnerf.outer"):
        time.sleep(0.002)
        with rec.span("flnerf.inner"):
            time.sleep(0.003)
        with rec.span("flnerf.inner"):
            pass
    rec.spanned("flnerf.f")(lambda: None)()
    rec.count("flnerf.n")
    rec.count("flnerf.n", 4)
    snap = rec.snapshot()
    names = [(s[0], s[1]) for s in snap["spans"]]
    assert names == [("flnerf.inner", "flnerf.outer"), ("flnerf.inner", "flnerf.outer"),
                     ("flnerf.outer", None), ("flnerf.f", None)]
    (_, _, a0, a1), (_, _, b0, b1), (_, _, o0, o1) = snap["spans"][:3]
    assert o0 <= a0 <= a1 <= b0 <= b1 <= o1
    assert snap["counts"] == {"flnerf.inner": 2, "flnerf.outer": 1, "flnerf.f": 1}
    inner = (a1 - a0 + b1 - b0) / 1e9
    assert snap["totals"]["flnerf.inner"] == pytest.approx(inner, abs=1e-9)
    assert snap["self_s"]["flnerf.inner"] == pytest.approx(inner, abs=1e-9)
    assert snap["self_s"]["flnerf.outer"] == pytest.approx((o1 - o0) / 1e9 - inner, abs=1e-9)
    assert snap["totals"]["flnerf.inner"] >= 0.003
    assert snap["self_s"]["flnerf.outer"] >= 0.002
    assert snap["counters"] == {"flnerf.n": 5}
    # device counters wait for the program's next transfer
    rec.count_device("flnerf.d", torch.tensor([True, False, True]))
    rec.count_device("flnerf.d", torch.ones(2, 2))
    dev = rec.take_device()
    assert list(dev) == ["flnerf.d"] and float(dev["flnerf.d"]) == 6.0
    assert rec.take_device() == {}
    rec.disable()
    rec.add_counts({"flnerf.d": 6.0})
    assert rec.snapshot()["counters"] == {"flnerf.n": 5, "flnerf.d": 6.0}
    # a snapshot is a copy; reset forgets and keeps the state
    snap["spans"].clear()
    assert len(rec.spans) == 4
    rec.reset()
    assert not rec.on and rec.snapshot()["spans"] == [] and rec.counters == {}


def test_phase_timers_unchanged_beside_the_recorder():
    t = PhaseTimers()
    with t.phase("a"):
        pass
    t.enable()
    with t.span("flnerf.b"):
        pass
    assert t.counts == {"a": 1, "flnerf.b": 1}
    assert [line.split(":")[0] for line in t.summary().splitlines()] == sorted(
        ["a", "flnerf.b"], key=lambda k: -t.totals[k])


def test_span_lies_on_the_profilers_clock():
    rec = PhaseTimers()
    rec.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with rec.span("flnerf.clock"):
                time.sleep(0.005)
    marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events() if e.name() == "flnerf.clock")
    assert len(marks) == 3
    for (p0, p1), (_, _, s0, s1) in zip(marks, rec.spans):
        assert abs(s0 - p0) < 500_000 and abs(s1 - p1) < 500_000


# -- the trainers ------------------------------------------------------------
def _views(n=2, h=16):
    images, poses, _, hwf, _ = load_synthetic_data(n_train=n, n_test=0, H=h, W=h)
    K = intrinsics_matrix(h, h, hwf[2])
    rays = [get_rays_np(h, h, K, p[:3, :4]) for p in poses]
    return images, poses, K, np.stack([o for o, _ in rays]), np.stack([d for _, d in rays])


def _plenoxels_run(use_kernel, epochs=2):
    """Two epochs of the budget and the trainer at 16^3: (budgeter,
    trainer, [(leaf statistic, mse, rays)])."""
    images, _, _, origins, dirs = _views()
    budgeter = RayBudgeter(images, origins, dirs, init_level=2, seed=0)
    gcfg = VoxelGridConfig(reso=(16, 16, 16), radius=(1.2, 1.2, 1.2), max_steps=112)
    tcfg = pt.PlenoxelsTrainConfig(n_epoch=epochs, batch_size=128, steps_per_chunk=2)
    trainer = pt.PlenoxelsTrainer(gcfg, tcfg, device="cpu")
    trainer.use_kernel = use_kernel   # the coherence order, and K1/K2's plain twin
    out = []
    for e in range(epochs):
        epoch = budgeter.gen_rays(last_epoch=e == epochs - 1)
        stat, mse = trainer.run_epoch_rays(epoch)
        out.append((stat, mse, epoch.origins.shape[0]))
        if e == 0:
            budgeter.adjust(stat, 0.015)
    return budgeter, trainer, out


@pytest.mark.parametrize("use_kernel", [False, True])
def test_plenoxels_trains_bit_for_bit_with_the_recorder_on(recorder, use_kernel):
    b_off, t_off, out_off = _plenoxels_run(use_kernel)
    assert recorder.snapshot()["spans"] == []
    recorder.enable()
    b_on, t_on, out_on = _plenoxels_run(use_kernel)
    recorder.disable()
    for (s0, m0, n0), (s1, m1, n1) in zip(out_off, out_on):
        np.testing.assert_array_equal(s0, s1)
        assert (m0, n0) == (m1, n1)
    st0, st1 = t_off.state, t_on.state
    assert st0.step == st1.step
    for a, b in ((st0.grid.density, st1.grid.density), (st0.grid.sh, st1.grid.sh),
                 (st0.grid.alive, st1.grid.alive), (st0.rms_density, st1.rms_density),
                 (st0.rms_sh, st1.rms_sh)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(b_off.forest.boxes, b_on.forest.boxes)
    for g0, g1 in ((b_off.rng, b_on.rng), (t_off._order_rng, t_on._order_rng),
                   (t_off._tv_rng, t_on._tv_rng)):
        assert g0.bit_generator.state == g1.bit_generator.state

    snap = recorder.snapshot()
    steps = t_on.state.step
    assert steps > 0 and snap["counts"]["flnerf.train.step"] == steps
    for child in ("flnerf.train.forward", "flnerf.train.backward", "flnerf.train.optimizer"):
        assert snap["counts"][child] == steps
        assert {p for n, p, _, _ in snap["spans"] if n == child} == {"flnerf.train.step"}
    assert snap["counts"]["flnerf.io.drain"] == snap["counts"]["flnerf.io.upload"] == 2
    assert snap["counts"]["flnerf.budget.gen_rays"] == 2
    assert snap["counts"]["flnerf.budget.adjust"] == 1
    assert snap["counts"]["flnerf.budget.budgeter_init"] == 1
    assert snap["counts"].get("flnerf.budget.coherence_order", 0) == (2 if use_kernel else 0)
    assert snap["counters"]["flnerf.train.steps"] == steps
    assert snap["counters"]["flnerf.train.rays"] == sum(n for _, _, n in out_on)
    for name, (total, own) in {n: (snap["totals"][n], snap["self_s"][n])
                               for n in snap["totals"]}.items():
        assert 0.0 <= own <= total + 1e-9, name


def _ngp_trainer(error_map=False):
    rcfg = r.NGPRenderConfig(n_candidates=16, n_keep=8, grid_size=8, bound=1.0)
    tcfg = t_ngp.NGPTrainConfig(max_steps=16, batch_rays=32, steps_per_chunk=4,
                                ema_decay=0.95, use_prob_map=True, use_error_map=error_map)
    images, poses, K, _, _ = _views()
    sampler = t_ngp.NGPSampler(images, poses, K, tcfg, seed=3)
    trainer = t_ngp.NGPTrainer(m.NGPConfig(num_levels=4, log2_hashmap_size=10,
                                           desired_resolution=64, bound=1.0),
                               rcfg, tcfg, device="cpu")
    return sampler, trainer


def _ngp_run(error_map, calls=2, n_steps=8):
    sampler, trainer = _ngp_trainer(error_map)
    for _ in range(calls):
        trainer.fit(sampler, verbose=False, n_steps=n_steps)
    return sampler, trainer


@pytest.mark.parametrize("error_map", [False, True])
def test_ngp_trains_bit_for_bit_with_the_recorder_on(recorder, monkeypatch, error_map):
    kept = []
    march = t_ngp.march

    def counted(*a, **kw):
        out = march(*a, **kw)
        if recorder.on:
            kept.append(int(out[1].sum()))
        return out

    monkeypatch.setattr(t_ngp, "march", counted)
    s_off, t_off = _ngp_run(error_map)
    recorder.enable()
    s_on, t_on = _ngp_run(error_map)
    recorder.disable()
    for h0, h1 in zip(t_off.history, t_on.history, strict=True):
        assert (h0["step"], h0["loss"], h0["chunk_loss"]) == (h1["step"], h1["loss"],
                                                              h1["chunk_loss"])
    for a, b in zip(t_off.params + t_off.mu + t_off.nu + t_off.ema,
                    t_on.params + t_on.mu + t_on.nu + t_on.ema, strict=True):
        assert torch.equal(a.detach(), b.detach())
    for a, b in zip(t_off.occ, t_on.occ):
        assert torch.equal(a, b)
    assert torch.equal(t_off.gen.get_state(), t_on.gen.get_state())
    assert s_off.rng.bit_generator.state == s_on.rng.bit_generator.state
    if error_map:
        np.testing.assert_array_equal(s_off.error_map, s_on.error_map)

    snap = recorder.snapshot()
    calls, chunks, steps = 2, 4, 16
    c = snap["counts"]
    assert c["flnerf.train.step"] == steps == t_on.step
    for child in ("flnerf.train.forward", "flnerf.train.backward", "flnerf.train.optimizer"):
        assert c[child] == steps
        assert {p for n, p, _, _ in snap["spans"] if n == child} == {"flnerf.train.step"}
    assert c["flnerf.train.refresh"] == c["flnerf.io.upload"] == chunks
    assert c["flnerf.budget.sample_chunk"] == chunks
    assert c["flnerf.budget.sampler_init"] == 1
    # one stacked transfer a call; with the error map one more a chunk
    assert c["flnerf.io.drain"] == calls + (chunks if error_map else 0)
    assert c.get("flnerf.budget.update_error_map", 0) == (chunks if error_map else 0)
    assert snap["counters"]["flnerf.train.steps"] == steps
    assert snap["counters"]["flnerf.train.rays"] == steps * 32
    assert len(kept) == steps
    assert snap["counters"]["flnerf.ngp.kept_samples"] == sum(kept) > 0
    assert recorder.take_device() == {}


def test_ngp_history_stamps_rise_with_steps():
    sampler, trainer = _ngp_trainer()
    t0 = time.time()
    trainer.fit(sampler, verbose=False, n_steps=12)
    took = time.time() - t0
    walls = [h["wall_s"] for h in trainer.history]
    assert [h["step"] for h in trainer.history] == [4, 8, 12]
    assert all(isinstance(w, float) for w in walls)
    assert 0.0 < walls[0] < walls[1] < walls[2] <= took


@pytest.mark.cuda
def test_ngp_history_stamps_and_counts_on_the_card(recorder, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamps are CUDA events there")
    kept = []
    march = t_ngp.march

    def counted(*a, **kw):
        out = march(*a, **kw)
        kept.append(int(out[1].sum()))
        return out

    monkeypatch.setattr(t_ngp, "march", counted)
    rcfg = r.NGPRenderConfig(n_candidates=16, n_keep=8, grid_size=8, bound=1.0)
    tcfg = t_ngp.NGPTrainConfig(max_steps=16, batch_rays=32, steps_per_chunk=4,
                                ema_decay=0.95, use_prob_map=True)
    images, poses, K, _, _ = _views()
    sampler = t_ngp.NGPSampler(images, poses, K, tcfg, seed=3)
    trainer = t_ngp.NGPTrainer(m.NGPConfig(num_levels=4, log2_hashmap_size=10,
                                           desired_resolution=64, bound=1.0),
                               rcfg, tcfg, device="cuda")
    recorder.enable()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        h0 = len(trainer.history)
        trainer.fit(sampler, verbose=False, n_steps=12)
        took = time.time() - t0
        walls = [h["wall_s"] for h in trainer.history[h0:]]
        assert all(isinstance(w, float) for w in walls)
        assert 0.0 < walls[0] < walls[1] < walls[2] <= took
    recorder.disable()
    snap = recorder.snapshot()
    assert snap["counts"]["flnerf.io.drain"] == 2
    assert snap["counts"]["flnerf.train.step"] == len(kept) == 24
    assert snap["counters"]["flnerf.ngp.kept_samples"] == sum(kept) > 0
