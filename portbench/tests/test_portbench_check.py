"""The check that decides ``correct``, on the CPU at small sizes: the plain
references follow the program's plain path; a run drives everything but
the look for a card and comes out correct; with the timed path broken
underneath (a step that leaves its state unchanged, half of each batch left
out) it comes out not correct; and the control (the reference in the
precision below the configured one) reads above every limit it is held to
at full size on at least one number."""

import time

import pytest
import torch

from portbench import harness
from portbench.reference.common import training_gaps
from portbench.tests import tiny

CELLS = ["plenoxels-syn-256.steady", "ngp-syn-2p19.probmap"]


def driver(cell, seed=5):
    work, cfg, Driver = harness.load_cell(cell)
    tiny.for_cell(cell)(work, cfg)
    d = Driver(cfg, work, seed, torch.device("cpu"))
    d.setup()
    return d, work


@pytest.fixture(scope="module", params=CELLS)
def readings(request):
    d, work = driver(request.param)
    prog = d.readings
    d.free()
    ref = d.reference()
    return {"cell": request.param, "work": work, "prog": prog, "ref": ref,
            "control": d.reference(control=True), "half": d.reference(fault="half")}


def test_reference_follows_the_plain_path(readings):
    gaps = training_gaps(readings["prog"], readings["ref"])
    assert max(gaps.values()) < 1e-5, gaps
    assert readings["prog"]["rows_bad"] == 0


def test_control_fails_a_limit(readings):
    gaps = training_gaps(readings["control"], readings["ref"])
    limits = readings["work"]["limits"]
    assert any(gaps[k] > limits[k] for k in gaps), gaps


def test_half_batch_fails_a_limit(readings):
    gaps = training_gaps(readings["half"], readings["ref"])
    limits = readings["work"]["limits"]
    assert any(gaps[k] > limits[k] for k in gaps), gaps


def run(cell):
    return harness.run_cell(cell, 2 ** 31 + 11, 0.01, False, "cpu", time.perf_counter(),
                            tweak=tiny.for_cell(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in harness.bench_metrics(cell)[0]}


def unchanged(monkeypatch, cell):
    if cell.startswith("plenoxels"):
        from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainer
        monkeypatch.setattr(PlenoxelsTrainer, "_rmsprop", lambda self, *a, **k: None)
    else:
        from flnerf_tpu_torch.train.ngp_trainer import NGPTrainer

        def adam(self, grads):
            self.count += 1
            self.step += 1
        monkeypatch.setattr(NGPTrainer, "_adam", adam)


def half_batch(monkeypatch, cell):
    if cell.startswith("plenoxels"):
        from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainer
        inner = PlenoxelsTrainer._step

        def step(self, *arrays):
            n = arrays[0].shape[0] // 2
            return inner(self, *[a[:n] for a in arrays[:5]], *arrays[5:])
        monkeypatch.setattr(PlenoxelsTrainer, "_step", step)
    else:
        from flnerf_tpu_torch.train.ngp_trainer import NGPTrainer
        inner = NGPTrainer.train_step

        def train_step(self, origins, dirs, rgb, *a, **k):
            n = origins.shape[0] // 2
            return inner(self, origins[:n], dirs[:n], rgb[:n], *a, **k)
        monkeypatch.setattr(NGPTrainer, "train_step", train_step)


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    r = run(cell)
    assert not r["correct"], r["checks"]


def stale_leaf_statistic(monkeypatch, cell):
    from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainer
    inner = PlenoxelsTrainer.run_epoch_rays

    def run_epoch_rays(self, epoch):
        stat, mse = inner(self, epoch)
        return stat * 1.01, mse
    monkeypatch.setattr(PlenoxelsTrainer, "run_epoch_rays", run_epoch_rays)


def refresh_left_out(monkeypatch, cell):
    from flnerf_tpu_torch.render import ngp as render_ngp
    from flnerf_tpu_torch.train import ngp_trainer
    inner = render_ngp.update_occupancy

    def update_occupancy(occ, field, cfg, partial=False, **kw):
        new = inner(occ, field, cfg, partial=partial, **kw)
        if not partial:
            return new
        return render_ngp.with_density(occ, torch.where(occ.density < 0, occ.density,
                                                        occ.density * cfg.decay), cfg)
    monkeypatch.setattr(ngp_trainer, "update_occupancy", update_occupancy)


@pytest.mark.parametrize("cell,fault", [("plenoxels-syn-256.steady", stale_leaf_statistic),
                                        ("ngp-syn-2p19.probmap", refresh_left_out)],
                         ids=["leaf_statistic", "partial_refresh"])
def test_broken_budget_or_refresh_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    r = run(cell)
    assert not r["correct"], r["checks"]


def test_the_start_is_carved(readings):
    """Empty space exists in the checked steps: blocks K1/K2 skip, and NGP
    cells the first refresh leaves unoccupied."""
    from portbench.reference import ngp as ref_ngp

    d, _ = driver(readings["cell"])
    if readings["cell"].startswith("plenoxels"):
        density = d._density0()
        assert 0.0 < float((density > 0).float().mean()) < 0.5
    else:
        gen = torch.Generator().manual_seed(0)
        occ = ref_ngp.occupancy(ref_ngp.Field(d.ref_cfg(), d.init), d.ref_cfg(), gen)
        assert 0.0 < float(occ.float().mean()) < 0.7


def test_traced_launches_are_counted(readings):
    """The work counts cover every launch of the traced window: a K1/K2 or
    K7 launch a step, and for K6 one more per 2^16 cells of each refresh."""
    d, _ = driver(readings["cell"])
    d.trace_begin()
    _, steps, _ = d.call()
    d.trace_end()
    w = d.work_counts()
    if readings["cell"].startswith("plenoxels"):
        assert w["k1"]["launches"] == w["k2"]["launches"] == w["step"]["launches"] == steps
    else:
        chunks = steps // d.tcfg.steps_per_chunk
        per_refresh = -(-(d.rcfg.grid_size // 2) ** 3 // (1 << 16))
        assert w["k7"]["launches"] == w["step"]["launches"] == steps
        assert w["k6"]["launches"] == steps + chunks * per_refresh
    assert all(v["least_s"] > 0 for v in w.values())
