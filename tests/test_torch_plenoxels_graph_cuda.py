"""The Plenoxels trainer's chunks as CUDA graph replays, on the card, held
against the same chunks trained step by step (``graph_rule`` patched to
refuse every chunk) from the same start: the grid, both RMSProp states, the
per-leaf error statistic and the chunk MSE agree within K2's atomic-order
noise, through replays of both buffer orders (an odd eager chunk between
graphed ones), a new alive mask and a resample, which drop the graphs; the
launch counters equal the step-by-step run's, and the recorder counts the
graphed steps.  Skips without a CUDA device.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_plenoxels_graph_cuda.py
"""

import numpy as np
import pytest
import torch

from flnerf_tpu_torch.core.logging_utils import RECORDER
from flnerf_tpu_torch.models import voxel_sh as vs
from flnerf_tpu_torch.ops import tv_rmsprop as tr
from flnerf_tpu_torch.ops import voxel_kernel
from flnerf_tpu_torch.rays.quadtree import RayEpoch
from flnerf_tpu_torch.train import plenoxels_trainer as pt

RESO, B, K, LEAVES = 64, 512, 8, 37


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def recorder():
    RECORDER.reset()
    RECORDER.enable()
    yield RECORDER
    RECORDER.disable()
    RECORDER.reset()


def _trainer(cuda):
    """A 64^3 grid with 10% of its cells dead, rates that decay over 40
    steps (so the replays read rows past the table's end too)."""
    gcfg = vs.VoxelGridConfig(reso=(RESO,) * 3, radius=(1.2,) * 3,
                              max_steps=int(3.5 * RESO / 0.5), step_size=0.5)
    tcfg = pt.PlenoxelsTrainConfig(batch_size=B, steps_per_chunk=K, lr_decay_steps=40,
                                   lr_sigma_delay_steps=30)
    t = pt.PlenoxelsTrainer(gcfg, tcfg, device=cuda)
    rng = np.random.default_rng(0)
    s = (RESO,) * 3
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    grid = vs.VoxelGrid(f(rng.random(s) * 2.0), f(rng.standard_normal(s + (27,)) * 0.3),
                        torch.tensor(rng.random(s) > 0.1, device=cuda))
    t.state = pt.PlenoxelsState(grid, torch.zeros(s, device=cuda),
                                torch.zeros(s + (27,), device=cuda), 0)
    return t


def _epoch(n, seed):
    """n rays from a sphere of radius 2.5 toward the grid, random colours
    and leaves."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d = -u + 0.3 * rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f32 = lambda a: a.astype(np.float32)
    return RayEpoch(f32(2.5 * u), f32(d), f32(rng.random((n, 3))),
                    rng.integers(0, LEAVES, n).astype(np.int32), LEAVES)


# (rays, what the graphed trainer does): whole chunks replay once a graph
# exists for the grid's buffer order; an odd chunk (5 live steps, 3 dead)
# runs step by step and leaves the grid in its other buffers
CALLS = [(K * B, "warm-up and capture of order A"),
         (3 * K * B, "3 replays of A"),
         (B, "1 live step, 7 dead: step by step, to order B"),
         (2 * K * B, "warm-up and capture of B, then a replay of B"),
         (2 * K * B, "2 replays of B"),
         (5 * B, "5 live steps, 3 dead: step by step, back to order A"),
         (2 * K * B, "2 replays of A")]
GRAPHED = [0, 3 * K, 0, K, 2 * K, 0, 2 * K]


def _state(t):
    st = t.state
    return [x.detach().cpu() for x in (st.grid.density, st.grid.sh, st.rms_density, st.rms_sh)]


def _gaps(runs, want, starts):
    """[call, 6]: each call's distance of the grid, SH and both RMSProp
    states from ``want``'s over the change ``want`` made in them (the states:
    over their norm), then of its per-leaf statistic and its chunk MSE over
    ``want``'s largest."""
    out = []
    for (a, (sa, ma)), (b, (sb, mb)), start in zip(runs, want, starts):
        row = [float(torch.linalg.vector_norm(x - y))
               / float(torch.linalg.vector_norm(y - start[k] if k < 2 else y))
               for k, (x, y) in enumerate(zip(a, b))]
        fa, fb = np.isfinite(sa), np.isfinite(sb)
        assert np.array_equal(fa, fb)
        row.append(float(np.abs(sa[fa] - sb[fb]).max() / np.abs(sb[fb]).max()))
        row.append(abs(ma - mb) / mb)
        out.append(row)
    return np.array(out)


def _within_noise(graphed, eagers, starts):
    """The graphed run's gaps from the first step-by-step run within 10x the
    largest gap between any two of the step-by-step runs (``eagers``, three):
    K2's atomics add in another order each run, RMSProp carries the last
    bits on, and a last bit that flips a ray's early stop moves a run
    further, so one pair's gap can be 50x another's.  Where the runs repeat
    exactly, within 1e-6."""
    gap = _gaps(graphed, eagers[0], starts)
    noise = np.max([_gaps(eagers[b], eagers[a], starts).max(0)
                    for a in range(len(eagers)) for b in range(a + 1, len(eagers))], 0)
    assert (gap <= 10 * noise + 1e-6).all(), (gap, noise)


def _run(cuda, calls, graphs: bool, monkeypatch, recorder, then=None):
    """Train ``calls`` (rays, seed) on a fresh trainer; returns (trainer,
    [(state, (stat, mse)) after each call], launches, recorder counters)."""
    with monkeypatch.context() as m:
        if not graphs:
            m.setattr(pt, "graph_rule", lambda *a: False)
        t = _trainer(cuda)
        tr.reset_launch_counts()
        voxel_kernel.reset_launch_counts()
        recorder.reset()
        runs = []
        for i, (n, seed) in enumerate(calls):
            out = t.run_epoch_rays(_epoch(n, seed))
            runs.append((_state(t), out))
            if then is not None:
                then(t, i)
        torch.cuda.synchronize()
        launches = (voxel_kernel.FWD_LAUNCHES, voxel_kernel.BWD_LAUNCHES, tr.SWEEP_LAUNCHES,
                    tr.PAIRS_LAUNCHES)
        return t, runs, launches, dict(recorder.counters)


@pytest.mark.cuda
def test_graphed_chunks_match_step_by_step_chunks(cuda, monkeypatch, recorder):
    calls = [(n, 100 + i) for i, (n, _) in enumerate(CALLS)]
    start = _state(_trainer(cuda))
    tg, run_g, launch_g, c_g = _run(cuda, calls, True, monkeypatch, recorder)
    te, run_e, launch_e, c_e = _run(cuda, calls, False, monkeypatch, recorder)
    run_e2, run_e3 = (_run(cuda, calls, False, monkeypatch, recorder)[1] for _ in range(2))
    steps = sum(-(-n // B) for n, _ in calls)
    assert tg.state.step == te.state.step == steps
    # at most two graphs, one per buffer order
    assert len(tg._graphs) == 2 and not te._graphs
    _within_noise(run_g, [run_e, run_e2, run_e3], [start] * len(calls))
    # the counters count the kernels that ran, replayed or not
    assert launch_g == launch_e == (steps, steps, 2 * steps, 1)
    assert c_g["flnerf.train.graph_steps"] == sum(GRAPHED)
    assert "flnerf.train.graph_steps" not in c_e
    for c in (c_g, c_e):
        assert c["flnerf.train.steps"] == steps
        assert c["flnerf.train.fused_sweeps"] == 2 * steps


@pytest.mark.cuda
def test_replay_spans_and_counts(cuda, monkeypatch, recorder):
    calls = [(K * B, 1), (3 * K * B, 2)]
    _, _, _, c = _run(cuda, calls, True, monkeypatch, recorder)
    assert c["flnerf.train.graph_steps"] == 3 * K
    snap = recorder.snapshot()
    assert snap["counts"]["flnerf.train.graph_replay"] == 3
    # the spans of the steps that ran step by step: the warm-up chunk's
    assert snap["counts"]["flnerf.train.step"] == K


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["alive", "resample"])
def test_a_new_alive_mask_or_a_resample_drops_the_graphs(cuda, monkeypatch, recorder, change):
    """After two graphed calls the grid gets a new alive mask (or is
    resampled to 48^3); the graphs go, the next whole chunk is a warm-up
    again and a new graph serves the one after it, and the run still
    matches the step-by-step one."""
    calls = [(K * B, 7), (K * B, 8), (2 * K * B, 9), (K * B, 10)]
    seen = {"before": [], "after": [], "changed": []}

    def then(t, i):
        if i == 1:
            seen["before"].append({id(g.graph) for g in t._graphs.values()})
            if change == "alive":
                rng = np.random.default_rng(3)
                alive = torch.tensor(rng.random((RESO,) * 3) > 0.3, device=cuda)
                t.state = t.state._replace(grid=t.state.grid._replace(alive=alive))
            else:
                t.resample((48, 48, 48))
                assert not t._graphs
            seen["changed"].append(_state(t))
        elif i == 2:
            seen["after"].append({id(g.graph) for g in t._graphs.values()})

    start = _state(_trainer(cuda))
    tg, run_g, launch_g, c_g = _run(cuda, calls, True, monkeypatch, recorder, then)
    te, run_e, launch_e, c_e = _run(cuda, calls, False, monkeypatch, recorder, then)
    run_e2, run_e3 = (_run(cuda, calls, False, monkeypatch, recorder, then)[1]
                      for _ in range(2))
    before, after = seen["before"][0], seen["after"][0]
    assert len(before) == 1 and len(after) == 1 and not before & after
    assert seen["before"][1:] == seen["after"][1:] == [set(), set(), set()]
    # call 0 warms up; call 1 replays; call 2 warms up again, then replays;
    # call 3 replays
    assert c_g["flnerf.train.graph_steps"] == 3 * K
    assert launch_g == launch_e
    assert launch_g[3] == 2        # the live pairs of each mask
    # calls 2 and 3 changed the grid from the step-by-step run's right after
    # the resample
    starts = [start] * 4 if change == "alive" else [start] * 2 + [seen["changed"][1]] * 2
    _within_noise(run_g, [run_e, run_e2, run_e3], starts)
