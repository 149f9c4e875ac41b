"""The harness finds every cell, configuration and per-layer metric of
BENCHMARK.json by name in its files, and a new cell as new files alone."""

import json
import os
import shutil

import pytest

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_loads_by_name(cell):
    work, cfg, driver = harness.load_cell(cell)
    b = bench()
    entry = next(w for w in b["workloads"] if w["name"] == cell)
    assert work["config"] == entry["config"]
    conf = next(c for c in b["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        assert json.load(f) == cfg
    assert sorted(cfg["reduced"]) == sorted(conf["reduced"])
    for name in ("setup", "call", "budget_calls", "trace_begin", "trace_end", "evaluate",
                 "work_counts", "free", "reference"):
        assert callable(getattr(driver, name))
    assert set(work["limits"]) >= {"loss_gap", "grad_gap", "change_gap", "rows_bad"}


def test_metrics_load_by_name():
    for m in bench()["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read), m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_reports_what_benchmark_lists(cell):
    e2e, per_layer = harness.bench_metrics(cell)
    names = {m["name"].split(".")[0] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert any(e["name"] == m["moves"] for e in e2e), m


def test_new_cell_is_new_files_alone(tmp_path, monkeypatch):
    """A traffic mix and a metric added as files are found by name."""
    here = tmp_path / "portbench"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    work = json.loads((here / "workloads" / "ngp-syn-2p19.probmap.json").read_text())
    work.pop("args")
    (here / "workloads" / "ngp-syn-2p19.uniform.json").write_text(json.dumps(work))
    (here / "metrics" / "a_new_metric.py").write_text("def read(ctx):\n    return 1.5\n")
    monkeypatch.setattr(harness, "HERE", str(here))
    work, cfg, _ = harness.load_cell("ngp-syn-2p19.uniform")
    assert "args" not in work and cfg["driver"] == "ngp"
    assert harness.metric_reader("a_new_metric").read({}) == 1.5
    assert harness.metric_reader("a_new_metric.split") .read({}) == 1.5


def test_readers_find_nothing_without_their_source():
    ctx = {"window": {"seconds": 1.0, "steps": 0, "rays": 0, "failed": 0}, "spans": {},
           "trace": None, "work": None}
    for m in bench()["per_layer"]:
        assert harness.metric_reader(m["name"]).read(ctx) is None, m["name"]
