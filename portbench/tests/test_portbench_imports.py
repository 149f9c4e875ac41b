"""Nothing under portbench/ imports JAX or the JAX package (compared by the
whole top-level name: the port's name begins with the JAX package's), the
references import nothing of the program, and nothing reads the JAX
package's benchmark files."""

import ast
import glob
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True))
FORBIDDEN = {"jax", "jaxlib", "flax", "flnerf_tpu"}


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(HERE, "reference", "*.py"))),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "flnerf_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) - {"__future__", "functools", "math", "statistics",
                                           "numpy", "torch", "portbench"}


def test_the_check_itself_sees_the_names(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import jax.numpy\nfrom flnerf_tpu.ops import x\nimport flnerf_tpu_torch\n")
    assert top_level_imports(str(path)) & FORBIDDEN == {"jax", "flnerf_tpu"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_benchmark_files_read(path):
    if os.path.basename(path) == os.path.basename(__file__):
        return
    with open(path) as f:
        src = f.read()
    assert "BENCH_" not in src and "bench.py" not in src and "BASELINE" not in src


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys

    from portbench import run

    monkeypatch.setitem(sys.modules, "flnerf_tpu", object())
    assert run.forbidden_modules() == ["flnerf_tpu"]
    monkeypatch.delitem(sys.modules, "flnerf_tpu")
    assert "flnerf_tpu_torch" not in run.forbidden_modules()
