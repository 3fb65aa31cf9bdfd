"""Nothing under ``cvsbench/`` imports JAX or the JAX package, by whole
top-level name (``cudavideostream_tpu_torch`` is the port and passes);
the reference and the comparison import nothing of the port either; and
no file opens a path under ``benchmarks/``."""

import ast
import json
from pathlib import Path

import pytest

from cvsbench import run

BENCH_DIR = Path(__file__).resolve().parents[1]
SOURCES = sorted(BENCH_DIR.rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "cudavideostream_tpu", "benchmarks"}


def named_references():
    """The file of each reference module a configuration names."""
    names = (json.loads(p.read_text()).get("reference")
             for p in (BENCH_DIR / "configs").glob("*.json"))
    return sorted("/".join(n.split(".")[1:]) + ".py" for n in names if n)


# the yardstick that judges the program takes nothing from it: the
# comparison, the reference, each reference a configuration names and the
# tests' own
INDEPENDENT = ["check.py", "reference.py",
               "tests/red_overlap_reference.py"] + named_references()


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("name", INDEPENDENT)
def test_reference_imports_nothing_of_the_port(name):
    names = top_level_imports(BENCH_DIR / name)
    assert names <= {"__future__", "numpy", "dataclasses", "importlib", "os",
                     "concurrent", "typing", "cvsbench"}


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.name != Path(__file__).name],
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_benchmarks_path(path):
    assert "benchmarks/" not in path.read_text()


def test_whole_name_comparison(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "cudavideostream_tpu_torch.fake",
                        types.ModuleType("cudavideostream_tpu_torch.fake"))
    assert "cudavideostream_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cudavideostream_tpu.ops",
                        types.ModuleType("cudavideostream_tpu.ops"))
    assert "cudavideostream_tpu" in run.forbidden_modules()
