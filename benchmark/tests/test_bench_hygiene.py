"""Nothing the benchmark runs imports JAX, its libraries or the JAX package
(``mdqe_cvpr2023_tpu``), compared by whole top-level names, and the
reference imports nothing of the port (``mdqe_cvpr2023_tpu_torch``)."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest
from bench_tiny import BENCH, ROOT

from benchlib import hygiene

PORT = "mdqe_cvpr2023_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & set(hygiene.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(_imports(path))
    assert "benchlib" not in set(_imports(path))


def test_whole_top_level_names():
    assert hygiene.forbidden_loaded([PORT, f"{PORT}.models.meta", "jaxtyping", "flaxen"]) == []
    assert hygiene.forbidden_loaded(["mdqe_cvpr2023_tpu.models", "jax._src", "numpy"]) == \
        ["jax", "mdqe_cvpr2023_tpu"]


def test_a_run_loads_no_jax():
    """A process that imports the harness, every kind and the port modules
    they drive holds none of the forbidden modules."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}]\n"
            "import run, flops\n"
            "from benchlib import manifest, hygiene\n"
            "import kinds.vis_stream, kinds.train_clips\n"
            "from mdqe_cvpr2023_tpu_torch.models import meta, detr, swin\n"
            "from mdqe_cvpr2023_tpu_torch.parallel import train\n"
            "import reference.models.meta, reference.parallel.train\n"
            "print(hygiene.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a run
    exits with another code than 0 and prints no result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "r50_ovis360.vis_crowded", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
