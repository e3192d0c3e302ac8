"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX package.

An AST scan rejects ``jax``, ``jax.*``, ``mdqe_cvpr2023_tpu`` and
``mdqe_cvpr2023_tpu.*`` by exact module name (``mdqe_cvpr2023_tpu_torch``
shares the prefix and is allowed); a fresh interpreter then imports every
module of the port and checks ``sys.modules``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mdqe_cvpr2023_tpu_torch"
FORBIDDEN = ("jax", "mdqe_cvpr2023_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_forbidden_matches_exact_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("mdqe_cvpr2023_tpu") and _forbidden("mdqe_cvpr2023_tpu.ops")
    assert not _forbidden("mdqe_cvpr2023_tpu_torch")
    assert not _forbidden("jaxlib_free") and not _forbidden("mdqe_cvpr2023_tpu_torch.ops")


def test_importing_the_port_loads_no_jax():
    # modules an interpreter's site hooks load before any import are not the
    # port's doing: only what importing the port adds counts
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in set(sys.modules) - before\n"
            f"             if n.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
