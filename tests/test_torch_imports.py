"""The port stands alone: no module under ``src/repro_torch/``, not
``chip_smoke.py`` and not the examples' torch twins import ``jax``, the
JAX package ``repro`` or ``ml_dtypes`` (which ships with JAX; the machine
with the card has none of them), and importing the port builds no
kernel."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py",
           ROOT / "examples" / "train_retrieval_torch.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_without_jax_or_kernel_build():
    """Import every port module in a fresh interpreter where ``jax``,
    ``repro`` and ``ml_dtypes`` cannot be imported: nothing reaches for
    them, and no kernel library is built at import time."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        "from repro_torch.kernels import cuda_lib\n"
        "assert cuda_lib._lib is None\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
