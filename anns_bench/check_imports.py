"""Check what the benchmark loads: no ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` anywhere, and nothing of the program in the
reference.

    python3 anns_bench/check_imports.py      # from the root of the repo

Top-level module names are compared whole (``repro_torch`` is the program,
``repro`` the JAX package).  Two checks, each in a fresh interpreter:

* the harness with the program and every metric reader imported: no
  forbidden top-level name in ``sys.modules``;
* the reference side (``reference``, ``check``, ``datagen``, ``stats``,
  ``roofline``, ``loadgen``) imported alone: no ``repro_torch`` either,
  and none named in their source.

Exits 0 when both hold, 1 (naming what it found) otherwise.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE_SIDE = ("reference", "check", "datagen", "stats", "roofline",
                  "loadgen")

_PROBE = """
import importlib, json, sys
sys.path[:0] = {paths!r}
for m in {mods!r}:
    importlib.import_module(m)
for p in {readers!r}:
    spec = importlib.util.spec_from_file_location("reader_" + str(abs(hash(p))), p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{n.split(".")[0] for n in list(sys.modules)}})))
"""


def loaded_top_names(mods, readers=()) -> set[str]:
    """Top-level names in ``sys.modules`` of a fresh interpreter that
    imported ``mods`` and executed the files ``readers``."""
    code = _PROBE.format(paths=[str(ROOT / "src"), str(ROOT)],
                         mods=list(mods), readers=[str(r) for r in readers])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def imported_names(path: Path) -> set[str]:
    """Top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def problems() -> list[str]:
    out = []
    harness = loaded_top_names(
        ["anns_bench.run", "anns_bench.harness", "anns_bench.system",
         "anns_bench.trace", "anns_bench.faults", "anns_bench.readings"],
        sorted((HERE / "metrics").glob("*.py")))
    if "repro_torch" not in harness:
        out.append("the harness did not load the program (repro_torch)")
    out += [f"the harness loads {n}" for n in sorted(harness & FORBIDDEN)]
    ref = loaded_top_names([f"anns_bench.{m}" for m in REFERENCE_SIDE])
    out += [f"the reference side loads {n}"
            for n in sorted(ref & (FORBIDDEN | {"repro_torch"}))]
    for m in REFERENCE_SIDE:
        bad = imported_names(HERE / f"{m}.py") & (FORBIDDEN | {"repro_torch"})
        out += [f"anns_bench/{m}.py imports {n}" for n in sorted(bad)]
    return out


def main() -> int:
    found = problems()
    for p in found:
        print(p, file=sys.stderr)
    print("imports ok" if not found else f"{len(found)} import problem(s)")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
