"""check_imports.py: nothing the benchmark loads is JAX or the JAX
package, and the reference loads nothing of the program."""
from __future__ import annotations

import conftest  # noqa: F401  (paths)

from anns_bench import check_imports, run


def test_benchmark_imports_are_clean():
    assert check_imports.problems() == []


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.core\nfrom repro.kernels import x\n"
                   "import jaxtyping\nfrom . import y\n")
    names = check_imports.imported_names(src)
    assert names == {"repro_torch", "repro", "jaxtyping"}
    assert names & check_imports.FORBIDDEN == {"repro"}


def test_the_run_refuses_a_loaded_jax(monkeypatch):
    import sys
    import types

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType("y"))
    assert run.forbidden_modules() == ["jax"]
