"""Nothing under chipbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either.  Modules are compared by
their top-level name, whole: ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


def test_the_check_sees_every_file():
    names = {p.relative_to(BENCH).as_posix() for p in FILES}
    assert {"run.py", "bench.py", "reference/svhn_cnn.py",
            "metrics/mfu_int8.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & (FORBIDDEN | {"repro_torch", "chipbench"})


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro_torch import api\n")
    assert imported_tops(f) == {"repro_torch"}
    f.write_text("import repro.core\n")
    assert imported_tops(f) & FORBIDDEN == {"repro"}


def test_a_run_loads_no_forbidden_module():
    """What a run's process holds once the window closes (the run's own
    check, exercised on the CPU)."""
    import sys

    from chipbench import run

    assert run.forbidden_modules() == [], sorted(
        n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
