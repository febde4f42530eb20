"""What the benchmark's modules import, by whole top-level module name
(``clrs_tpu_torch`` begins with ``clrs_tpu``, so a prefix test would be
wrong both ways): nothing under perfbench/ imports JAX or the JAX package,
and the plain reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FILES = sorted(PKG.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "clrs_tpu"}


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".", 1)[0])
    return out


def test_whole_name_comparison():
    src = "import clrs_tpu_torch.dd\nfrom clrs_tpu_torch import x\n"
    p = PKG / "tests" / "_probe_whole_name.py"
    try:
        p.write_text(src)
        assert top_level_imports(p) == {"clrs_tpu_torch"}
        assert not top_level_imports(p) & JAX
        p.write_text("import clrs_tpu.solver\nimport jax.numpy\n")
        assert top_level_imports(p) == {"clrs_tpu", "jax"}
    finally:
        p.unlink(missing_ok=True)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((PKG / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "clrs_tpu_torch" not in top_level_imports(path)


def test_reference_loads_without_the_port():
    # a fresh interpreter that cannot import the port at all
    code = ("import sys; sys.modules['clrs_tpu_torch'] = None\n"
            "import perfbench.reference.delsarte, "
            "perfbench.reference.threepoint, perfbench.reference.ipm64\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'clrs_tpu', 'clrs_tpu_torch')"
            " and sys.modules[m] is not None))")
    r = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_run_names_what_it_found():
    sys.path.insert(0, str(PKG))
    try:
        import run
    finally:
        sys.path.remove(str(PKG))
    saved = sys.modules.get("clrs_tpu")
    sys.modules["clrs_tpu"] = object()
    try:
        assert "clrs_tpu" in run.forbidden_modules()
    finally:
        if saved is None:
            del sys.modules["clrs_tpu"]
        else:
            sys.modules["clrs_tpu"] = saved
