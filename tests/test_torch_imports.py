"""Import hygiene of the port: repro_torch and chip_smoke.py load neither
jax nor the JAX package, and no source of them names jax."""
import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_repro():
    mods = list(_modules())
    assert len(mods) > 30
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'repro' or k.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    src = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_no_source_names_jax():
    for path in PKG.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".cu", ".cuh"):
            text = path.read_text()
            assert "jax" not in text.lower(), path
            assert "from repro." not in text and "import repro." not in text \
                and "from repro import" not in text, path


CHIP_SMOKE = PKG.parents[1] / "chip_smoke.py"


def _chip_smoke_imports():
    """Every absolute module chip_smoke.py imports, at top level or inside
    its functions."""
    tree = ast.parse(CHIP_SMOKE.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("check", ["source", "imports", "no_gpu"])
def test_chip_smoke_uses_neither_jax_nor_repro(check):
    if check == "source":
        text = CHIP_SMOKE.read_text()
        assert "jax" not in text.lower()
        assert "from repro." not in text and "import repro." not in text \
            and "from repro import" not in text
        return
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    if check == "imports":
        mods = sorted(set(_chip_smoke_imports()))
        code = ("import importlib, sys\n"
                f"for m in {mods!r}:\n"
                "    importlib.import_module(m)\n"
                f"sys.path.insert(0, {str(CHIP_SMOKE.parent)!r})\n"
                "import chip_smoke\n"
                "chip_smoke._kernel_modules()\n"
                "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
                " or k == 'repro' or k.startswith('repro.'))\n"
                "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, env=env)
        assert out.returncode == 0, out.stderr
        return
    # without a card the script fails and prints no result line
    out = subprocess.run([sys.executable, str(CHIP_SMOKE)], capture_output=True,
                         text=True, env=env, cwd=str(CHIP_SMOKE.parent))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
