"""Import hygiene of the port: repro_torch loads neither jax nor the JAX
package, and no source of it names jax."""
import pathlib
import subprocess
import sys

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
