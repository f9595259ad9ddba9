"""Import hygiene of the port: repro_torch and chip_smoke.py load neither
jax nor the JAX package, and no source of them names jax."""
import ast
import pathlib
import subprocess
import sys

import pytest
from _torch_threads import _one_thread  # noqa: F401


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
    assert {"repro_torch.kernels.int8_matmul", "repro_torch.quant.quantizer",
            "repro_torch.launch", "repro_torch.launch.serve",
            "repro_torch.kernels.fake_quant", "repro_torch.kernels.flash_attention",
            "repro_torch.quant.fake_quant", "repro_torch.quant.calibration",
            "repro_torch.optim.adamw", "repro_torch.checkpoint.checkpointer",
            "repro_torch.launch.fault", "repro_torch.launch.steps",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.launch.profile", "repro_torch.obs",
            "repro_torch.obs.drift", "repro_torch.obs.perf",
            "repro_torch.analysis.findings", "repro_torch.analysis.lint",
            "repro_torch.analysis.bounds", "repro_torch.analysis.dispatch_check",
            "repro_torch.launch.roofline", "repro_torch.paper.run",
            "repro_torch.paper.table2_rankcorr", "repro_torch.launch.sharding",
            "repro_torch.launch.pipeline", "repro_torch.models.partition",
            "repro_torch.optim.compression", "repro_torch.utils.hlo",
            "repro_torch.launch.dryrun"} <= set(mods)
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


def _cli_help(module: str):
    """``python -m <module> --help`` with only the port and torch loaded."""
    code = ("import runpy, sys\n"
            "sys.argv = ['cli', '--help']\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(PKG.parent),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_serve_cli_help_loads_neither_jax_nor_repro():
    out = _cli_help("repro_torch.launch.serve")
    assert "--int8-compute" in out and "--shared-prefix" in out


def test_profile_cli_help_loads_neither_jax_nor_repro():
    """The profiling CLI takes the reference's flags."""
    out = _cli_help("repro_torch.launch.profile")
    for flag in ("--arch", "--smoke", "--weight-bits", "--avg-bits",
                 "--group-size", "--kv-bits", "--time-every", "--trace",
                 "--json"):
        assert flag in out, flag


def test_dryrun_cli_help_loads_neither_jax_nor_repro():
    """The dry-run CLI takes the reference's flags and no device flag."""
    out = _cli_help("repro_torch.launch.dryrun")
    for flag in ("--arch", "--shape", "--all", "--multi-pod", "--both-meshes",
                 "--skip-existing", "--out", "--strategy", "--seq-parallel",
                 "--decode-quant", "--moe-mode", "--zero1", "--tag",
                 "--ssm-chunk", "--attn-chunk", "--ssm-bf16"):
        assert flag in out, flag
    assert "--device" not in out


def test_train_cli_help_loads_neither_jax_nor_repro():
    """The training CLI takes the reference's flags and no device flag."""
    out = _cli_help("repro_torch.launch.train")
    for flag in ("--arch", "--smoke", "--steps", "--batch", "--seq",
                 "--ckpt-dir", "--resume", "--ckpt-every", "--qat-weight-bits",
                 "--qat-act-bits", "--watchdog-s", "--lr"):
        assert flag in out, flag
    assert "--device" not in out


EXAMPLES = sorted(p.name for p in (PKG.parents[1] / "examples").glob("*_torch.py"))


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_help_loads_neither_jax_nor_repro(script):
    """Each ``examples/*_torch.py --help`` runs with only the port and
    torch loaded, and offers ``--device``."""
    assert len(EXAMPLES) == 4
    path = PKG.parents[1] / "examples" / script
    code = ("import runpy, sys\n"
            f"sys.argv = [{str(path)!r}, '--help']\n"
            "try:\n"
            f"    runpy.run_path({str(path)!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(PKG.parent),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


# public names of a reference package that wait for a later queue item
# (ROADMAP § A), by package
WAITING: dict = {}


def _public(mod, root: str) -> set:
    """The names a package defines or re-exports from its own modules:
    public, not a submodule, not imported from elsewhere (typing, torch)."""
    import types
    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or name == "annotations" \
                or isinstance(value, types.ModuleType):
            continue
        owner = getattr(value, "__module__", None)
        if owner is None or owner == root or owner.startswith(root + "."):
            out.add(name)
    return out


@pytest.mark.parametrize("pkg", ["core", "models", "utils", "configs", "quant",
                                 "kvcache", "serve", "qtensor", "analysis",
                                 "obs", "obs.perf"])
def test_package_exports_equal_reference(pkg):
    import importlib
    ref = _public(importlib.import_module(f"repro.{pkg}"), "repro")
    port = _public(importlib.import_module(f"repro_torch.{pkg}"), "repro_torch")
    waiting = WAITING.get(pkg, set())
    assert waiting <= ref and not waiting & port
    assert port == ref - waiting


def test_configs_follow_reference():
    """``ARCH_IDS`` holds the reference's ten ids in its order; every
    config equals the reference's field by field; the dashed aliases,
    ``SHAPES`` and ``cells`` agree."""
    import dataclasses

    from repro import configs as jc
    from repro_torch import configs as tc
    assert tc.ARCH_IDS == jc.ARCH_IDS and len(tc.ARCH_IDS) == 10
    assert {tc.get_config(a).family for a in tc.ARCH_IDS} == \
        {"dense", "moe", "ssm", "hybrid", "audio", "vlm"}
    for arch in tc.ARCH_IDS:
        for get in ("get_config", "smoke_config"):
            t, j = getattr(tc, get)(arch), getattr(jc, get)(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch, get)
        assert tc.get_config(arch.replace("_", "-")) == tc.get_config(arch)
    assert list(tc.all_configs()) == tc.ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in tc.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jc.SHAPES.items()}
    assert tc.cells() == jc.cells()
