"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled with its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library is
cached under ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the sources, so a changed source is
rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib: Optional[ctypes.CDLL] = None
_tickets: dict = {}
# libraries built or loaded by this process (``lib``): a dispatch during
# which it steps paid that cost (the obs timer's compile split)
loads = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points and their argument types; every pointer and the stream
# are c_void_p, so ctypes never truncates them to 32 bits
SIGNATURES = {
    "ef_sqnorm_launch": [_P, _I, _L, _L, _I, _I, _I, _L, _I, _P, _P, _P, _P],
    "qmm_launch": [_P, _P, _P, _P, _P, _P, _I, _L, _L, _L, _L, _L, _I, _I,
                   _I, _I, _P],
    "qmm_groups_fold_launch": [_P, _P, _P, _L, _L, _L, _P],
    "grouped_qmm_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _L, _L, _L, _L, _L, _L, _L, _P],
    "int8_matmul_launch": [_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I,
                           _P],
    "paged_attention_launch": [_P, _I, _L, _P, _P, _I, _P, _I, _L, _P, _I,
                               _L, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P],
    "fake_quant_launch": [_P, _P, _I, _L, _P, _P, _F, _P],
    "fake_quant_per_channel_launch": [_P, _P, _I, _L, _L, _L, _P, _P, _F, _I,
                                      _I, _I, _I, _I, _I, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha1()
    for src in sorted(CSRC.glob("*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile all sources in parallel and link them; returns the .so."""
    tag = _digest()
    out_dir = BUILD_DIR / tag
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    objs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT)))
        objs.append(obj)
    logs = []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out.decode(errors='replace')}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{logs[-1]}")
    tmp = out_dir / f"lib.{os.getpid()}.so"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib, loads
    if _lib is None:
        loads += 1
        so = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ticket_buffer(device, n: int):
    """Zeroed int32 counters, at least ``n``, kept per device and stream,
    for the kernels whose last CTA of a unit (a paged-attention (slot,
    head), an ``ef_sqnorm`` row) folds the other CTAs' partials: that CTA
    resets its counter to 0, so the buffer is zeroed once, when it is made
    or grown. Calls on one stream run one after another, so no two calls
    in flight share a buffer; calls on other streams get their own. (A
    CUDA graph that captures a call keeps its buffer: replay such a graph
    on one stream at a time.)"""
    import torch
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 2 * (0 if t is None else t.numel()), 1024),
                        dtype=torch.int32, device=device)
        _tickets[key] = t
    return t
