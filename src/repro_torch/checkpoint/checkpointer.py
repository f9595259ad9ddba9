"""Fault-tolerant checkpointing: atomic writes, async save (port of
``repro.checkpoint.checkpointer``).

Layout, as the reference writes it: ``<dir>/step_<N:08d>/arrays.npz`` +
``manifest.json``, and ``<dir>/LATEST`` written last by an atomic rename,
so a crash mid-save never corrupts the restore path: a restart finds the
newest *complete* step. Leaves are named by their tree path
(``params/layers/0/attn/wq``, ``opt/m/...``; NamedTuple fields by name);
a QTensor node is saved as its packed payload (``<path>/0``, at the
packed byte width) and its scales (``<path>/1``), with its (bits, shape,
axis) in the manifest under ``"qtensors"``.

bf16 leaves are stored as numpy 2-byte void arrays (``|V2``), the form
``np.savez`` gives the reference's bf16 arrays. ``restore`` reads every
leaf by the TEMPLATE's dtype, so such a leaf comes back as bf16 bit for
bit: the port restores the bf16 checkpoints the reference writes (which
the reference itself cannot load) and its own.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.qtensor import QTensor

log = logging.getLogger("repro_torch.ckpt")

# torch dtypes numpy has no type for, stored as void arrays of their width:
# dtype -> (the integer type of the same width in torch, in numpy)
_AS_BITS = {torch.bfloat16: (torch.int16, np.int16)}


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(name, child) pairs of a container node in the reference's
    flattening order; None for a leaf."""
    if isinstance(node, QTensor):
        return [("0", node.data), ("1", node.scale)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def named_arrays(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs, QTensors split into payload and scales."""
    out: List[Tuple[str, Any]] = []

    def rec(node, prefix):
        kids = _children(node)
        if kids is None:
            out.append(("/".join(prefix), node))
            return
        for name, child in kids:
            rec(child, prefix + [name])

    rec(tree, [])
    return out


def _to_numpy(leaf: Any) -> np.ndarray:
    from repro_torch.launch.mesh import ShardedTensor
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full()
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    # always a copy: an async save must not see later in-place updates
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype in _AS_BITS:
        return t.view(_AS_BITS[t.dtype][0]).numpy().view(f"V{t.element_size()}")
    return t.numpy()


def _from_numpy(arr: np.ndarray, template: torch.Tensor) -> torch.Tensor:
    """A saved array as a tensor of the template's dtype, on its device;
    a void leaf is reinterpreted bit for bit."""
    if arr.dtype.kind == "V":
        bits = _AS_BITS.get(template.dtype)
        if bits is None or arr.dtype.itemsize != template.element_size():
            raise ValueError(f"cannot read a {arr.dtype} leaf as "
                             f"{template.dtype}")
        t = torch.from_numpy(arr.view(bits[1]).copy()).view(template.dtype)
    else:
        t = torch.from_numpy(np.array(arr, copy=True)).to(template.dtype)
    return t.to(template.device)


def _gather(tree: Any) -> Dict[str, np.ndarray]:
    return {name: _to_numpy(leaf) for name, leaf in named_arrays(tree)}


def qtensor_manifest(tree: Any) -> Dict[str, Dict]:
    """Static (bits, shape, axis) of every QTensor node, by tree path."""
    metas: Dict[str, Dict] = {}

    def rec(node, prefix):
        if isinstance(node, QTensor):
            metas["/".join(prefix)] = {"bits": node.bits,
                                       "shape": list(node.shape),
                                       "axis": node.axis}
            return
        for name, child in _children(node) or ():
            rec(child, prefix + [name])

    rec(tree, [])
    return metas


def _tree_like(flat: Dict[str, np.ndarray], template: Any) -> Any:
    """``template``'s structure filled from ``flat``; shapes must match."""

    def rec(node, prefix):
        if isinstance(node, QTensor):
            return QTensor(rec(node.data, prefix + ["0"]),
                           rec(node.scale, prefix + ["1"]), node.bits,
                           node.shape, node.axis)
        if _is_namedtuple(node):
            return type(node)(*(rec(c, prefix + [f])
                                for f, c in zip(node._fields, node)))
        if isinstance(node, dict):
            return {k: rec(v, prefix + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, prefix + [str(i)]) for i, v in enumerate(node))
        name = "/".join(prefix)
        if name not in flat:
            raise KeyError(f"checkpoint missing {name}")
        arr = flat[name]
        shape = tuple(node.shape) if hasattr(node, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: ckpt {arr.shape} != template {shape}")
        if isinstance(node, torch.Tensor):
            return _from_numpy(arr, node)
        return arr

    return rec(template, [])


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---------------- save ----------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """Copy ``tree`` to host memory on the caller's thread, then write
        it (on a background thread unless ``blocking``)."""
        flat = _gather(tree)
        qt_meta = qtensor_manifest(tree)
        if qt_meta:
            extra = {**(extra or {}), "qtensors": qt_meta}
        # one writer at a time: a blocking save racing an async save of
        # the same step would both find the target absent
        self.wait()
        if blocking:
            self._write(step, flat, extra or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra or {}), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict) -> None:
        t0 = time.time()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "keys": sorted(flat), **extra}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._point_latest(final)
            self._gc()
            log.info("saved step %d in %.2fs", step, time.time() - t0)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _point_latest(self, final: str) -> None:
        latest_tmp = os.path.join(self.dir, ".LATEST_tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------- restore ----------------
    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        target = os.path.join(self.dir, name, "manifest.json")
        if not os.path.exists(target):  # torn save: fall back to a scan
            steps = sorted(d for d in os.listdir(self.dir)
                           if d.startswith("step_") and
                           os.path.exists(os.path.join(self.dir, d, "manifest.json")))
            return int(steps[-1][5:]) if steps else None
        return int(name[5:])

    def restore(self, step: int, template: Any, shardings: Any = None) -> Any:
        """Load ``step`` into ``template``'s structure: each leaf takes the
        template leaf's dtype and device (a void leaf is reinterpreted).
        ``shardings`` (a tree of ``launch.mesh.NamedSharding``s, or None)
        lays each leaf out on its mesh: the elastic restore onto another
        mesh than the one that saved."""
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        tree = _tree_like(flat, template)
        if shardings is None:
            return tree
        from repro_torch.launch.mesh import place
        return place(tree, shardings)
