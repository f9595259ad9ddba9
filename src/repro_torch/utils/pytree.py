"""Nested-dict utilities (port of ``repro.utils.pytree``).

Parameter collections are nested dicts of tensors; blocks are named by
'/'-joined key paths (``layers/3/attn/wq``). Dict keys are visited in
sorted order, exactly as the reference's tree flattening does, so block
order (and with it every allocator tie-break) matches the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_container(node: Any) -> bool:
    return isinstance(node, (dict, list, tuple)) and not hasattr(node, "_fields")


def named_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> List[Tuple[str, Any]]:
    """Flatten into (path, leaf) pairs in deterministic (sorted-key) order.
    QTensors are always leaves."""
    from repro_torch.qtensor import is_qtensor

    out: List[Tuple[str, Any]] = []

    def rec(node, prefix):
        if (is_leaf is not None and is_leaf(node)) or is_qtensor(node) \
                or not _is_container(node):
            out.append(("/".join(prefix), node))
            return
        items = (sorted(node.items()) if isinstance(node, dict)
                 else enumerate(node))
        for k, v in items:
            rec(v, prefix + [str(k)])

    rec(tree, [])
    return out


def map_with_names(fn: Callable[[str, Any], Any], tree: Any,
                   is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Map ``fn(path, leaf)`` over every leaf, keeping the structure."""
    from repro_torch.qtensor import is_qtensor

    def rec(node, prefix):
        if (is_leaf is not None and is_leaf(node)) or is_qtensor(node) \
                or not _is_container(node):
            return fn("/".join(prefix), node)
        if isinstance(node, dict):
            return {k: rec(v, prefix + [str(k)]) for k, v in node.items()}
        return type(node)(rec(v, prefix + [str(i)]) for i, v in enumerate(node))

    return rec(tree, [])


def tree_leaves(tree: Any) -> List[Any]:
    """The array leaves in the reference's flattening order: dicts by
    sorted key, lists, tuples and NamedTuples by position, a QTensor as
    its payload and its scales, ``None`` as no leaf."""
    from repro_torch.qtensor import is_qtensor

    if tree is None:
        return []
    if is_qtensor(tree):
        return [tree.data, tree.scale]
    if isinstance(tree, dict):
        return [x for _, v in sorted(tree.items()) for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Map ``fn`` over the leaves of dicts, lists, tuples and NamedTuples
    (the containers a batch comes in), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree)


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(leaf.numel() if isinstance(leaf, torch.Tensor) else int(np.size(leaf))
               for leaf in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    return sum(leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
               else int(np.asarray(leaf).nbytes) for leaf in tree_leaves(tree))


def block_paths(tree: Any) -> List[str]:
    """All leaf paths, the default block granularity for FIT."""
    return [name for name, _ in named_leaves(tree)]


def get_by_path(tree: Any, path: str) -> Any:
    node = tree
    for part in path.split("/"):
        if isinstance(node, (list, tuple)):
            node = node[int(part)]
        else:
            node = node[part]
    return node


def set_by_path(tree: Dict, path: str, value: Any) -> Dict:
    """Functionally set tree[path] = value (returns a new nested dict)."""
    parts = path.split("/")

    def rec(node, i):
        if i == len(parts):
            return value
        key = parts[i]
        if isinstance(node, dict):
            new = dict(node)
            new[key] = rec(node[key], i + 1)
            return new
        if isinstance(node, (list, tuple)):
            idx = int(key)
            new = list(node)
            new[idx] = rec(node[idx], i + 1)
            return type(node)(new)
        raise TypeError(f"cannot descend into {type(node)} at {path}")

    return rec(tree, 0)
