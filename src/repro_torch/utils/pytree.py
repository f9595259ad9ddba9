"""Nested-dict utilities (port of ``repro.utils.pytree``).

Parameter collections are nested dicts of tensors; blocks are named by
'/'-joined key paths (``layers/3/attn/wq``). Dict keys are visited in
sorted order, exactly as the reference's tree flattening does, so block
order (and with it every allocator tie-break) matches the reference.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


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
