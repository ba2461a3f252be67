"""Nested params as flat, path-keyed dicts, and back.

The transformer encoder's params nest: `params["xf"]` is a dict that
holds a list of per-layer dicts. The optimizers work over flat dicts of
tensors, so the optimizer boundary flattens the params to leaves keyed
by their path, the parts joined by "/" (`"xf/layers/0/qkv"`), and a
state carried to or from the JAX package is rebuilt as the nested tree.
A top-level key is its own path, so a flat params dict (the bag model's)
is unchanged by either direction.

`unflatten` turns a level whose keys are all digits back into a list,
ordered by the number: `jax.tree_util.tree_leaves` orders list items by
index and dict keys as sorted strings, and flat paths sorted as strings
would put "layers/10" before "layers/2".
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

SEP = "/"


def flatten(tree: Dict[str, Any],
            is_leaf: Optional[Callable[[Any], bool]] = None
            ) -> Dict[str, Any]:
    """Nested dicts and lists -> {path: leaf}, in depth-first order.
    Anything else, or a node for which `is_leaf` is true, is a leaf."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        if is_leaf is not None and path and is_leaf(node):
            out[path] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}{SEP}{k}" if path else str(k))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}{SEP}{i}")
        else:
            out[path] = node
    walk(tree, "")
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `flatten` for trees of dicts and lists."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, last = path.split(SEP)
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def map_leaves(fn: Callable[[Any], Any], tree):
    """`fn` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)
