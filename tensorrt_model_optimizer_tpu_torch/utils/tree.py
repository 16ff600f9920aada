"""Nested trees of tensors <-> flat name dicts (port of `utils/tree.py`).

A tree is dicts, lists, tuples and dataclasses (`QuantizerState`) over
tensors; None is an empty subtree. Names are JAX's `tree_flatten_with_path`
key strings joined by "/": a dict key, a sequence index, a dataclass field
name, with dict keys in sorted order (as JAX walks them). So
"layers/mlp.down_proj" names a stacked weight and "mlp.down_proj/weight/amax"
a quantizer's amax in both packages, and a file written by either reads
back in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def _children(node) -> list:
    """[(key string, child)] of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def flatten_with_names(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten a tree into {"a/b/c": leaf} (None leaves dropped)."""
    out: dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out[prefix + "/".join(path)] = node
            return
        for key, child in kids:
            walk(child, path + [key])

    walk(tree, [])
    return out


def map_tensors(fn: Callable, tree: Any) -> Any:
    """The same tree with `fn` applied to every tensor leaf (other leaves and
    None kept), leaf by leaf in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_tensors(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def map_pairs(fn: Callable, a: Any, b: Any) -> Any:
    """`a`'s tree with fn(x, y) at each tensor leaf x of `a`, y the leaf of
    `b` (a tree of the same structure) at the same place; a leaf where `b`
    holds None is kept."""
    if isinstance(a, torch.Tensor):
        return a if b is None else fn(a, b)
    if isinstance(a, dict):
        return {k: map_pairs(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(map_pairs(fn, x, y) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return dataclasses.replace(a, **{f.name: map_pairs(fn, getattr(a, f.name), getattr(b, f.name))
                                         for f in dataclasses.fields(a)})
    return a


def unflatten_like(template: Any, named: dict[str, Any], prefix: str = "") -> Any:
    """Rebuild `template`'s structure with each leaf whose name is in
    `named` replaced by that value (as a tensor on the leaf's device); other
    leaves, and None subtrees, are kept."""

    def build(node, path):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            key = prefix + "/".join(path)
            if key not in named:
                return node
            val = named[key]
            val = val if isinstance(val, torch.Tensor) else torch.as_tensor(val)
            return val.to(node.device) if isinstance(node, torch.Tensor) else val
        rebuilt = {key: build(child, path + [key]) for key, child in kids}
        if isinstance(node, dict):
            return {k: rebuilt[str(k)] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuilt[str(i)] for i in range(len(node)))
        return dataclasses.replace(node, **rebuilt)

    return build(template, [])


def nest(named: dict[str, Any], sep: str = "/") -> dict:
    """{"a/b": v} -> {"a": {"b": v}}: the dict tree that `flatten_with_names`
    flattens to these names (a tree of dicts only)."""
    out: dict = {}
    for key, val in named.items():
        *head, last = key.split(sep)
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = val
    return out
