"""Nested dicts and lists of tensors (the port's parameter trees).

Leaves come in a fixed order: dict entries by sorted key, as JAX flattens
a dict, and lists in order."""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` in ``tree_leaves``'s order."""
    return _fill(tree, iter(leaves))


def _fill(node, it):
    # a module function, not a closure that calls itself: such a closure
    # is a reference cycle, which would keep every leaf alive until the
    # cyclic collector runs
    if isinstance(node, dict):
        done = {k: _fill(node[k], it) for k in sorted(node)}
        return {k: done[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, it) for v in node)
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which have its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def is_layer_group(key: str) -> bool:
    """A group of stacked per-layer leaves, at any depth of a model tree:
    ``"layers"``, a name ending in ``"_layers"``, or a CLIP ``"tower"``."""
    return key in ("layers", "tower") or key.endswith("_layers")


def layer_params(layers, li: int) -> Dict:
    """Layer ``li`` of a stacked group (quantized leaves slice both their
    int8 values and their scales), or of a per-layer list."""
    if isinstance(layers, (list, tuple)):
        return layers[li]
    return {k: ({"q": v["q"][li], "s": v["s"][li]} if isinstance(v, dict)
                else v[li]) for k, v in layers.items()}


def unstack_layers(params):
    """The tree with each stacked layer group (``is_layer_group``, found at
    any depth) as a list of per-layer dicts whose tensors are views of the
    stacked leaves (sharing their storage, so an in-place update of a
    layer's tensor updates the stacked leaf). A group that is a list
    already is left as it is; other leaves are the same tensors."""
    if isinstance(params, list):
        return [unstack_layers(node) for node in params]
    if not isinstance(params, dict):
        return params
    out = {}
    for key, node in params.items():
        if not is_layer_group(key):
            out[key] = unstack_layers(node)
        elif isinstance(node, dict):
            n = len(next(iter(node.values())))
            out[key] = [{k: v[li] for k, v in node.items()}
                        for li in range(n)]
        else:
            out[key] = node
    return out
