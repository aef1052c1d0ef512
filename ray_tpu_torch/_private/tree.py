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
    """A top-level group of stacked per-layer leaves: ``"layers"`` or a
    name ending in ``"_layers"``, the convention of every model tree."""
    return key == "layers" or key.endswith("_layers")


def layer_params(layers, li: int) -> Dict:
    """Layer ``li`` of a stacked group (quantized leaves slice both their
    int8 values and their scales), or of a per-layer list."""
    if isinstance(layers, (list, tuple)):
        return layers[li]
    return {k: ({"q": v["q"][li], "s": v["s"][li]} if isinstance(v, dict)
                else v[li]) for k, v in layers.items()}


def unstack_layers(params: Dict) -> Dict:
    """The tree with each stacked layer group (``is_layer_group``) as a
    list of per-layer dicts whose tensors are views of the stacked leaves
    (sharing their storage, so an in-place update of a layer's tensor
    updates the stacked leaf)."""
    out = dict(params)
    for key, group in params.items():
        if is_layer_group(key) and isinstance(group, dict):
            n = len(next(iter(group.values())))
            out[key] = [{k: v[li] for k, v in group.items()}
                        for li in range(n)]
    return out
