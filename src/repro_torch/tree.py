"""Parameter trees: nested dicts (and NamedTuples, like ``AdamWState``)
of tensors, walked in the order ``jax.tree_util`` walks them.

Dict keys are visited sorted and NamedTuple fields in order, so a leaf's
path and position equal the JAX package's for the same tree.  A path is
its keys joined by ``/``, a NamedTuple field written ``.name``: the keys
``repro.training.checkpoint`` stores leaves under (``params/embed``,
``opt/.m/blocks/attn/wq``), so checkpoints read across packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the JAX package's leaf order."""
    out: List[Tuple[str, Any]] = []
    _flatten_into(tree, (), out)
    return out


def _flatten_into(x, path, out) -> None:
    # A module-level walk, not a closure: a recursive closure is a
    # reference cycle that would hold ``out`` — every leaf — until the
    # garbage collector runs (a train step's whole state on the card).
    if isinstance(x, dict):
        for k in sorted(x):
            _flatten_into(x[k], path + (str(k),), out)
    elif _is_namedtuple(x):
        for k in x._fields:
            _flatten_into(getattr(x, k), path + ("." + k,), out)
    else:
        out.append(("/".join(path), x))


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def map_leaves(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same-shaped ``rest``),
    keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, getattr(tree, k),
                                       *(getattr(r, k) for r in rest))
                            for k in tree._fields))
    return fn(tree, *rest)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure holding ``new_leaves`` (in ``flatten`` order)."""
    it = iter(new_leaves)
    order = {path: next(it) for path, _ in flatten(like)}
    return _rebuild(like, (), order)


def _rebuild(x, path, order):
    # Module-level for the reason ``_flatten_into`` is.
    if isinstance(x, dict):
        return {k: _rebuild(x[k], path + (str(k),), order) for k in x}
    if _is_namedtuple(x):
        return type(x)(*(_rebuild(getattr(x, k), path + ("." + k,), order)
                         for k in x._fields))
    return order["/".join(path)]
