"""Nested dicts and lists of tensors, walked in ``jax.tree``'s leaf order —
the port's stand-in for the ``jax.tree`` calls of the train substrate.

Dict keys are visited sorted, lists and tuples by index, as
``jax.tree.leaves`` and ``jax.tree_util.tree_flatten_with_path`` visit
them: sums over leaves run in the JAX package's order, and a leaf's key
(``"params/mlp/0/w"``) names the same leaf in both packages' checkpoints.
Anything that is not a dict, list or tuple is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

SEP = "/"


def leaves_with_paths(tree, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf)]`` in leaf order; a path is a tuple of dict keys
    and list indices."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def key_of(path: tuple) -> str:
    """A path as the checkpoint key JAX writes: its parts joined by
    ``/``."""
    return SEP.join(str(p) for p in path)


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (the same structure), keeping the structure."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or sorted(other) != sorted(tree):
                raise ValueError(f"trees differ: keys {sorted(tree)}")
        return {k: map_tree(fn, v, *(o[k] for o in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        for other in rest:
            if (not isinstance(other, (list, tuple))
                    or len(other) != len(tree)):
                raise ValueError(f"trees differ: a sequence of "
                                 f"{len(tree)}")
        out = [map_tree(fn, v, *(o[i] for o in rest))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def unflatten(like, new_leaves: list):
    """The structure of ``like`` with ``new_leaves`` (in ``leaves(like)``'s
    order) in place of its leaves."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, it) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree holds") from None
