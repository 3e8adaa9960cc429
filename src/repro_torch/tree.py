"""Trees of tensors: nested dicts, lists and tuples, the port's stand-in
for jax's pytrees.  Leaves are visited in a fixed order: dicts in
insertion order, sequences by index.  A leaf's path is the tuple of
dict keys (str) and sequence indices (int) that reach it."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

__all__ = ["tree_map", "tree_map_with_path", "leaves", "flatten_with_path"]


def tree_map(fn: Callable, tree) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)`` (dicts stay
    dicts, lists lists and tuples tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()) -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def flatten_with_path(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) for every leaf, in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> Iterator[Any]:
    for _, leaf in flatten_with_path(tree):
        yield leaf
