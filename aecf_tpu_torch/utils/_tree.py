"""Pytree walking for the utilities: dicts, lists and tuples, with JAX's
``keystr`` path format."""

from __future__ import annotations

from typing import Any, Iterator, Tuple


def tree_leaves_with_path(tree: Any,
                          path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf of ``tree`` in JAX's flattening
    order: dict entries by sorted key, lists and tuples by index, ``None``
    an empty subtree.  Paths read as JAX's ``keystr``: ``"['pool']['wq']"``,
    ``"[0]"``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves_with_path(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from tree_leaves_with_path(item, f"{path}[{i}]")
    else:
        yield path, tree
