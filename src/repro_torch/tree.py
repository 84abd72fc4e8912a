"""Parameter trees: nested dicts, lists, tuples and NamedTuples of tensors.

The port's params, optimizer states and train states are plain trees, as
in the JAX package.  Dict entries are visited in sorted key order (the
order ``jax.tree_util`` uses), so sums over leaves run in the same order.
``None`` is an empty subtree.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in flattening order; paths look like
    ``.params['blocks'][0]['attn']['wq']['w']``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], f"{prefix}[{key!r}]")
    elif _is_namedtuple(tree):
        for name, child in zip(tree._fields, tree):
            yield from tree_items(child, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from tree_items(child, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in flattening order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` in flattening order."""
    paths = [path for path, _ in tree_items(template)]
    if len(paths) != len(leaves):
        raise ValueError(f"template has {len(paths)} leaves, got {len(leaves)}")
    return _rebuild(template, dict(zip(paths, leaves)), "")


def _rebuild(tree: Any, by_path: dict, prefix: str) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], by_path, f"{prefix}[{k!r}]") for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(c, by_path, f"{prefix}.{n}")
                            for n, c in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(c, by_path, f"{prefix}[{i}]")
                          for i, c in enumerate(tree))
    return by_path[prefix]
