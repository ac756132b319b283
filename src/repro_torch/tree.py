"""Nested dict/tuple parameter trees, flattened in ``jax.tree_util`` order
(dict keys sorted, sequences in order) so that flat buffers are
byte-identical to the JAX package's."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple

Path = Tuple[Any, ...]


def leaves_with_path(tree, path: Path = (), is_leaf: Callable = None
                     ) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in flatten order; ``None`` is an empty subtree."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,), is_leaf)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,), is_leaf)
    elif tree is not None:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [x for _, x in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def from_paths(paths: Sequence[Path], values: Sequence[Any]):
    """Rebuild a tree from (path, value) pairs: string keys make dicts,
    integer keys make tuples."""
    root: dict = {}
    for path, v in zip(paths, values):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return tuple(fix(node[i]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}
    return fix(root)
