"""Trees of tensors: nested dicts, lists and tuples, as the JAX package's
``jax.tree`` functions see them.

Leaves are visited in the order ``jax.tree.flatten`` visits a tree of
dicts and sequences: dict keys sorted, lists and tuples in order.  The
optimizers, gradient clipping and the checkpoint manager walk trees in
this order, so a checkpoint of nested dicts of arrays lists its leaves
as the reference's does, and a sum over leaves adds them in the same
order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

_HOLE = object()


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    def __init__(self, skeleton: Any, n_leaves: int):
        self._skeleton = skeleton
        self.num_leaves = n_leaves

    def unflatten(self, leaves) -> Any:
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"tree has {self.num_leaves} leaves, got "
                             f"{len(leaves)}")
        it = iter(leaves)

        def fill(node):
            if node is _HOLE:
                return next(it)
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            return type(node)(fill(v) for v in node)

        return fill(self._skeleton)

    def flatten_up_to(self, tree) -> List[Any]:
        """The subtrees of ``tree`` at this structure's leaves, in order
        (``tree`` has this structure, with any subtree at each leaf)."""
        out: List[Any] = []

        def walk(node, sub):
            if node is _HOLE:
                out.append(sub)
            elif isinstance(node, dict):
                if not isinstance(sub, dict) or set(sub) != set(node):
                    raise ValueError(f"tree does not have the structure {self}")
                for k, v in node.items():
                    walk(v, sub[k])
            else:
                if not isinstance(sub, (list, tuple)) or len(sub) != len(node):
                    raise ValueError(f"tree does not have the structure {self}")
                for v, x in zip(node, sub):
                    walk(v, x)

        walk(self._skeleton, tree)
        return out

    def __str__(self) -> str:
        def show(node):
            if node is _HOLE:
                return "*"
            if isinstance(node, dict):
                return "{" + ", ".join(f"{k!r}: {show(v)}"
                                       for k, v in node.items()) + "}"
            inner = ", ".join(show(v) for v in node)
            if isinstance(node, tuple):
                return f"({inner}{',' if len(node) == 1 else ''})"
            return f"[{inner}]"

        return f"PyTreeDef({show(self._skeleton)})"

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and str(self) == str(other)


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """→ (leaves in the reference's order, the tree's structure)."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        leaves.append(node)
        return _HOLE

    skeleton = walk(tree)
    return leaves, TreeDef(skeleton, len(leaves))


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure)."""
    flat, treedef = flatten(tree)
    others = [flatten(r) for r in rest]
    for leaves_r, def_r in others:
        if def_r != treedef:
            raise ValueError(f"tree structures differ: {treedef} and {def_r}")
    return treedef.unflatten(fn(*xs) for xs in
                             zip(flat, *(lv for lv, _ in others)))
