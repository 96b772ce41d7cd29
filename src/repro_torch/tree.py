"""Trees of tensors, visited as JAX visits a pytree.

A tree is nested dicts, lists, tuples and NamedTuples with tensor (or
array, or scalar) leaves; None is an empty subtree.  Dict keys are
visited in sorted order, sequences by index and NamedTuple fields in
order, keyed ``.<field>`` (JAX's attribute key).  The checkpoint's leaf
keys, AdamW's leaf order and the train state's host snapshot all follow
this order, so one numpy seed gives the same trees in the port and in the
reference.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, path=()):
    """(path, leaf) pairs in the reference's pytree order and keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, path + ("." + f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def leaves_up_to(template, tree) -> List[Any]:
    """`tree`'s subtrees at the positions of `template`'s leaves, in
    visiting order (an AdamW moment that is a QTensor sits whole where its
    parameter does)."""
    if isinstance(template, dict):
        return [x for k in sorted(template)
                for x in leaves_up_to(template[k], tree[k])]
    if isinstance(template, (list, tuple)):
        return [x for t, s in zip(template, tree)
                for x in leaves_up_to(t, s)]
    if template is None:
        return []
    return [tree]


def pop_leaves(tree) -> Iterator[Any]:
    """`tree`'s leaves in visiting order, each dropped from its dict or
    list as it is taken, so that a consumed leaf can be freed (tuples,
    being immutable, keep theirs)."""
    if isinstance(tree, (dict, list, tuple)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        for k in keys:
            v = tree[k]
            if isinstance(v, (dict, list, tuple)):
                yield from pop_leaves(v)
            elif v is not None:
                if not isinstance(tree, tuple):
                    tree[k] = None
                yield v
    elif tree is not None:
        yield tree


def rebuild(template, values: Iterator[Any]):
    """`template`'s structure (container types included) with its leaves
    replaced, in visiting order, from the iterator `values`."""
    if isinstance(template, dict):
        out = {k: None for k in template}
        for k in sorted(template):
            out[k] = rebuild(template[k], values)
        return out
    if isinstance(template, (list, tuple)):
        items = [rebuild(v, values) for v in template]
        if is_namedtuple(template):
            return type(template)(*items)
        return items if isinstance(template, list) else tuple(items)
    if template is None:
        return None
    return next(values)


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the same-structured `rest`."""
    flat = [leaves(t) for t in (tree,) + rest]
    return rebuild(tree, iter([fn(*xs) for xs in zip(*flat)]))
