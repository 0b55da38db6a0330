"""Toposort-order cache for repeated backward passes over identical graphs.

The port of ``minidiff_tpu/caching.py``: under ``reuse_graph``, every OpNode
also records a structural hash and a nested ``_tensor_graph`` list; the
first backward for a given graph *shape* pays a traversal, and later
backwards with the same hash replay the order by indexing into the nested
list, with no DFS.

One DFS over the OpNode graph emits the postorder and assigns each visited
tensor its index path as it descends: ``OpNode.__init__`` lays a node's
``_tensor_graph`` out deterministically (for each first-occurrence tensor
input, ``[child graph (if non-leaf), tensor]`` in op-input order), so while
expanding a node whose list lives at path ``P`` the k-th unique input's
slots are ``P + (i,)``.  The nested list is walked only to replay.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from typing import List

    import minidiff_tpu_torch as md

_replay_enabled = ContextVar("graph_replay_enabled", default=False)
_replay_paths = ContextVar("graph_replay_paths", default=None)


class reuse_graph:
    """Context manager enabling structural graph caching.

    Inside the context, backwards over graphs of identical structure skip
    the traversal and replay the cached order.
    """

    def __enter__(self):
        self._prev = _replay_enabled.get()
        _replay_enabled.set(True)
        _replay_paths.set({})

    def __exit__(self, exc_type, exc, tb):
        _replay_enabled.set(self._prev)
        _replay_paths.set({})


def currently_caching() -> bool:
    return _replay_enabled.get()


def backward_indices_for_root(root_node: "md.OpNode") -> tuple:
    """Index paths (into the nested ``_tensor_graph``) in toposort order.

    Cache miss: one fused DFS assigns paths while producing the postorder
    (see module docstring).  Cache hit: return the memoized paths.  The
    emitted order is identical to ``OpNode.toposort()`` — same visit-time
    seen-check, same child ordering — so replay and fresh traversals are
    interchangeable.
    """
    import minidiff_tpu_torch as md

    if not _replay_enabled.get():
        raise ValueError(
            "toposort replay requires an active reuse_graph() context")

    graph_hash = root_node.hash
    memo = _replay_paths.get()
    if graph_hash in memo:
        return memo[graph_hash]

    order: list = []
    seen: set = set()
    # Frames: ("node", opnode, base) expands a node whose _tensor_graph
    # list sits at index path `base`; ("child", tensor, tpath, gpath)
    # visits a tensor whose own slot is `tpath` and whose producing
    # node's graph list (None for leaves) is `gpath`; ("emit", _, tpath)
    # appends after the subtree completes.
    work: list = [("node", root_node, ())]
    while work:
        frame = work.pop()
        kind = frame[0]
        if kind == "emit":
            order.append(frame[2])
        elif kind == "child":
            _, tensor, tpath, gpath = frame
            if id(tensor) in seen:
                continue
            seen.add(id(tensor))
            work.append(("emit", None, tpath))
            if gpath is not None:
                work.append(("node", tensor.op_node, gpath))
        else:
            _, node, base = frame
            if node is None:
                continue
            # reproduce __init__'s slot layout: first-occurrence tensor
            # inputs in op-input order, non-leaves preceded by their graph
            children: list = []
            slot = 0
            local_seen: set = set()
            for op_input in node.op_inputs:
                if not isinstance(op_input, md.Tensor):
                    continue
                if id(op_input) in local_seen:
                    continue
                local_seen.add(id(op_input))
                if op_input.is_leaf:
                    children.append((op_input, base + (slot,), None))
                    slot += 1
                else:
                    children.append(
                        (op_input, base + (slot + 1,), base + (slot,)))
                    slot += 2
            for tensor, tpath, gpath in reversed(children):
                work.append(("child", tensor, tpath, gpath))

    indices = tuple(order)
    memo[graph_hash] = indices
    return indices


def replay_traversal(root_node: "md.OpNode") -> "List[md.Tensor]":
    """Materialize the cached traversal order by walking index paths.

    Defensive: if a cached path does not fit this graph's nested list (a
    structural-hash collision the alias signature didn't cover), rebuild via
    a real toposort instead of crashing or silently reordering.
    """
    import minidiff_tpu_torch as md

    full_graph = root_node._tensor_graph
    traversal_indices = backward_indices_for_root(root_node)
    path: list = [None] * len(traversal_indices)
    try:
        for i, indices in enumerate(traversal_indices):
            item = full_graph
            for index in indices:
                item = item[index]
            if not isinstance(item, md.Tensor):
                raise TypeError
            path[i] = item
    except (IndexError, TypeError):
        path = root_node.toposort()
        _replay_paths.get().pop(root_node.hash, None)
    return path
