"""The tape: OpNode graph nodes and the reverse-mode backward engine.

The port of ``minidiff_tpu/tape.py``:

* ``OpNode`` records (forward fn, per-input VJPs, inputs, kwargs) and counts
  its tensor inputs' consumers.
* ``update_grads`` applies the chain rule per input, undoes broadcasting and
  accumulates; VJPs marked ``needs_output`` get the node's forward result.
* ``backward`` drives the reverse sweep with three cleanup modes (keep /
  prune / destroy).  ``allow_higher_order`` runs the VJPs under grad mode, so
  they build a fresh tape (which is what makes ``x.grad.backward()`` work); it
  forces ``retain_grads`` and turns ``destroy`` into ``prune``.  ``prune``
  wipes only tensors whose consumer count has reached 0.
* ``toposort`` is an iterative DFS with the postorder of a recursive one.

Under ``reuse_graph`` the sweep replays the cached traversal order
(``caching.replay_traversal``) and runs the VJPs eagerly, as the JAX package
does off XLA.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import minidiff_tpu_torch as md
import minidiff_tpu_torch.caching as mdc

if TYPE_CHECKING:
    from typing import Any, Callable, Dict, List, Literal, Optional, Sequence


class OpNode:
    def __init__(
        self,
        forward_func: "Callable[..., Any]",
        grad_functions: "Sequence[Optional[Callable[..., Any]]]",
        op_inputs: "Sequence[Any]",
        op_kwargs: "Optional[Dict[str, Any]]" = None,
        op_name: "Optional[str]" = None,
        kwargs_to_grads: bool = False,
    ):
        self.forward_func = forward_func
        self.grad_functions = grad_functions
        self.op_inputs = op_inputs
        self.op_kwargs = op_kwargs or {}
        self.op_name = op_name or ""
        self.kwargs_to_grads = kwargs_to_grads

        self.tensor_inputs = [x for x in op_inputs if isinstance(x, md.Tensor)]
        for tensor in self.tensor_inputs:
            tensor.consumer_refs += 1

        # Structural metadata, built only under reuse_graph: _struct_sig
        # hashes the graph's shape, _tensor_graph is the nested list that a
        # cached traversal order is replayed from by index.
        self._tensor_graph: list = []
        # replay is only trusted if every reachable node was built under
        # reuse_graph; a node built outside poisons the flag and backward
        # does a real toposort
        self._cache_meta_complete = mdc.currently_caching()
        if not mdc.currently_caching():
            self._struct_sig: tuple = ()
            return

        ids: list = []
        seen_pos: dict = {}
        for pos, op_input in enumerate(self.op_inputs):
            if not isinstance(op_input, md.Tensor):
                ids.append(("const",))
                continue
            # repeated inputs (x*x against a*b) must hash apart: their
            # _tensor_graph layouts differ
            first = seen_pos.setdefault(id(op_input), pos)
            # the consumer count at consumption time tells a diamond's second
            # consumer (refs 2) from an unshared twin (refs 1)
            share = op_input.consumer_refs
            if op_input.is_leaf:
                ids.append(("leaf", first, share))
            else:
                node = op_input.op_node
                if not node._struct_sig or not node._cache_meta_complete:
                    self._cache_meta_complete = False
                ids.append((first, share, node._struct_sig))
        # per-call forwards carry a stable structural token: a raw id() would
        # never repeat across calls and could alias a recycled one
        ids.append(getattr(forward_func, "_structural_id", None) or id(forward_func))
        self._struct_sig = tuple(ids)

        seen: set = set()
        for op_input in self.op_inputs:
            if not isinstance(op_input, md.Tensor) or id(op_input) in seen:
                continue
            if not op_input.is_leaf:
                self._tensor_graph.append(op_input.op_node._tensor_graph)
            self._tensor_graph.append(op_input)
            seen.add(id(op_input))

    @property
    def hash(self) -> int:
        return hash(self._struct_sig)

    def update_grads(self, grad: "md.Tensor",
                     output: "Optional[md.Tensor]" = None) -> None:
        """Chain rule: accumulate VJP(grad) into each tracked input's .grad.

        Runs in the caller's grad mode: backward enables it only for
        higher-order sweeps, so these VJP calls re-tape exactly then.
        ``output`` is this node's forward result, handed to VJPs marked
        ``needs_output``.
        """
        for op_input, grad_function in zip(self.op_inputs, self.grad_functions):
            if not isinstance(op_input, md.Tensor) or not op_input.allow_grad:
                continue
            if grad_function is None:
                continue
            kwargs = self.op_kwargs if self.kwargs_to_grads else {}
            if getattr(grad_function, "needs_output", False):
                kwargs = dict(kwargs)
                kwargs["_output"] = output
            grad_computation = grad_function(*self.op_inputs, grad, **kwargs)
            # forward broadcasting is undone so the grad has the input's shape
            if grad_computation.shape == op_input.shape:
                collected = grad_computation
            else:
                collected = md.unbroadcast(grad_computation, op_input.shape)
            if op_input.grad is None:
                op_input.grad = collected
            else:
                op_input.grad = op_input.grad + collected

    def toposort(self) -> "List[md.Tensor]":
        """Postorder over the tensor DAG feeding this node: inputs appear
        after everything beneath them."""
        seen: set = set()
        order: list = []
        # "node" expands a node's inputs, "child" does the seen-check at
        # visit time (marking at push time would emit a shared tensor before
        # a consumer that reaches it through a deeper path), "emit" appends
        # once the subtree is done
        work: list = [("node", self)]
        while work:
            kind, item = work.pop()
            if kind == "emit":
                order.append(item)
            elif kind == "child":
                if id(item) in seen:
                    continue
                seen.add(id(item))
                work.append(("emit", item))
                work.append(("node", item.op_node))
            elif item is not None:
                for op_input in reversed(item.tensor_inputs):
                    work.append(("child", op_input))
        return order

    def backward(
        self,
        seed_grad: "md.Tensor",
        retain_grads: bool = False,
        cleanup_mode: "Literal['keep', 'prune', 'destroy']" = "prune",
        allow_higher_order: bool = False,
        reset_grads: bool = True,
        root_output: "Optional[md.Tensor]" = None,
    ) -> None:
        if cleanup_mode not in ("keep", "prune", "destroy"):
            raise ValueError(
                f"unknown cleanup_mode {cleanup_mode!r}; "
                "expected 'keep', 'prune', or 'destroy'")

        # a higher-order sweep goes over the same subgraph again, so the
        # intermediates' grads and the graph itself must survive
        if allow_higher_order:
            retain_grads = True
            if cleanup_mode == "destroy":
                cleanup_mode = "prune"

        if mdc.currently_caching() and self._cache_meta_complete:
            traversal_path = mdc.replay_traversal(self)
        else:
            traversal_path = self.toposort()

        if reset_grads:
            for tensor in traversal_path:
                tensor.grad = None

        with md.enable_grad(allow_higher_order):
            self.update_grads(seed_grad, output=root_output)
            for tensor in reversed(traversal_path):
                if tensor.is_leaf:
                    continue
                grad = tensor.grad
                if grad is None:
                    # reached only through None-VJP slots (where's condition,
                    # getitem keys): nothing to propagate
                    continue
                node = tensor.op_node
                node.update_grads(grad, output=tensor)
                if not retain_grads:
                    tensor.grad = None

                if cleanup_mode == "keep":
                    continue
                if cleanup_mode == "destroy":
                    tensor.wipe()
                    continue
                # prune: free this subgraph once nothing else references it
                if tensor.consumer_refs > 0:
                    continue
                for child in node.tensor_inputs:
                    child.consumer_refs -= 1
                tensor.wipe()

    def __repr__(self) -> str:
        return f"{self.op_name}({', '.join(str(x) for x in self.op_inputs)})"
