"""Captured decode steps: CUDA graphs over static buffers.

The port's counterpart of the JAX package's one-program decode loops (the
``lax.scan`` behind ``decode_program`` and ``ssm_decode_program``, and the
servers' ``jax.jit`` steps).  A ``StepProgram`` owns a step function that
reads and writes only tensors whose storage outlives it.  On the card its
first replay runs the step once on a side stream (the warm-up, which does
the host work a capture may not: nvcc builds, kernel attributes, cuBLAS
handles), captures it into one ``torch.cuda.CUDAGraph`` on that stream,
and from then on each replay launches the graph.  On the CPU the same
object calls the step function on the same buffers, with no graph: the
plain version of capture, as a kernel's plain version is.  A step that
cannot be captured raises; nothing runs it eagerly on the card instead.

Inputs go into the static buffers with ``copy_`` before a replay, host
values through pinned staging buffers, outside the graph: the captured
region makes no host copy, ``.item()`` or ``.tolist()``.

The kernels' launch counters (``kernels.launch_counts``) are host counters
that a wrapper bumps where it launches, and a graph replays kernels without
calling their wrappers.  So a capture records the launches it made
(``record_launches``) and takes them back, since a capture launches
nothing, and each replay credits them: a replayed kernel counts as a
launch.  The warm-up's launches are real and count.  ``STATS`` counts the
replays (graph launches on the card, step calls on the CPU) and the
captures, and sums the capture time.

A train step is a ``StepProgram`` with ``grad=True``: it runs with
autograd on (a decode step runs under ``torch.inference_mode()``), and its
first call on the card is the first real step, run eagerly on the side
stream (where it builds the kernels, makes the optimizer's state and warms
autograd and cuBLAS up) and kept, not undone; the step is captured right
after it, and every later call replays the graph.  Such a first call is a
capture and no replay.  ``weights_key`` and ``cached_program`` key and
bound the programs of the decode entry points, ``make_train_step`` and
``md.jit``: LRUs of 32 programs each.
"""

from __future__ import annotations

import contextlib
import itertools
import time

import torch

from minidiff_tpu_torch import kernels as K

__all__ = ["DecodeLoop", "STATS", "StepProgram", "cached_program",
           "record_launches", "reset_stats", "weights_key"]

STATS = {"replays": 0, "captures": 0, "capture_seconds": 0.0}


def reset_stats() -> None:
    STATS.update(replays=0, captures=0, capture_seconds=0.0)


def record_launches(fn):
    """``(fn(), {kernel: launches fn made})``, those launches taken back off
    the counters."""
    before = K.launch_counts()
    out = fn()
    made = {k: n - before[k] for k, n in K.launch_counts().items() if n != before[k]}
    K.credit_launches(made, -1)
    return out, made


def weights_key(model) -> tuple:
    """The storage of every parameter and buffer of ``model``: a captured
    graph reads the weights where they were at capture, so a model moved or
    re-allocated since needs another program."""
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                        model.buffers()))


def cached_program(cache, key, build, limit: int):
    """``cache[key]`` (an ``OrderedDict``), made by ``build()`` when
    missing; the least recently used entry goes past ``limit`` entries."""
    program = cache.get(key)
    if program is not None:
        cache.move_to_end(key)
        return program
    program = cache[key] = build()
    while len(cache) > limit:
        cache.popitem(last=False)
    return program


class StepProgram:
    """One step over static buffers, replayed as a CUDA graph on the card.

    ``fn()`` runs the step and returns its outputs; it reads its inputs
    from ``buffers`` ({name: tensor on ``device``}), which ``load`` fills.
    Graphs given one ``pool`` (``torch.cuda.graph_pool_handle()``) share
    their memory; their replays must not overlap, and on one stream they
    do not.  ``restore`` lists tensors the step changes in a way a second
    run would not repeat (a recurrent state): the warm-up's changes to them
    are undone before the capture.  ``grad=True`` makes a train step's
    program: autograd on, and the warm-up is the first real step.
    ``generators()`` lists the ``torch.Generator``s the step draws from,
    which a capture registers with its graph, so that each replay draws
    anew as the step does on the CPU (a capture refuses a draw from a
    generator it does not know).
    """

    def __init__(self, fn, buffers: dict, device, pool=None, restore=(),
                 grad: bool = False, generators=tuple):
        self.fn = fn
        self.buffers = buffers
        self.device = torch.device(device)
        self.pool = pool
        self.restore = list(restore)
        self.grad = grad
        self.generators = generators
        self.graph = None
        self.outputs = None
        self.launches: dict = {}
        self.capture_seconds = 0.0
        self._staging: dict = {}
        self._copied = None

    def load(self, **values) -> None:
        """Copy ``values`` into the buffers of the same names: a tensor on
        the program's device directly, host values (arrays, lists or CPU
        tensors) on the card through a pinned staging buffer, once the
        previous load's copies are done."""
        cuda = self.device.type == "cuda"
        if cuda and self._copied is not None:
            self._copied.synchronize()
        for name, value in values.items():
            buf = self.buffers[name]
            if isinstance(value, torch.Tensor) and value.device == buf.device:
                buf.copy_(value)
            elif cuda:
                stage = self._staging.get(name)
                if stage is None:
                    stage = self._staging[name] = torch.empty(
                        buf.shape, dtype=buf.dtype, pin_memory=True)
                stage.copy_(torch.as_tensor(value).reshape(buf.shape))
                buf.copy_(stage, non_blocking=True)
            else:
                buf.copy_(torch.as_tensor(value).reshape(buf.shape))
        if cuda:
            if self._copied is None:
                self._copied = torch.cuda.Event()
            self._copied.record()

    def _mode(self):
        return contextlib.nullcontext() if self.grad else torch.inference_mode()

    def capture(self):
        """Warm up and capture the step (on the card, once).  Returns what
        the warm-up step returned."""
        if self.device.type != "cuda" or self.graph is not None:
            return None
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._mode(), torch.cuda.stream(stream):
            saved = [t.clone() for t in self.restore]
            warm = self.fn()
            for t, s in zip(self.restore, saved):
                t.copy_(s)
            del saved
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators():
            graph.register_generator_state(gen)

        def capture():
            with self._mode(), torch.cuda.graph(graph, pool=self.pool, stream=stream):
                return self.fn()

        self.outputs, self.launches = record_launches(capture)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0
        STATS["captures"] += 1
        STATS["capture_seconds"] += self.capture_seconds
        return warm

    def replay(self):
        """Run the step once: a graph launch on the card (the capture first,
        at the first replay), the step function on the CPU.  Returns the
        outputs, which the next replay overwrites.  A ``grad`` program's
        first call on the card runs the step eagerly, captures it and
        returns the eager step's outputs, with no replay."""
        if self.device.type != "cuda":
            with self._mode():
                self.outputs = self.fn()
        elif self.grad and self.graph is None:
            return self.capture()
        else:
            self.capture()
            self.graph.replay()
            K.credit_launches(self.launches)
        STATS["replays"] += 1
        return self.outputs

    def run(self, **values):
        """``load(**values)``, then ``replay()``."""
        self.load(**values)
        return self.replay()


class DecodeLoop:
    """A compiled decode: ``(prompt (B, S0) int, seed) -> (B, S0 + new)``
    int64 on the program's device, an eager prefill then ``new - 1``
    replays of one captured token step.

    ``prefill(prompt)`` runs the prompt's parallel forward into the
    program's static state and returns the last position's logits (B, V);
    ``forward(tok (B,), pos (B,))`` runs one token per row at position pos
    against that state, updating it in place, and returns logits (B, V);
    ``select(logits, seed (B,), pos (B,))`` picks the next tokens, its
    noise keyed by (seed, position, row).  Inside the graph each step
    writes its token into a static (B, new) buffer at a device column
    index, feeds it to the next step and advances the positions, so the
    host loop only replays.  The step is captured at construction, on the
    state as it stands; every call's prefill rewrites that state whole.
    """

    def __init__(self, b: int, s0: int, new: int, device, prefill, forward, select):
        dev = torch.device(device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.long, device=dev)

        self.s0, self.new = s0, new
        self.tok, self.pos, self.seed = zeros(b), zeros(b), zeros(b)
        self.col, self.out = zeros(1), zeros(b, new)
        self._prefill, self._select = prefill, select

        def step():
            nxt = select(forward(self.tok, self.pos), self.seed, self.pos)
            self.out.index_copy_(1, self.col, nxt[:, None])
            self.tok.copy_(nxt)
            self.pos.add_(1)
            self.col.add_(1)

        self.step = StepProgram(step, {}, dev) if new > 1 else None
        if self.step is not None:
            self.step.capture()

    def __call__(self, prompt, seed: int = 0):
        prompt = torch.as_tensor(prompt, dtype=torch.long).to(self.out.device)
        with torch.inference_mode():
            self.seed.fill_(int(seed) & 0xFFFFFFFF)
            self.pos.fill_(self.s0 - 1)
            first = self._select(self._prefill(prompt), self.seed, self.pos)
            self.out[:, 0] = first
            self.tok.copy_(first)
            self.pos.fill_(self.s0)
            self.col.fill_(1)
            for _ in range(self.new - 1):
                self.step.replay()
            return torch.cat([prompt, self.out], dim=1)
