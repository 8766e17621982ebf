"""One step of a program as a CUDA graph: captured once, then replayed.

The port's counterpart of the reference's compiled programs (its
``jax.jit`` of the serving step and its ``lax.scan`` over an epoch's
train steps).  A :class:`StepGraph` wraps ``fn()``, a function of no
arguments that reads its inputs from tensors at fixed addresses (static
buffers the caller fills in place before each call) and returns a tree
of output tensors.

On a CUDA device the first call of the constructor runs ``warmup()`` (or
``fn()``) once eagerly on a side stream and drops what it returns, so
that lazily created library state (cuBLAS handles, cuDNN plans) exists
before capture, then captures ``fn`` into a ``torch.cuda.CUDAGraph``.
With ``warm=False`` it captures at once: for a step another graph of
the same shapes was warmed up for, whose eager temporaries would
otherwise need device memory beside that graph's pool.
Each call replays the graph: every kernel ``fn`` launched, with the
addresses it launched them on, and nothing of the Python around them.
The outputs are the same tensors on every replay, overwritten in place.
A capture or a replay that fails raises; nothing falls back to eager.

Random draws: a ``torch.Generator`` that ``fn`` draws from is registered
with the graph (``generators``).  The replay reads the generator's seed
and offset from device memory that it fills from the generator's state
before each replay, so re-seeding the generator between replays changes
the draws; a generator not registered would have its capture-time state
frozen into the graph.  The warm-up leaves each generator's state as it
found it.

Launch counts: the kernel wrappers of ``repro_torch.kernels.ops`` count
on the host, where they are called, so during capture they count kernels
that only were recorded, and a replay runs them without calling the
wrappers.  The graph takes back what the capture counted and adds it
once per replay.

On the CPU nothing is captured: each call runs ``fn()`` as it is.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels import ops


class StepGraph:
    """``fn`` captured as a CUDA graph on ``device``, or called directly on
    the CPU.  ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with
    other captures (the graph's intermediates live in it)."""

    def __init__(self, fn: Callable, device, *,
                 warmup: Optional[Callable] = None, warm: bool = True,
                 generators: Sequence[torch.Generator] = (), pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.replays = 0
        #: Seconds of warm-up and capture (0 on the CPU).
        self.capture_s = 0.0
        #: Kernel launches of one replay, by wrapper (ops.launch_counts).
        self.recorded: dict = {}
        self.graph = None
        self.outputs = None
        if self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        if warm:
            states = [g.get_state() for g in generators]
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                (warmup or fn)()
            current.wait_stream(side)
            for gen, state in zip(generators, states):
                gen.set_state(state)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = ops.launch_counts()
        # torch.cuda.graph synchronizes and empties the cache first.  The
        # cyclic garbage collector stays off while capturing: an object it
        # collects may free device memory (another graph and its pool), a
        # call that invalidates the capture.
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph,
                                                                  pool=pool):
                self.outputs = fn()
        finally:
            if gc_was_on:
                gc.enable()
        self.recorded = ops.launch_counts_since(before)
        ops.add_launch_counts(self.recorded, -1)    # nothing ran yet
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def __call__(self):
        """Run the step: replay the graph (CUDA) or call ``fn`` (CPU)."""
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        ops.add_launch_counts(self.recorded, 1)
        self.replays += 1
        return self.outputs

    def close(self) -> None:
        """Free the graph; its pool's memory goes back at the next
        ``torch.cuda.empty_cache()``."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.outputs = None
