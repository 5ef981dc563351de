"""One CUDA graph of a tile step's body, captured once and replayed.

The JAX package compiles its tile step once with ``jax.jit`` and
dispatches that one executable every step
(``opengl_raytracer_tpu/renderer.py:467-470``,
``parallel/sharding.py:196-200``).  The port's counterpart is a
``torch.cuda.CUDAGraph`` of the step's body: the host then enqueues one
block write (``ops/step_block.py``) and one replay a step, where it
enqueued some hundred launches.  The body reads every value that changes
from step to step from its step block, so one graph serves every step.

:func:`capture` runs the body once on a side stream (PyTorch's graph notes
ask for a warm-up there; it also builds the kernel library and creates
the traversals' overflow counters outside the graph's memory pool), then
captures it.  There is no fallback: a body that cannot be captured (a host
sync, say) raises here.  Launch counts: ``_kernels.launch`` counts in
Python, where a replay does not pass, so the counts the capture added are
taken back and kept with the graph, which adds them on each replay; the
warm-up's launches set the graph up and are not counted either.  Each
capture adds one to the counter ``step.captures`` (``utils/profiling.py``).
"""

from __future__ import annotations

import torch

from opengl_raytracer_torch.ops import _kernels
from opengl_raytracer_torch.utils import profiling


class StepGraph:
    """A captured body: ``replay()`` runs it on the device's current
    stream and returns what the body returned at capture (tensors in the
    graph's pool, overwritten by the next replay)."""

    def __init__(self, graph, device: torch.device, output, counts: dict):
        self.graph = graph
        self.device = device
        self.output = output
        self.counts = counts  # launches a replay makes, by counter

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()
        for name, n in self.counts.items():
            _kernels.launch_counts[name] += n
        return self.output


def capture(body, device, warmup=None, pool=None) -> StepGraph:
    """Warm ``body`` up (or run ``warmup``, which must run it) on a side
    stream of ``device``, then capture one call of ``body`` as a CUDA
    graph, in ``pool`` (a ``torch.cuda.graph_pool_handle()`` shared by
    graphs replayed one after another on the device) or a pool of its
    own."""
    device = torch.device(device)
    counts = dict(_kernels.launch_counts)
    try:
        with torch.cuda.device(device):
            _kernels.lib()
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                (warmup or body)()
            current.wait_stream(side)
            before = dict(_kernels.launch_counts)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool,
                                  stream=torch.cuda.Stream(device)):
                output = body()
        added = {k: n - before[k] for k, n in _kernels.launch_counts.items()
                 if n != before[k]}
    finally:
        _kernels.launch_counts.update(counts)
    profiling.count("step.captures")
    return StepGraph(graph, device, output, added)
