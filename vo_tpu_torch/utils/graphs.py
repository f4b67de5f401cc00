"""CUDA graphs for the VO step: what takes the place of ``jax.jit`` in the reference's factories.

The reference compiles its per-frame (and per-group) step into one device
program. The port's step is eager PyTorch, about 3,000 launches a frame, each
enqueued by the host; on a CUDA card the factories of odometry.pipeline record
the step once into a ``torch.cuda.CUDAGraph`` and replay it, one host call per
step. This module owns the mechanics:

- ``StaticStep``: the step's static buffers (the carried state, the map and
  the frames, copied in on each call unless they already are the static ones;
  the outputs, overwritten by every replay), the recorded graph and ``replay``.
- ``capture``: warm-up on a side stream (first-use costs: library handles,
  the per-shape device constants, allocator growth), then capture on that
  stream with ``capture_error_mode="thread_local"``. Every generator the step
  draws from is registered with the graph, so that each replay advances it
  as the eager step would; the capture itself must leave it where it was,
  which is checked. A capture that fails raises: nothing falls back to eager.
- ``Pool``: a graph memory pool and its capture stream, shared by the graphs
  of one run (the group step and the single-frame step). Graphs that share a
  pool must be replayed in the order they were captured, never interleaved:
  the runner replays the group step, then the single-frame step for the tail.
- Launch accounting: a hand-written kernel's wrapper that runs under capture
  counts the call in ``frontend.kernels.CAPTURED``; the graph keeps how many
  it captured of each and adds them to ``kernels.LAUNCHES`` on each replay.

``wanted`` decides: ``graph=None`` captures on a CUDA device and runs eagerly
on the CPU, ``graph=False`` is the eager step, ``graph=True`` on the CPU raises.
"""
from __future__ import annotations

import torch

from ..frontend import kernels
from .debug import nan_checks_enabled

WARMUP_RUNS = 1  # eager runs on the side stream before capture


def wanted(graph, device) -> bool:
    """Whether a step on ``device`` runs as a captured graph (module docstring)."""
    cuda = torch.device(device).type == "cuda"
    if graph is None:
        return cuda
    if graph and not cuda:
        raise ValueError(f"graph=True needs a CUDA device, not {torch.device(device)}: a CUDA graph cannot run on the CPU")
    return bool(graph)


class Pool:
    """A graph memory pool and the stream its graphs are captured on (module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)


class Captured:
    """A recorded step: ``replay()`` launches it and returns its static outputs."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs, launches: dict):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches  # hand-written kernel launches inside the graph, by wrapper name

    def replay(self):
        self.graph.replay()
        for k, v in self.launches.items():
            kernels.LAUNCHES[k] += v
        return self.outputs


def refuse_nan_debug() -> None:
    """Raise under ``utils.debug.nan_debug``: its checks read the device inside the step."""
    if nan_checks_enabled():
        raise ValueError(
            "utils.debug.nan_debug reads the device inside the step, which a CUDA graph cannot replay: "
            "build the step with graph=False (run_sequence(..., graph=False)) to trap non-finite values"
        )


def capture(body, device, pool: Pool | None = None, generators=()) -> Captured:
    """Warm ``body`` up on the pool's stream, then record it into a CUDA graph (module docstring)."""
    refuse_nan_debug()
    pool = pool if pool is not None else Pool(device)
    main = torch.cuda.current_stream(pool.device)
    pool.stream.wait_stream(main)
    with torch.cuda.stream(pool.stream):
        for _ in range(WARMUP_RUNS):
            body()
    main.wait_stream(pool.stream)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = [gen.get_state() for gen in generators]
    captured = dict(kernels.CAPTURED)
    with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream, capture_error_mode="thread_local"):
        outputs = body()
    for gen, state in zip(generators, before):
        if not torch.equal(gen.get_state(), state):
            raise RuntimeError("the capture moved a registered generator's stream: a replay would draw other samples")
    launches = {k: kernels.CAPTURED[k] - captured[k] for k in captured}
    return Captured(graph, outputs, launches)


def static_copy(tree):
    """A tree (NamedTuples, tuples, None) of tensors and generators with every leaf copied into a
    buffer of its own: tensors by value, generators as new generators in the same state."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, torch.Generator):
        gen = torch.Generator(device=tree.device)
        gen.set_state(tree.get_state())
        return gen
    if tree is None:
        return None
    items = [static_copy(x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def copy_into(dst, src) -> None:
    """Write ``src``'s leaves into the buffers of ``dst`` (a tree of the same shape), skipping
    leaves that already are ``dst``'s: tensors with ``copy_``, generators with ``set_state``."""
    if dst is src or dst is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, torch.Generator):
        dst.set_state(src.get_state())
    else:
        if len(dst) != len(src):
            raise ValueError(f"static buffers of {type(dst).__name__} and the call's {type(src).__name__} differ in shape")
        for d, s in zip(dst, src):
            copy_into(d, s)


def generators_of(tree) -> list:
    if isinstance(tree, torch.Generator):
        return [tree]
    if isinstance(tree, torch.Tensor) or tree is None:
        return []
    return [g for x in tree for g in generators_of(x)]


class StaticStep:
    """``fn(carry, *inputs) -> (carry, outputs)`` recorded over static buffers.

    ``carry`` (the VO state, with its generator, and the landmark map) and
    ``inputs`` (the frames) are copied into buffers of the step's own at
    construction; the body writes the new carry back into the static carry,
    so the run's state lives there. A call copies its carry and inputs in
    (nothing for a carry that already is the static one), replays, and
    returns ``(static carry, static outputs)``: the next call overwrites both,
    so a caller keeps copies of what it needs longer.
    """

    def __init__(self, fn, carry, inputs, device, pool: Pool | None = None):
        self.carry = static_copy(carry)
        self.inputs = [x.clone() for x in inputs]

        def body():
            new_carry, outputs = fn(self.carry, *self.inputs)
            copy_into(self.carry, new_carry)
            return outputs

        self.captured = capture(body, device, pool, generators_of(self.carry))

    def __call__(self, carry, inputs):
        refuse_nan_debug()
        copy_into(self.carry, carry)
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        return self.carry, self.captured.replay()
