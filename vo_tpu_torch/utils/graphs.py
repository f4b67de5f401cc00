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
  the per-shape device constants, allocator growth, and on a mesh the NCCL
  communicator, which NCCL builds at a group's first collective and which
  must exist before a capture records one), then capture on that
  stream with ``capture_error_mode="thread_local"``. Every generator the step
  draws from is registered with the graph, so that each replay advances it
  as the eager step would; the capture itself must leave it where it was,
  which is checked. A capture that fails raises: nothing falls back to eager.
- ``StaticCall``: a program with static inputs and no carry, ``fn(*inputs) ->
  outputs`` (the refiner's window solve and verification round, the keyframe
  association and global descriptor); what it keeps between calls it keeps in
  tensors of its own, updated in place. ``ByShape`` holds one per shape of
  the inputs.
- ``Pool``: a graph memory pool and its capture stream, shared by the graphs
  of one run (the group step and the single-frame step). Graphs that share a
  pool must be replayed in the order they were captured, never interleaved:
  the runner replays the group step, then the single-frame step for the tail.
  A ``StaticCall`` made without a pool gets one of its own: the refiner's
  programs replay on its thread, the keyframe programs on the frame loop's,
  each in an order of its own, interleaved with the steps.
- Launch accounting: a hand-written kernel's wrapper that runs under capture
  counts the call in ``frontend.kernels.CAPTURED``, a collective of the mesh
  in ``dist.mesh.CAPTURED``; the graph keeps how many it captured of each and
  adds them to ``kernels.LAUNCHES`` and ``dist.mesh.COLLECTIVES`` on each
  replay, so a graphed run counts what the eager run counts.
- ``PROGRAMS``: captures, replays and capture seconds of every graph, by
  program name: each ``StaticCall``'s and each ``StaticStep``'s (the runner's
  ``group_step`` and ``frame_step``, named by odometry.pipeline's factories);
  ``reset_programs`` sets them to 0.

``wanted`` decides, per program: ``graph=None`` captures on a CUDA device and
runs eagerly on the CPU, ``graph=False`` is the eager program, ``graph=True``
on the CPU raises. A program of a mesh is captured when every collective it
issues goes over NCCL, which enqueues on the stream like any kernel (the
reference compiles its meshed programs too); one that issues a collective
over gloo stays eager by rule, because gloo stages a CUDA tensor through host
memory and the host waits there (dist.mesh), and ``graph=True`` for it
raises. Each rank captures and replays its own graphs: every rank must replay
every graph that holds a collective, or its peers wait for good.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

from ..dist import mesh as mesh_mod
from ..frontend import kernels
from .debug import nan_checks_enabled

WARMUP_RUNS = 1  # eager runs on the side stream before capture

# program name -> {"captures": n, "replays": n, "capture_s": seconds} of its StaticCalls and StaticSteps
PROGRAMS: defaultdict = defaultdict(lambda: {"captures": 0, "replays": 0, "capture_s": 0.0})


def reset_programs() -> None:
    PROGRAMS.clear()


def wanted(graph, device, backends=None) -> bool:
    """Whether a program on ``device`` runs as a captured graph (module docstring). ``backends``
    names the backend of every process group the program issues collectives over
    (dist.mesh.collective_backends; None: it issues none)."""
    staged = sorted({b for b in backends or () if b != "nccl"})
    if staged:
        if graph:
            raise ValueError(
                f"graph=True with a mesh whose collectives go over {', '.join(staged)}: only collectives over NCCL "
                "are captured into a CUDA graph (a gloo collective stages through host memory and waits there); "
                "give each rank a card of its own (NCCL), or pass graph=None or graph=False"
            )
        return False
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

    def bytes(self) -> int:
        """Device memory the pool's segments hold now (``torch.cuda.memory_snapshot``)."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.handle))


def pools_bytes() -> int:
    """Device memory that the segments of every graph pool hold now (``torch.cuda.memory_snapshot``)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


class Captured:
    """A recorded step: ``replay()`` launches it and returns its static outputs."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs, launches: dict, collectives: dict | None = None):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches  # hand-written kernel launches inside the graph, by wrapper name
        self.collectives = collectives or {}  # mesh collectives inside the graph, by kind

    def replay(self):
        self.graph.replay()
        for k, v in self.launches.items():
            kernels.LAUNCHES[k] += v
        for k, v in self.collectives.items():
            mesh_mod.COLLECTIVES[k] += v
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
    launches, collectives = dict(kernels.CAPTURED), dict(mesh_mod.CAPTURED)
    with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream, capture_error_mode="thread_local"):
        outputs = body()
    for gen, state in zip(generators, before):
        if not torch.equal(gen.get_state(), state):
            raise RuntimeError("the capture moved a registered generator's stream: a replay would draw other samples")
    launches = {k: kernels.CAPTURED[k] - v for k, v in launches.items()}
    collectives = {k: mesh_mod.CAPTURED[k] - v for k, v in collectives.items()}
    return Captured(graph, outputs, launches, collectives)


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
    so a caller keeps copies of what it needs longer. Counted in ``PROGRAMS``
    under ``name``, as a ``StaticCall``.
    """

    def __init__(self, fn, carry, inputs, device, name: str, pool: Pool | None = None):
        self.name = name
        self.carry = static_copy(carry)
        self.inputs = [x.clone() for x in inputs]

        def body():
            new_carry, outputs = fn(self.carry, *self.inputs)
            copy_into(self.carry, new_carry)
            return outputs

        t = time.perf_counter()
        self.captured = capture(body, device, pool, generators_of(self.carry))
        self.capture_s = time.perf_counter() - t  # warm-up run, capture and instantiation
        PROGRAMS[name]["captures"] += 1
        PROGRAMS[name]["capture_s"] += self.capture_s

    def __call__(self, carry, inputs):
        refuse_nan_debug()
        copy_into(self.carry, carry)
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        PROGRAMS[self.name]["replays"] += 1
        return self.carry, self.captured.replay()


def leaves(tree) -> list:
    """The tensors of a tree of tuples (NamedTuples too), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [t for x in tree for t in leaves(x)]


class StaticCall:
    """``fn(*inputs) -> outputs`` recorded over static input buffers (module docstring).

    ``inputs`` (a tree of tensors) are copied into buffers of the call's own at
    construction, and the program is captured there, registered with
    ``generators`` (each left where it was before the capture's eager warm-up
    run drew from it). A call copies its inputs in, replays, and returns the
    static outputs: the next call overwrites them, so a caller copies out what
    it keeps (a ``HostCopy`` started right after the call, on the same stream,
    reads them before any later replay can run).
    """

    def __init__(self, fn, inputs, device, name: str, pool: Pool | None = None, generators=()):
        self.name = name
        self.inputs = static_copy(tuple(inputs))
        self.pool = pool if pool is not None else Pool(device)
        states = [gen.get_state() for gen in generators]
        t = time.perf_counter()
        self.captured = capture(lambda: fn(*self.inputs), device, self.pool, generators)
        for gen, state in zip(generators, states):
            gen.set_state(state)
        self.capture_s = time.perf_counter() - t  # warm-up run, capture and instantiation
        PROGRAMS[name]["captures"] += 1
        PROGRAMS[name]["capture_s"] += self.capture_s

    def __call__(self, *inputs):
        refuse_nan_debug()
        copy_into(self.inputs, inputs)
        PROGRAMS[self.name]["replays"] += 1
        return self.captured.replay()


class ByShape:
    """One ``StaticCall`` of ``fn`` per shape of its inputs, captured at the first call of that shape
    (or ahead of it by ``capture``), each with a pool of its own."""

    def __init__(self, fn, device, name: str, generators=()):
        self.fn, self.device, self.name, self.generators = fn, torch.device(device), name, tuple(generators)
        self.calls: dict = {}

    @staticmethod
    def _key(inputs) -> tuple:
        return tuple((tuple(t.shape), t.dtype) for t in leaves(inputs))

    def capture(self, *inputs) -> StaticCall:
        key = self._key(inputs)
        if key not in self.calls:
            self.calls[key] = StaticCall(self.fn, inputs, self.device, self.name, generators=self.generators)
        return self.calls[key]

    def __call__(self, *inputs):
        return self.capture(*inputs)(*inputs)
