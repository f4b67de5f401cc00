"""Device-mesh construction, collectives and the rank launcher (port of vo_tpu.dist.mesh).

The reference is ONE process that drives N devices through ``jax.shard_map``;
PyTorch's idiom is one process per rank, so the port's mesh is SPMD across
processes: every rank runs the same program on replicated state, slices its
own rows of whatever is sharded, and the pieces meet in ``torch.distributed``
collectives over the process groups of a named ``DeviceMesh``.

Axes (MeshConfig.axis_names):
  "data"  frame-parallel front-end batches (no collective inside detection).
  "model" hypothesis shards (RANSAC), landmark blocks (window BA), edges
          (pose graph).

Backends: NCCL where every rank has a card of its own, gloo on the CPU and
where ranks share one card. ``backend=None`` means NCCL for a CUDA device and
gloo for the CPU, and nothing switches quietly: ranks that share a card must
ask for ``backend="gloo"``, and NCCL's own error about a duplicate GPU is
what a caller gets who does not.

``replicated`` / ``sharded`` of the reference (``NamedSharding`` specs) have
no counterpart: a tensor is replicated because every rank computed it, and a
rank slices its own rows (``shard_rows``).

The collectives (``all_gather``, ``all_reduce_sum_``, and their packed forms,
which put several tensors through ONE collective) count themselves in
``COLLECTIVES``. With NCCL they are enqueued on the current CUDA stream and
the host does not wait. With gloo on CUDA tensors they are staged
explicitly: device -> pinned host buffer (utils.host_copy.HostCopy), the
collective on the host, pinned upload back; that path WAITS for the current
stream each time, the price of ranks that share a card.
"""
from __future__ import annotations

import atexit
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import MeshConfig
from ..utils.device import resolve
from ..utils.host_copy import HostCopy, upload

# Collectives issued by this process since the last reset, by kind.
COLLECTIVES = {"all_gather": 0, "all_reduce": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
) -> None:
    """Join a world of ``num_processes`` ranks; a no-op for a single process.

    ``coordinator`` is a ``torch.distributed`` init method (``tcp://host:port``,
    ``file:///path``, ``env://``) or a bare ``host:port``. ``backend=None`` is
    NCCL for a CUDA ``device`` (None: the current card) and gloo for the CPU.
    """
    if num_processes is None or num_processes <= 1:
        return
    device = resolve(device)
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    kw = {}
    if coordinator != "env://":
        kw = dict(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend or _default_backend(device), init_method=coordinator, **kw)


def make_mesh(cfg: MeshConfig | None = None, device=None, backend: str | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the world, named by ``MeshConfig.axis_names``.

    Default: all ranks on the "model" axis. Where ``cfg.data * cfg.model`` is
    not the world size, the remainder goes to "model". A process that joined
    no world becomes a world of one (over a file store in a temp dir), so a
    plain process gets a ``(1, 1)`` mesh. ``device`` None is the current card.
    """
    device = resolve(device)
    if not dist.is_initialized():
        store_dir = tempfile.mkdtemp(prefix="vo_mesh_")
        dist.init_process_group(
            backend or _default_backend(device), init_method=f"file://{store_dir}/store", world_size=1, rank=0
        )
        atexit.register(_leave_world, store_dir)
    n = dist.get_world_size()
    if cfg is None:
        shape, names = (1, n), ("data", "model")
    else:
        shape, names = (cfg.data, cfg.model), tuple(cfg.axis_names)
        if cfg.data * cfg.model != n:
            shape = (cfg.data, n // cfg.data)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return DeviceMesh(device.type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def _leave_world(store_dir: str) -> None:
    """Leave the world of one that make_mesh made. The group goes before its store: NCCL's
    background threads read the store, and a process that exits with the store's file gone
    and the group still up can wait on it for good."""
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """Ranks along ``axis``; 1 for no mesh or a mesh without that axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: size}, the reference's ``dict(mesh.shape)``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def shard_rows(n_rows: int, mesh: DeviceMesh, axis: str) -> slice:
    """This rank's contiguous share of ``n_rows`` rows sharded over ``axis`` (n_rows must divide)."""
    per = n_rows // axis_size(mesh, axis)
    r = mesh.get_local_rank(axis)
    return slice(r * per, (r + 1) * per)


def new_axis_group(mesh: DeviceMesh, axis: str):
    """A NEW process group over the same ranks as this rank's ``axis`` group.

    Two threads must never share a communicator, so a worker thread that
    reduces over an axis gets a group of its own. ``new_group`` is collective
    over the world: every rank calls this at the same point, and the groups of
    all the axis's rows are created in one order everywhere.
    """
    dim = mesh.mesh_dim_names.index(axis)
    rows = mesh.mesh.movedim(dim, -1).reshape(-1, mesh.size(dim))
    mine = None
    for row in rows.tolist():
        g = dist.new_group(ranks=row)
        if dist.get_rank() in row:
            mine = g
    return mine


# -- collectives ----------------------------------------------------------------


def _staged(group, t: torch.Tensor) -> bool:
    """gloo moves host memory: a CUDA tensor goes through a pinned buffer (module docstring)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[S, ...]: ``t`` of every rank of ``group``, in rank order."""
    COLLECTIVES["all_gather"] += 1
    with torch.profiler.record_function("vo_tpu_torch.dist.all_gather"):
        return _all_gather(t, group)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    S = dist.get_world_size(group)
    if _staged(group, t):
        host = torch.from_numpy(HostCopy(t.contiguous()).numpy()[0])
        parts = [torch.empty_like(host) for _ in range(S)]
        dist.all_gather(parts, host, group=group)
        return upload(torch.stack(parts), t.device)
    t = t.contiguous()
    if t.device.type == "cuda":
        out = torch.empty((S,) + t.shape, dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    parts = [torch.empty_like(t) for _ in range(S)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place; every rank ends with the same bits."""
    COLLECTIVES["all_reduce"] += 1
    with torch.profiler.record_function("vo_tpu_torch.dist.all_reduce"):
        return _all_reduce_sum_(t, group)


def _all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    if _staged(group, t):
        host = torch.from_numpy(HostCopy(t.contiguous()).numpy()[0])
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        t.copy_(upload(host, t.device))
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _pack(tensors) -> torch.Tensor:
    """One flat buffer of all ``tensors``: float64 if any is, else float32. Integer and bool
    values ride as floats, exact below 2**24."""
    dt = torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32
    return torch.cat([t.reshape(-1).to(dt) for t in tensors])


def _unpack(flat: torch.Tensor, like, lead: tuple = ()) -> list:
    """Split ``flat`` [*lead, total] back into the shapes and dtypes of ``like``."""
    out, o = [], 0
    for t in like:
        n = t.numel()
        piece = flat[..., o : o + n].reshape(lead + tuple(t.shape))
        if t.dtype == torch.bool:
            piece = piece > 0.5
        elif not t.dtype.is_floating_point:
            piece = piece.round()
        out.append(piece.to(t.dtype))
        o += n
    return out


def all_reduce_sum_packed(tensors, group) -> list:
    """The sums over ``group`` of every tensor in ``tensors``, through ONE collective."""
    flat = all_reduce_sum_(_pack(tensors), group)
    return _unpack(flat, tensors)


def all_gather_packed(tensors, group) -> list:
    """[S, ...] stacks of every tensor in ``tensors`` over ``group``, through ONE collective."""
    flat = all_gather(_pack(tensors), group)
    return _unpack(flat, tensors, lead=(flat.shape[0],))


# -- launcher ---------------------------------------------------------------------


def _rank_entry(rank, shape, device, backend, rdv, threads, fn, args):
    """Body of one launched rank: join the world, build the mesh, run ``fn``, leave the result."""
    err = open(os.path.join(rdv, f"rank{rank}.err"), "w", buffering=1)
    os.dup2(err.fileno(), 2)
    sys.stderr = err
    try:
        if threads:
            torch.set_num_threads(threads)
        device = torch.device(device)
        world = shape[0] * shape[1]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend or _default_backend(device),
            init_method=f"file://{rdv}/store",
            world_size=world,
            rank=rank,
        )
        mesh = make_mesh(MeshConfig(data=shape[0], model=shape[1]), device=device, backend=backend)
        result = fn(mesh, device, *args)
        with open(os.path.join(rdv, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
        sys.stdout.flush()
        err.flush()
        # The result is on disk and the world is left: go without the interpreter's teardown,
        # which has hung after profiling a process with a second thread and stream.
        os._exit(0)
    except BaseException:
        traceback.print_exc(file=err)
        err.flush()
        os._exit(1)


def _stderr_of(rdv: str, rank: int) -> str:
    try:
        with open(os.path.join(rdv, f"rank{rank}.err")) as f:
            return f.read()[-8000:]
    except OSError:
        return ""


def launch(fn, shape, device, backend: str | None = None, args: tuple = (), timeout: float = 60.0, threads: int | None = 1) -> list:
    """Run ``fn(mesh, device, *args)`` on ``shape[0] * shape[1]`` ranks and return their results in rank order.

    Each rank is a fresh process (``spawn``, so CUDA is safe), the rendezvous is
    a file in a temp dir (no port to collide on), ``fn`` and ``args`` must
    pickle (``fn`` a module-level function) and so must its result. ``device``
    is what every rank runs on: "cpu", or a CUDA device that the ranks then
    share, which needs ``backend="gloo"``; a list names one device per rank
    (a card each: NCCL). ``threads`` is each rank's intra-op
    thread count (None: PyTorch's default).

    Nothing is survived: the first rank to exit non-zero ends the others and
    raises ``RuntimeError`` with its stderr; ranks still running after
    ``timeout`` seconds are killed and named in a ``TimeoutError``.
    """
    shape = (int(shape[0]), int(shape[1]))
    world = shape[0] * shape[1]
    devices = [str(resolve(d)) for d in device] if isinstance(device, (list, tuple)) else [str(resolve(device))] * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    rdv = tempfile.mkdtemp(prefix="vo_mesh_")
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_entry, args=(r, shape, devices[r], backend, rdv, threads, fn, args), daemon=True)
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                raise RuntimeError(f"mesh rank {r} of {world} exited with code {codes[r]}; its stderr:\n{_stderr_of(rdv, r)}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                hung = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(
                    f"mesh ranks {hung} of {world} still running after {timeout:.0f} s; "
                    f"stderr of rank {hung[0]}:\n{_stderr_of(rdv, hung[0])}"
                )
            time.sleep(0.02)
        results = []
        for r in range(world):
            with open(os.path.join(rdv, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=5.0)
        shutil.rmtree(rdv, ignore_errors=True)
