"""Distributed pose-graph optimization: edges sharded over the mesh (port of vo_tpu.dist.pose_graph_sharded).

Keyframe poses are small (K x 4 x 4, replicated); the O(E) work (edge
residuals, 6x6 Jacobian blocks, assembly of the 6K x 6K system) is sharded
over the "model" axis. Per Gauss-Newton iteration the partial H, b and node
degrees are all-reduced in ONE collective and the candidate's cost in a
second; the dense solve of the reduced system is replicated (cheap, and it
keeps the poses bit-identical across ranks).
"""
from __future__ import annotations

from ..ba import pose_graph as pg
from ..utils.precision import matmul_precision
from .mesh import axis_size, shard_rows


@matmul_precision("float32")
def optimize_sharded(
    g: pg.PoseGraph,
    mesh,
    iters: int = 10,
    damping: float = 1e-6,
    axis: str = "model",
) -> pg.PoseGraphResult:
    """Same contract as ba.pose_graph.optimize; the edge count E must divide by the axis size."""
    E = g.edge_i.shape[0]
    n = axis_size(mesh, axis)
    if E % n != 0:
        raise ValueError(f"edge count {E} not divisible by {n} shards")
    rows = shard_rows(E, mesh, axis)
    shard = pg.PoseGraph(
        T_c2w=g.T_c2w,
        edge_i=g.edge_i[rows],
        edge_j=g.edge_j[rows],
        edge_T=g.edge_T[rows],
        edge_mask=g.edge_mask[rows],
        edge_weight=g.edge_weight[rows],
    )
    return pg.optimize(shard, iters=iters, damping=damping, group=mesh.get_group(axis))
