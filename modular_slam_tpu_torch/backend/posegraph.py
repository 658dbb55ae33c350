"""Pose-graph optimization: Gauss-Newton on SE(3) relative-pose edges
(counterpart of modular_slam_tpu/backend/posegraph.py).

Nodes are keyframe poses T_i (camera-to-world); an edge (i, j) carries a
measured relative transform Z_ij; the residual is
r_e = log(Z_ij^-1 T_i^-1 T_j) in se(3), minimized by GN with per-node
right-multiplicative retractions T <- T exp(xi).  The edge Jacobians are
forward-mode derivatives of the residual at xi = 0
(`torch.func.vmap(torch.func.jacfwd(...))`, as `jax.vmap(jax.jacfwd(...))`
in JAX); the normal equations are applied matrix-free, each H x two edge
gathers, per-edge 6x6 products and two segment sums back to the nodes,
and solved by block-Jacobi PCG.  Node 0 is the gauge.

The schedule is fixed (`iters` GN steps of `cg_iters` CG steps, each step
kept only if it lowers the cost), so nothing is read back to the host.
Segment sums are `index_add_`: on CUDA their float atomics add in another
order on every run, so results there are reproducible to float32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from modular_slam_tpu_torch.backend.cg import pcg
from modular_slam_tpu_torch.geometry.se3 import (Pose, pose_apply,
                                                 pose_compose, pose_inverse,
                                                 pose_retract, quat_normalize,
                                                 se3_log)

Tensor = torch.Tensor


class PoseGraphEdges(NamedTuple):
    i: Tensor        # [E] int32 source node
    j: Tensor        # [E] int32 target node
    rel_q: Tensor    # [E, 4] measured T_i^-1 T_j rotation (wxyz)
    rel_t: Tensor    # [E, 3]
    weight: Tensor   # [E] float32 (0 = inactive)
    is_loop: Tensor  # [E] bool — loop-closure measurement (kept as stored);
    #                odometry edges are re-measured from the current poses
    #                (refresh_odometry_edges)


def empty_edges(capacity: int, device="cpu") -> PoseGraphEdges:
    rel_q = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
    rel_q[:, 0] = 1.0
    return PoseGraphEdges(
        i=torch.zeros((capacity,), dtype=torch.int32, device=device),
        j=torch.zeros((capacity,), dtype=torch.int32, device=device),
        rel_q=rel_q,
        rel_t=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        weight=torch.zeros((capacity,), dtype=torch.float32, device=device),
        is_loop=torch.zeros((capacity,), dtype=torch.bool, device=device))


def add_edge(edges: PoseGraphEdges, slot: int, i: int, j: int, rel: Pose,
             weight: float = 1.0, is_loop: bool = False) -> PoseGraphEdges:
    """Write edge `slot` in place; a slot past the capacity is dropped.
    `i` and `j` are host ints or 0-d tensors."""
    if 0 <= slot < edges.weight.shape[0]:
        edges.i[slot] = i
        edges.j[slot] = j
        edges.rel_q[slot] = rel.q
        edges.rel_t[slot] = rel.t
        edges.weight[slot] = weight
        edges.is_loop[slot] = is_loop
    return edges


def refresh_odometry_edges(edges: PoseGraphEdges, kf_q: Tensor,
                           kf_t: Tensor) -> PoseGraphEdges:
    """Re-measure non-loop edges from the current keyframe poses: BA keeps
    refining poses after an odometry edge was recorded, and optimizing
    against a stale measurement would undo that refinement.  Loop edges
    keep their stored measurements."""
    i, j = edges.i.long(), edges.j.long()
    cur = pose_compose(pose_inverse(Pose(q=kf_q[i], t=kf_t[i])),
                       Pose(q=kf_q[j], t=kf_t[j]))
    keep = edges.is_loop[:, None]
    return edges._replace(rel_q=torch.where(keep, edges.rel_q, cur.q),
                          rel_t=torch.where(keep, edges.rel_t, cur.t))


def _edge_residual(qi, ti, qj, tj, rq, rt, xi_i, xi_j):
    """Residual of one edge with local deltas applied."""
    Ti = pose_retract(Pose(q=qi, t=ti), xi_i)
    Tj = pose_retract(Pose(q=qj, t=tj), xi_j)
    Z = Pose(q=rq, t=rt)
    err = pose_compose(pose_inverse(Z), pose_compose(pose_inverse(Ti), Tj))
    return se3_log(err)


def _segment_sum(x: Tensor, idx: Tensor, n: int) -> Tensor:
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


_IN_DIMS = (0, 0, 0, 0, 0, 0, None, None)
# r and both Jacobians in one forward-mode pass: jacfwd over (xi_i, xi_j)
# with the residual itself as the auxiliary output
_r_and_jacobians = vmap(jacfwd(lambda *a: (_edge_residual(*a),) * 2,
                               argnums=(6, 7), has_aux=True),
                        in_dims=_IN_DIMS)
_residuals = vmap(_edge_residual, in_dims=_IN_DIMS)


def optimize_pose_graph(
    kf_q: Tensor, kf_t: Tensor, kf_valid: Tensor,
    edges: PoseGraphEdges,
    iters: int = 20,
    damping: float = 1e-6,
    cg_iters: int = 32,
) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (kf_q, kf_t, final_cost).  Node 0 is the gauge anchor."""
    K = kf_q.shape[0]
    dev = kf_q.device
    free = kf_valid & (torch.arange(K, device=dev) != 0)
    dt = kf_q.dtype
    free_f = free[:, None].to(dt)
    ei, ej = edges.i.long(), edges.j.long()
    w = edges.weight
    zero6 = torch.zeros(6, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def cost_of(q, t):
        r = _residuals(q[ei], t[ei], q[ej], t[ej], edges.rel_q, edges.rel_t,
                       zero6, zero6)
        return torch.sum(w * torch.sum(r * r, dim=-1))

    def gn_step(q, t):
        (Ji, Jj), r = _r_and_jacobians(q[ei], t[ei], q[ej], t[ej],
                                       edges.rel_q, edges.rel_t, zero6,
                                       zero6)
        # fixed nodes: zero Jacobians
        Ji = Ji * free_f[ei][:, :, None]
        Jj = Jj * free_f[ej][:, :, None]
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]

        b = (_segment_sum(-torch.einsum("eki,ek->ei", wJi, r), ei, K)
             + _segment_sum(-torch.einsum("eki,ek->ei", wJj, r), ej, K))

        def matvec(x_flat):
            x = x_flat.reshape(K, 6)
            a = (torch.einsum("eki,ei->ek", Ji, x[ei])
                 + torch.einsum("eki,ei->ek", Jj, x[ej]))     # [E, 6]
            y = (_segment_sum(torch.einsum("eki,ek->ei", wJi, a), ei, K)
                 + _segment_sum(torch.einsum("eki,ek->ei", wJj, a), ej, K))
            # damping on free nodes; identity on fixed ones (H s.p.d.)
            return torch.where(free[:, None], y + damping * x, x).reshape(-1)

        # block-Jacobi preconditioner from the node-diagonal 6x6 blocks
        D = (_segment_sum(torch.einsum("eki,ekj->eij", wJi, Ji), ei, K)
             + _segment_sum(torch.einsum("eki,ekj->eij", wJj, Jj), ej, K))
        Dinv = torch.linalg.inv_ex(D + (damping + 1e-8) * eye6)[0]

        def precond(x_flat):
            x = x_flat.reshape(K, 6)
            y = torch.einsum("kij,kj->ki", Dinv, x)
            return torch.where(free[:, None], y, x).reshape(-1)

        dx_flat, _ = pcg(matvec, (b * free_f).reshape(-1), precond, cg_iters)
        new = pose_retract(Pose(q=q, t=t), dx_flat.reshape(K, 6) * free_f)
        q_new = quat_normalize(new.q)
        cost_new = cost_of(q_new, new.t)
        cost_old = torch.sum(w * torch.sum(r * r, dim=-1))
        accept = cost_new < cost_old
        return (torch.where(accept, q_new, q), torch.where(accept, new.t, t),
                torch.where(accept, cost_new, cost_old))

    q, t, cost = kf_q, kf_t, cost_of(kf_q, kf_t)
    for _ in range(iters):
        q, t, cost = gn_step(q, t)
    return q, t, cost


def correct_landmarks(
    lm_pos: Tensor, lm_valid: Tensor,
    anchor_kf: Tensor,               # [L] anchor keyframe per landmark
    old_q: Tensor, old_t: Tensor,    # poses before PGO
    new_q: Tensor, new_t: Tensor,    # poses after PGO
) -> Tensor:
    """Move landmarks rigidly with their anchor keyframes:
    l' = T_new T_old^-1 l."""
    a = anchor_kf.long()
    delta = pose_compose(Pose(q=new_q[a], t=new_t[a]),
                         pose_inverse(Pose(q=old_q[a], t=old_t[a])))
    return torch.where(lm_valid[:, None], pose_apply(delta, lm_pos), lm_pos)
