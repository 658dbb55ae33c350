"""Preconditioned conjugate gradient, matrix-free, fixed iteration count
(counterpart of modular_slam_tpu/backend/cg.py).

Solves the Schur-complement reduced camera system S x = b without
materializing S: the caller provides `matvec` and a block-Jacobi
preconditioner.  A fixed `iters` reads nothing back from the device;
convergence is reported through the returned residual norm.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor


def pcg(
    matvec: Callable[[Tensor], Tensor],
    b: Tensor,
    precond: Callable[[Tensor], Tensor],
    iters: int,
    x0: Optional[Tensor] = None,
    dot: Callable[[Tensor, Tensor], Tensor] = torch.dot,
) -> Tuple[Tensor, Tensor]:
    """Solve A x = b.  Returns (x, final residual norm).

    `dot` is the inner product: when x and b are device-local blocks of a
    sharded vector, pass an all-reduced dot so that the CG scalars agree
    across shards."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = torch.where(torch.abs(pAp) > 1e-20, rz / pAp, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return x, torch.sqrt(dot(r, r))
