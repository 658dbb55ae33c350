"""Masked index extraction (counterpart of modular_slam_tpu/utils/indices.py).

The JAX version runs `lax.top_k` over strictly decreasing float keys.  Here
a running count gives each true entry its rank, and a scatter into a buffer
with one spare slot puts it there: exact, and with no host sync
(`torch.nonzero` would wait for the device to learn the output size)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def masked_indices(mask: Tensor, cap: int) -> Tensor:
    """First `cap` indices where mask is True, ascending; N for absent
    slots — `jnp.nonzero(mask, size=cap, fill_value=N)[0]` — as int64."""
    N = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask & (rank < cap), rank, cap)
    out = torch.full((cap + 1,), N, dtype=torch.int64, device=mask.device)
    # every dropped entry lands in the spare slot cap, which is cut off
    out.scatter_(0, dest, torch.arange(N, device=mask.device))
    return out[:cap]
