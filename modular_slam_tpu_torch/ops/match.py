"""Brute-force Hamming 2-NN descriptor matching with Lowe ratio test
(counterpart of modular_slam_tpu/ops/match.py and, for the kernel,
ops/match_pallas.py).

`match_descriptors` is the entry point.  On CUDA tensors it launches the
hand-written kernel `csrc/hamming_2nn.cu` (kernel K2, which replaces the
Pallas kernel `match_pallas.py::_tile_kernel`) and merges its per-chunk
(best, argmin, second) triples with the plain epilogue of
`match_descriptors_pallas`.  On CPU tensors it runs
`match_descriptors_plain`, the full-matrix formulation of the JAX
package, which is also the kernel's oracle.  There is no fallback
between the two.
"""

from __future__ import annotations

from typing import Tuple

import torch

from modular_slam_tpu_torch.config import MatcherConfig
from modular_slam_tpu_torch.ops.kernels import HAMMING_2NN
from modular_slam_tpu_torch.types import Matches

Tensor = torch.Tensor

_BIG = 1e9
# landmarks per kernel output tile; equals kChunk in csrc/hamming_2nn.cu
HAMMING_CHUNK = 512
_NBITS = 256


def hamming_matrix(a_pm1: Tensor, b_pm1: Tensor) -> Tensor:
    """[..., N, 256] x [..., M, 256] ±1 int8 -> [..., N, M] float32 Hamming
    distances.  The ±1 dot products are small integers, exact in float32
    (TF32 is off; CUDA has no int32 matmul)."""
    dot = torch.matmul(a_pm1.to(torch.float32),
                       b_pm1.to(torch.float32).transpose(-1, -2))
    nbits = a_pm1.shape[-1]
    return (nbits - dot) * 0.5


def _ratio_test(best: Tensor, second: Tensor, best_idx: Tensor,
                query_valid: Tensor, cfg: MatcherConfig) -> Matches:
    ok = (query_valid & (best < _BIG) & (best <= cfg.max_hamming)
          & (best < cfg.lowe_ratio * second))
    return Matches(lm_slot=best_idx.to(torch.int32), distance=best, valid=ok)


def match_descriptors_plain(query_pm1: Tensor, query_valid: Tensor,
                            train_pm1: Tensor, train_valid: Tensor,
                            cfg: MatcherConfig) -> Matches:
    """Plain PyTorch 2-NN + ratio test over the full [N, M] distance
    matrix; leading batch dimensions broadcast."""
    d = hamming_matrix(query_pm1, train_pm1)
    d = torch.where(train_valid[..., None, :], d, torch.full_like(d, _BIG))
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[..., None])[..., 0]
    cols = torch.arange(d.shape[-1], device=d.device)
    d2 = torch.where(cols == best_idx[..., None], torch.full_like(d, _BIG), d)
    second = torch.amin(d2, dim=-1)
    return _ratio_test(best, second, best_idx, query_valid, cfg)


def hamming_2nn_tiles(query_pm1: Tensor, train_pm1: Tensor,
                      train_valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Kernel K2: per landmark chunk of HAMMING_CHUNK rows and per query,
    (best [..., G, Nq] f32, idx [..., G, Nq] i32, second [..., G, Nq] f32).

    query_pm1 [Nq, 256] or [B, Nq, 256] int8 ±1; train_pm1 [L, 256] or
    [B, L, 256] int8 ±1; train_valid [L] or [B, L] bool.  An unbatched
    operand is shared by every batch element.  Any Nq and any L >= 1."""
    for name, x in (("query", query_pm1), ("train", train_pm1),
                    ("train_valid", train_valid)):
        if not x.is_cuda:
            raise ValueError(f"hamming_2nn: {name} must be a CUDA tensor")
        if not x.is_contiguous():
            raise ValueError(f"hamming_2nn: {name} must be contiguous")
    if query_pm1.dtype != torch.int8 or train_pm1.dtype != torch.int8:
        raise TypeError("hamming_2nn: int8 ±1 descriptors expected")
    if train_valid.dtype != torch.bool:
        raise TypeError("hamming_2nn: bool train_valid expected")
    if query_pm1.shape[-1] != _NBITS or train_pm1.shape[-1] != _NBITS:
        raise ValueError(f"hamming_2nn: {_NBITS}-element rows expected")
    if query_pm1.dim() not in (2, 3) or train_pm1.dim() not in (2, 3):
        raise ValueError("hamming_2nn: [N, 256] or [B, N, 256] expected")
    if train_valid.dim() != train_pm1.dim() - 1 or \
            train_valid.shape != train_pm1.shape[:-1]:
        raise ValueError("hamming_2nn: train_valid must match train rows")
    devs = {query_pm1.device, train_pm1.device, train_valid.device}
    if len(devs) != 1:
        raise ValueError(f"hamming_2nn: operands on several devices {devs}")
    for x in (query_pm1, train_pm1):
        if x.data_ptr() % 16:
            raise ValueError("hamming_2nn: descriptors must be 16-byte "
                             "aligned")
    batched = query_pm1.dim() == 3 or train_pm1.dim() == 3
    Bq = query_pm1.shape[0] if query_pm1.dim() == 3 else 1
    Bt = train_pm1.shape[0] if train_pm1.dim() == 3 else 1
    if Bq != Bt and 1 not in (Bq, Bt):
        raise ValueError(f"hamming_2nn: batch sizes {Bq} and {Bt}")
    B = max(Bq, Bt)
    Nq = query_pm1.shape[-2]
    L = train_pm1.shape[-2]
    if L < 1:
        raise ValueError("hamming_2nn: at least one landmark row expected")
    G = -(-L // HAMMING_CHUNK)
    q_bs = Nq * _NBITS if (query_pm1.dim() == 3 and Bq > 1) else 0
    t_bs = L * _NBITS if (train_pm1.dim() == 3 and Bt > 1) else 0
    tv_bs = L if (train_pm1.dim() == 3 and Bt > 1) else 0
    dev = query_pm1.device
    best = torch.empty((B, G, Nq), dtype=torch.float32, device=dev)
    idx = torch.empty((B, G, Nq), dtype=torch.int32, device=dev)
    second = torch.empty((B, G, Nq), dtype=torch.float32, device=dev)
    if Nq and B:
        HAMMING_2NN.launch(
            query_pm1.data_ptr(), train_pm1.data_ptr(),
            train_valid.data_ptr(), best.data_ptr(), idx.data_ptr(),
            second.data_ptr(), B, Nq, L, G, q_bs, t_bs, tv_bs,
            torch.cuda.current_stream(dev).cuda_stream)
    if not batched:
        return best[0], idx[0], second[0]
    return best, idx, second


def merge_tiles(best_t: Tensor, idx_t: Tensor,
                second_t: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-tile top-2 [..., G, Nq] -> global (best, idx, second) [..., Nq]
    (the epilogue of `match_descriptors_pallas`, match_pallas.py:182-189).
    The first tile reaching the minimum wins, so its first index does."""
    g_star = torch.argmin(best_t, dim=-2, keepdim=True)       # [..., 1, Nq]
    best = torch.gather(best_t, -2, g_star)[..., 0, :]
    best_idx = torch.gather(idx_t, -2, g_star)[..., 0, :]
    rows = torch.arange(best_t.shape[-2], device=best_t.device)[:, None]
    others = torch.where(rows == g_star, torch.full_like(best_t, _BIG),
                         best_t)
    second = torch.minimum(torch.gather(second_t, -2, g_star)[..., 0, :],
                           torch.amin(others, dim=-2))
    return best, best_idx, second


def match_descriptors(query_pm1: Tensor, query_valid: Tensor,
                      train_pm1: Tensor, train_valid: Tensor,
                      cfg: MatcherConfig) -> Matches:
    """2-NN + ratio matches from query rows to train rows.

    Returns Matches(lm_slot = best train index, distance, valid); invalid
    query/train rows never match.  CUDA tensors: kernel K2 + the tile
    merge.  CPU tensors: the plain version."""
    if query_pm1.is_cuda:
        best, best_idx, second = merge_tiles(
            *hamming_2nn_tiles(query_pm1, train_pm1, train_valid))
        return _ratio_test(best, second, best_idx, query_valid, cfg)
    if query_pm1.device.type != "cpu":
        raise ValueError(f"match_descriptors: no kernel for device "
                         f"{query_pm1.device}")
    return match_descriptors_plain(query_pm1, query_valid, train_pm1,
                                   train_valid, cfg)


def dedupe_matches(m: Matches, n_train: int) -> Matches:
    """Keep only the best (smallest-distance, then lowest query index)
    query per train index.

    Ties use the integer key (2d)·N + q: Hamming distances are multiples
    of 0.5, so 2d is exact, and the key orders (distance, query index)
    totally.  N <= 2048 compares all pairs; larger N scatters the per-train
    minimum key."""
    N = m.distance.shape[0]
    dev = m.distance.device
    d = torch.where(m.valid, m.distance, torch.zeros_like(m.distance))
    qidx = torch.arange(N, dtype=torch.int32, device=dev)
    key = torch.where(m.valid, (2.0 * d).to(torch.int32) * N + qidx,
                      torch.full_like(qidx, 2**31 - 1))
    if N <= 2048:
        same = (m.lm_slot[:, None] == m.lm_slot[None, :]) & m.valid[None, :]
        better = same & (key[None, :] < key[:, None])
        keep = m.valid & ~torch.any(better, dim=1)
        return Matches(lm_slot=m.lm_slot, distance=m.distance, valid=keep)
    best_key = torch.full((n_train,), 2**31 - 1, dtype=torch.int32, device=dev)
    slot = m.lm_slot.long().clamp(0, n_train - 1)
    best_key = best_key.scatter_reduce(0, slot, key, reduce="amin")
    keep = m.valid & (key <= best_key[slot])
    return Matches(lm_slot=m.lm_slot, distance=m.distance, valid=keep)
