"""Brute-force Hamming 2-NN descriptor matching with Lowe ratio test
(counterpart of modular_slam_tpu/ops/match.py and, for the kernel,
ops/match_pallas.py).

`match_descriptors` is the entry point.  On CUDA tensors it launches two
hand-written kernels: `csrc/hamming_2nn.cu` (kernel K2, which replaces the
Pallas kernel `match_pallas.py::_tile_kernel`) computes a (best, first
index, second) triple per landmark split and query on the int8 tensor
cores, and `csrc/hamming_merge.cu` merges the triples and applies the
ratio test (the XLA epilogue of `match_descriptors_pallas`,
match_pallas.py:182-196).  On CPU tensors it runs
`match_descriptors_plain`, the full-matrix formulation of the JAX package,
which is also the kernels' oracle; `hamming_2nn_splits_plain`,
`merge_tiles` and `_ratio_test` are the plain versions of the two kernels
one by one.  There is no fallback between the two paths.

Each kernel's launch is a `torch.library.custom_op` with a vmap rule, so
that `torch.func.vmap` of the tracker (parallel/dp.py) launches K2 and
the merge once for a batch of sequences.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from modular_slam_tpu_torch.config import MatcherConfig
from modular_slam_tpu_torch.ops.kernels import HAMMING_2NN, HAMMING_MERGE
from modular_slam_tpu_torch.types import Matches

Tensor = torch.Tensor

_BIG = 1e9
# landmarks per ring stage of kernel K2; equals kChunk in csrc/hamming_2nn.cu
HAMMING_CHUNK = 128
# queries per block of kernel K2 (kQB)
HAMMING_QUERY_BLOCK = 128
# chunks in one split: its columns are numbered in 16 bits (kMaxSplitColumns)
HAMMING_MAX_SPLIT_CHUNKS = 512
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


def hamming_split_plan(n_train: int, n_splits: int) -> Tuple[int, int]:
    """(chunks per split, S) for cutting L landmark rows into at most
    `n_splits` runs of whole HAMMING_CHUNK-row chunks (but runs of at most
    HAMMING_MAX_SPLIT_CHUNKS); split s covers rows [s * cps * 128,
    (s + 1) * cps * 128) and none is empty."""
    n_chunks = -(-n_train // HAMMING_CHUNK)
    cps = min(-(-n_chunks // max(1, min(n_splits, n_chunks))),
              HAMMING_MAX_SPLIT_CHUNKS)
    return cps, -(-n_chunks // cps)


def hamming_n_splits(n_query: int, batch: int, device) -> int:
    """Splits of L for kernel K2: enough blocks for about two per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(1, -(-n_query // HAMMING_QUERY_BLOCK) * batch)
    return max(1, math.ceil(2 * sms / blocks))


def hamming_2nn_splits_plain(query_pm1: Tensor, train_pm1: Tensor,
                             train_valid: Tensor, chunks_per_split: int,
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of kernel K2: per split of chunks_per_split *
    HAMMING_CHUNK landmark rows and per query, (best [..., S, Nq] f32,
    first index [..., S, Nq] i32, second [..., S, Nq] f32), where second
    is the split's minimum with only the best column masked to 1e9."""
    d = hamming_matrix(query_pm1, train_pm1)
    d = torch.where(train_valid[..., None, :], d, torch.full_like(d, _BIG))
    L = d.shape[-1]
    w = chunks_per_split * HAMMING_CHUNK
    S = -(-L // w)
    d = torch.nn.functional.pad(d, (0, S * w - L), value=math.inf)
    d = d.reshape(*d.shape[:-1], S, w)                  # [..., Nq, S, w]
    arg = torch.argmin(d, dim=-1, keepdim=True)
    best = torch.gather(d, -1, arg)[..., 0]
    cols = torch.arange(w, device=d.device)
    second = torch.amin(torch.where(cols == arg, torch.full_like(d, _BIG),
                                    d), dim=-1)
    idx = arg[..., 0] + torch.arange(S, device=d.device) * w
    return (best.transpose(-1, -2), idx.to(torch.int32).transpose(-1, -2),
            second.transpose(-1, -2))


def merge_tiles(best_t: Tensor, idx_t: Tensor,
                second_t: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-split top-2 [..., S, Nq] -> global (best, idx, second) [..., Nq]
    (the epilogue of `match_descriptors_pallas`, match_pallas.py:182-189;
    plain version of csrc/hamming_merge.cu with `_ratio_test`).  The first
    split reaching the minimum wins, so its first index does."""
    g_star = torch.argmin(best_t, dim=-2, keepdim=True)       # [..., 1, Nq]
    best = torch.gather(best_t, -2, g_star)[..., 0, :]
    best_idx = torch.gather(idx_t, -2, g_star)[..., 0, :]
    rows = torch.arange(best_t.shape[-2], device=best_t.device)[:, None]
    others = torch.where(rows == g_star, torch.full_like(best_t, _BIG),
                         best_t)
    second = torch.minimum(torch.gather(second_t, -2, g_star)[..., 0, :],
                           torch.amin(others, dim=-2))
    return best, best_idx, second


def _check_cuda(name: str, x: Tensor, dtype: torch.dtype) -> None:
    if not x.is_cuda:
        raise ValueError(f"hamming_2nn: {name} must be a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError(f"hamming_2nn: {name} must be contiguous")
    if x.dtype != dtype:
        raise TypeError(f"hamming_2nn: {name} must be {dtype}, got "
                        f"{x.dtype}")


def _batch(x: Tensor, rank: int) -> int:
    """Batch size of an operand whose unbatched rank is `rank`: 1, or its
    leading dimension when it has one more."""
    return x.shape[0] if x.dim() == rank + 1 else 1


def _check_splits(query_pm1: Tensor, train_pm1: Tensor,
                  train_valid: Tensor) -> None:
    _check_cuda("query", query_pm1, torch.int8)
    _check_cuda("train", train_pm1, torch.int8)
    _check_cuda("train_valid", train_valid, torch.bool)
    if query_pm1.shape[-1] != _NBITS or train_pm1.shape[-1] != _NBITS:
        raise ValueError(f"hamming_2nn: {_NBITS}-element rows expected")
    if query_pm1.dim() not in (2, 3) or train_pm1.dim() not in (2, 3):
        raise ValueError("hamming_2nn: [N, 256] or [B, N, 256] expected")
    if (train_valid.dim() not in (1, 2)
            or train_valid.shape[-1] != train_pm1.shape[-2]):
        raise ValueError("hamming_2nn: train_valid must be [L] or [B, L] "
                         "over the train rows")
    if train_pm1.shape[-2] < 1:
        raise ValueError("hamming_2nn: at least one landmark row expected")


def _splits_plan(query_pm1: Tensor, train_pm1: Tensor,
                 train_valid: Tensor) -> Tuple[int, int, Tuple[int, ...]]:
    """(B, chunks per split, shape of each split triple): [S, Nq] for
    unbatched operands, [B, S, Nq] when one is batched."""
    Bq, Bt, Bv = (_batch(query_pm1, 2), _batch(train_pm1, 2),
                  _batch(train_valid, 1))
    if len({Bq, Bt, Bv} - {1}) > 1:
        raise ValueError(f"hamming_2nn: batch sizes {Bq}, {Bt} and {Bv}")
    B = max(Bq, Bt, Bv)
    Nq = query_pm1.shape[-2]
    cps, S = hamming_split_plan(train_pm1.shape[-2],
                                hamming_n_splits(Nq, B, query_pm1.device))
    if query_pm1.dim() == 2 and train_pm1.dim() == 2 \
            and train_valid.dim() == 1:
        return B, cps, (S, Nq)
    return B, cps, (B, S, Nq)


@torch.library.custom_op("mslam::hamming_2nn_splits", mutates_args=(),
                         device_types="cuda")
def _hamming_2nn_splits_op(query_pm1: Tensor, train_pm1: Tensor,
                           train_valid: Tensor
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Kernel K2 as an operator, so that `torch.func.vmap` batches it
    (`_splits_vmap`: one launch for the batch).  Operands as
    `hamming_2nn_splits`, checked; the triples are [S, Nq] for unbatched
    operands and [B, S, Nq] otherwise."""
    devs = {query_pm1.device, train_pm1.device, train_valid.device}
    if len(devs) != 1:
        raise ValueError(f"hamming_2nn: operands on several devices {devs}")
    for x in (query_pm1, train_pm1):
        if x.data_ptr() % 16:
            raise ValueError("hamming_2nn: descriptors must be 16-byte "
                             "aligned")
    B, cps, shape = _splits_plan(query_pm1, train_pm1, train_valid)
    S, Nq, L = shape[-2], shape[-1], train_pm1.shape[-2]
    dev = query_pm1.device
    best = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    second = torch.empty(shape, dtype=torch.float32, device=dev)
    if Nq and B:
        HAMMING_2NN.launch(
            query_pm1.data_ptr(), train_pm1.data_ptr(),
            train_valid.data_ptr(), best.data_ptr(), idx.data_ptr(),
            second.data_ptr(), B, Nq, L, S, cps,
            Nq * _NBITS if query_pm1.dim() == 3 else 0,
            L * _NBITS if train_pm1.dim() == 3 else 0,
            L if train_valid.dim() == 2 else 0,
            torch.cuda.current_stream(dev).cuda_stream)
    return best, idx, second


@_hamming_2nn_splits_op.register_fake
def _(query_pm1, train_pm1, train_valid):
    shape = _splits_plan(query_pm1, train_pm1, train_valid)[2]
    f32 = query_pm1.new_empty(shape, dtype=torch.float32)
    return f32, query_pm1.new_empty(shape, dtype=torch.int32), \
        torch.empty_like(f32)


def _to_front(x: Tensor, dim: Optional[int]) -> Tensor:
    return x if dim is None else x.movedim(dim, 0).contiguous()


def _splits_vmap(info, in_dims, query_pm1, train_pm1, train_valid):
    """vmap rule of K2: the vmapped operands with their batch at dim 0,
    an operand not vmapped shared by the batch (the kernel's zero batch
    stride), one launch.  Operands batched already besides the vmap
    are not taken."""
    args = [_to_front(x, d) for x, d in zip(
        (query_pm1, train_pm1, train_valid), in_dims)]
    for x, d, rank in zip(args, in_dims, (2, 2, 1)):
        if x.dim() != rank + (d is not None):
            raise ValueError("hamming_2nn: a batched operand under vmap")
    return _hamming_2nn_splits_op(*args), (0, 0, 0)


torch.library.register_vmap(_hamming_2nn_splits_op, _splits_vmap)


@torch.library.custom_op("mslam::hamming_merge", mutates_args=(),
                         device_types="cuda")
def _hamming_merge_op(best: Tensor, idx: Tensor, second: Tensor,
                      query_valid: Tensor, max_hamming: float,
                      lowe_ratio: float) -> Tuple[Tensor, Tensor, Tensor]:
    """The merge kernel as an operator (`_merge_vmap` batches it): split
    triples [S, Nq] or [B, S, Nq] and query_valid [Nq] (shared by the
    batch) or [B, Nq] -> lm_slot, distance, valid, [Nq] or [B, Nq]."""
    dev = best.device
    S, Nq = best.shape[-2:]
    B = _batch(best, 2)
    shape = best.shape[:-2] + (Nq,)
    lm_slot = torch.empty(shape, dtype=torch.int32, device=dev)
    distance = torch.empty(shape, dtype=torch.float32, device=dev)
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    if Nq and B:
        HAMMING_MERGE.launch(
            best.data_ptr(), idx.data_ptr(), second.data_ptr(),
            query_valid.data_ptr(), lm_slot.data_ptr(), distance.data_ptr(),
            valid.data_ptr(), B, S, Nq,
            Nq if query_valid.dim() == 2 else 0, max_hamming, lowe_ratio,
            torch.cuda.current_stream(dev).cuda_stream)
    return lm_slot, distance, valid


@_hamming_merge_op.register_fake
def _(best, idx, second, query_valid, max_hamming, lowe_ratio):
    shape = best.shape[:-2] + best.shape[-1:]
    return (best.new_empty(shape, dtype=torch.int32),
            best.new_empty(shape), best.new_empty(shape, dtype=torch.bool))


def _merge_vmap(info, in_dims, best, idx, second, query_valid, max_hamming,
                lowe_ratio):
    """vmap rule of the merge: triples with their batch at dim 0 (a
    triple not vmapped is expanded to the batch), query_valid shared
    when not vmapped, one launch."""
    B = info.batch_size
    trip = [_to_front(x, d) if d is not None
            else x.expand(B, *x.shape).contiguous()
            for x, d in zip((best, idx, second), in_dims[:3])]
    qv = _to_front(query_valid, in_dims[3])
    if trip[0].dim() != 3 or qv.dim() != 1 + (in_dims[3] is not None):
        raise ValueError("hamming_merge: a batched operand under vmap")
    return _hamming_merge_op(*trip, qv, max_hamming, lowe_ratio), (0, 0, 0)


torch.library.register_vmap(_hamming_merge_op, _merge_vmap)


def hamming_2nn_splits(query_pm1: Tensor, train_pm1: Tensor,
                       train_valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Kernel K2 alone: the split triples (best, idx, second), each
    [..., S, Nq], as `hamming_2nn_splits_plain` with the chunks per split
    of `hamming_split_plan(L, hamming_n_splits(Nq, B, device))`.

    query_pm1 [Nq, 256] or [B, Nq, 256] int8 ±1; train_pm1 [L, 256] or
    [B, L, 256] int8 ±1 (an unset row of zeros is allowed: the kernel
    keys dot products of at most 256 in magnitude); train_valid [L] or
    [B, L] bool.  An unbatched operand is shared by every batch element:
    B masks over one set of rows compare the same queries with the same
    rows under B masks.  Any Nq and any L >= 1.  Under `torch.func.vmap`
    the vmapped batch is B (then S follows the vmapped B): one launch."""
    _check_splits(query_pm1, train_pm1, train_valid)
    return _hamming_2nn_splits_op(query_pm1, train_pm1, train_valid)


def match_descriptors_cuda(query_pm1: Tensor, query_valid: Tensor,
                           train_pm1: Tensor, train_valid: Tensor,
                           cfg: MatcherConfig) -> Matches:
    """Kernels K2 and the merge: two launches, `Matches` written on the
    card, for a batch under `torch.func.vmap` too.  Shapes as
    `hamming_2nn_splits`; query_valid [Nq] or [B, Nq] bool, like the
    query rows."""
    _check_cuda("query_valid", query_valid, torch.bool)
    if query_valid.shape != query_pm1.shape[:-1]:
        raise ValueError("hamming_2nn: query_valid must match query rows")
    best, idx, second = hamming_2nn_splits(query_pm1, train_pm1, train_valid)
    lm_slot, distance, valid = _hamming_merge_op(
        best, idx, second, query_valid, float(cfg.max_hamming),
        float(cfg.lowe_ratio))
    return Matches(lm_slot=lm_slot, distance=distance, valid=valid)


def match_descriptors(query_pm1: Tensor, query_valid: Tensor,
                      train_pm1: Tensor, train_valid: Tensor,
                      cfg: MatcherConfig) -> Matches:
    """2-NN + ratio matches from query rows to train rows.

    Returns Matches(lm_slot = best train index, distance, valid); invalid
    query/train rows never match.  CUDA tensors: kernel K2 + the merge
    kernel.  CPU tensors: the plain version."""
    if query_pm1.is_cuda:
        return match_descriptors_cuda(query_pm1, query_valid, train_pm1,
                                      train_valid, cfg)
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
