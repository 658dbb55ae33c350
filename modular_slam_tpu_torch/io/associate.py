"""Timestamp association for TUM RGB-D sequences — a numpy-only copy of
modular_slam_tpu/io/associate.py (the JAX package's `io/__init__` imports
jax, so the port cannot import it from there).

Reimplements the semantics of the reference's bundled TUM tool
(utils/tools/py/associate.py:71-102 of the reference, BSD, (c) TUM):
greedily pair (rgb, depth) timestamps by smallest |t1 - (t2 + offset)|
under max_difference, each timestamp used at most once.

This implementation is vectorized numpy rather than the original's
O(n^2) python list scan, with identical pairing results (best-first
greedy on the global sorted potential-match list).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def associate(
    first_stamps: Sequence[float],
    second_stamps: Sequence[float],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[int, int]]:
    """Return index pairs (i, j) pairing first[i] with second[j].

    Greedy best-first: all candidate pairs within max_difference are
    sorted by |difference| and taken while both endpoints are unused —
    matching the reference algorithm's behavior.
    """
    a = np.asarray(first_stamps, dtype=np.float64)
    b = np.asarray(second_stamps, dtype=np.float64) + offset
    if a.size == 0 or b.size == 0:
        return []

    # candidate generation: for each a[i], only b entries within the window
    # (search via sorted b) — avoids the full n*m blowup on long sequences.
    order_b = np.argsort(b, kind="stable")
    b_sorted = b[order_b]
    lo = np.searchsorted(b_sorted, a - max_difference, side="left")
    hi = np.searchsorted(b_sorted, a + max_difference, side="right")

    cand_i: List[np.ndarray] = []
    cand_j: List[np.ndarray] = []
    for i in range(a.size):
        if hi[i] > lo[i]:
            js = order_b[lo[i]:hi[i]]
            cand_i.append(np.full(js.size, i, dtype=np.int64))
            cand_j.append(js)
    if not cand_i:
        return []
    ci = np.concatenate(cand_i)
    cj = np.concatenate(cand_j)
    diff = np.abs(a[ci] - b[cj])

    order = np.argsort(diff, kind="stable")
    used_a = np.zeros(a.size, dtype=bool)
    used_b = np.zeros(b.size, dtype=bool)
    pairs: List[Tuple[int, int]] = []
    for k in order:
        i, j = int(ci[k]), int(cj[k])
        if not used_a[i] and not used_b[j]:
            used_a[i] = used_b[j] = True
            pairs.append((i, j))
    pairs.sort(key=lambda p: a[p[0]])
    return pairs
