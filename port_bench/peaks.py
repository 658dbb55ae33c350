"""Published peaks of one NVIDIA H100 SXM and the work of the port's
hand-written kernels, counted from the shapes they were launched on.

Peaks are NVIDIA's data sheet figures (dense, at the 700 W power limit):
HBM at 3.35 TB/s, int8 tensor cores at 1,979 TOP/s.  The counts are what
the call's shapes need, whatever implements it:

- K1 (`csrc/fast_score.cu`, FAST scores of every pyramid level): each
  pixel's float32 luma read once and its float32 score written once,
  8 bytes a pixel.  Its arithmetic (24 operations a pixel and a few per
  corner ladder, at 67 TFLOP/s) bounds it below the bytes, so the bytes
  set the least time.
- K2 (`csrc/hamming_2nn.cu`, Hamming 2-NN as an int8 product): a
  multiply and an add per descriptor bit of every (query, train) pair,
  2 * Nq * L * 256 int8 operations, which bound it above its operands'
  bytes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
DESCRIPTOR_BITS = 256


def pyramid_shapes(h: int, w: int, n_levels: int,
                   scale: float) -> list:
    """The detector's level shapes (round(h / scale**l), round(w /
    scale**l)), level 0 first."""
    return [(h, w)] + [(int(round(h / scale ** lvl)),
                        int(round(w / scale ** lvl)))
                       for lvl in range(1, n_levels)]


def k1_bytes(shapes: Sequence[Tuple[int, int]], images: int) -> float:
    """Bytes one K1 launch over `images` pyramids of these level shapes
    needs: a float32 read and a float32 write per pixel."""
    return 8.0 * images * sum(h * w for h, w in shapes)


def k1_least_s(shapes: Sequence[Tuple[int, int]], images: int) -> float:
    return k1_bytes(shapes, images) / HBM_BYTES_PER_S


def k2_ops(batch: int, n_query: int, n_train: int) -> float:
    """int8 operations of one K2 launch: batch x Nq x L descriptor dot
    products of 256 multiply-adds."""
    return 2.0 * batch * n_query * n_train * DESCRIPTOR_BITS


def k2_least_s(batch: int, n_query: int, n_train: int) -> float:
    return k2_ops(batch, n_query, n_train) / INT8_OPS_PER_S
