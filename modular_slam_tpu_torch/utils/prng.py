"""JAX's random stream: the parts of `jax.random` the JAX package uses,
bit for bit (`PRNGKey`, `split`, `random_bits`, `uniform`, and `choice`
with the probabilities of ops/pnp.py's RANSAC draw).

Pinned to jax 0.9.0 on the CPU with its defaults: threefry2x32 keys,
`jax_threefry_partitionable=True` (`THREEFRY_PARTITIONABLE`) and
`jax_enable_x64=False` (`ENABLE_X64`).  A key is a uint32[2] numpy array,
a stack of keys [..., 2]; `split(key)` and `uniform(key, shape)` hash the
flat index of each output (its high and low 32-bit words) with
threefry2x32 under the key, as the partitionable scheme does.  Keys and
bits are integer hashes and are computed on the host, in numpy.

`choice_rows(key, valid, n_hyp)` is `jax.random.choice(key, N, (n_hyp,
3), p=probs)` with `probs = (valid + 1e-9) / sum` in float32
(modular_slam_tpu/ops/pnp.py:209-215).  Its uniforms are made on the
host and go to the rows' device through `utils/device.upload` (pinned,
non-blocking); the mapping to rows runs there and reads nothing back.
The float32 arithmetic of that mapping follows the order in which XLA's
CPU compiler runs `jnp.sum` and `jnp.cumsum` (its tree-reduction and
reduce-window rewrites), written as explicit elementwise adds so that a
CPU and a CUDA tensor round alike; the search is `jnp.searchsorted`'s
default binary search.  The reference is JAX on the CPU: JAX on a TPU
or a GPU may order these sums otherwise, and nothing here claims their
stream.

`Uniforms` stands where a key does once the key's uniforms are on the
device: a chunk's draws go up in one upload before its frames run.
"""

from __future__ import annotations

import math
import operator
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from modular_slam_tpu_torch.utils.device import upload
from modular_slam_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

THREEFRY_PARTITIONABLE = True
ENABLE_X64 = False

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_EPS = 1e-9               # pnp.py:211: keeps the probabilities normalizable
_SUM_WINDOW = 32          # XLA:CPU's tree-reduction window
_SCAN_BLOCK = 16          # XLA:CPU's reduce-window rewrite base


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` with x64 off: [0, seed mod 2**32].  A
    Python int outside int64 raises OverflowError, as JAX's does."""
    if isinstance(seed, int) and not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    return np.array([0, operator.index(seed) & 0xFFFFFFFF], np.uint32)


def as_key(key) -> np.ndarray:
    """A key or a stack of keys [..., 2] as uint32 (a JAX key array, an
    int32 view of one, or a CPU tensor)."""
    k = np.asarray(key)
    if k.ndim == 0 or k.shape[-1] != 2:
        raise ValueError(f"a key is uint32[..., 2], got shape {k.shape}")
    return k.astype(np.uint32, copy=False)


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (jax/_src/prng.py), on broadcast uint32
    arrays; the sums wrap modulo 2**32."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _hash_counts(key, n: int):
    """threefry2x32 under each key of [..., 2] of the counts 0..n-1, as
    (high word, low word) pairs -> two uint32 arrays [..., n]."""
    k = as_key(key)
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = i.astype(np.uint32)
    return _threefry2x32(k[..., 0, None], k[..., 1, None], hi, lo)


def split(key, num: int = 2):
    """`jax.random.split(key, num)`: keys [..., num, 2] from keys [..., 2].
    A sampler (a callable; ops/pnp.py) standing where a key does splits
    into `num` references to itself."""
    if callable(key):
        return [key] * num
    a, b = _hash_counts(key, num)
    return np.stack([a, b], axis=-1)


def random_bits(key, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.bits(key, shape)` (32-bit): uint32 [..., *shape], the
    XOR of threefry's two output words."""
    shape = tuple(shape)
    a, b = _hash_counts(key, math.prod(shape))
    return (a ^ b).reshape(a.shape[:-1] + shape)


def uniform(key, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.uniform(key, shape)` (float32 in [0, 1)): the top 23
    bits as a mantissa of [1, 2), less 1."""
    bits = random_bits(key, shape)
    one = np.float32(1.0).view(np.uint32)
    return ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)


class Uniforms:
    """The uniforms [..., n_hyp, 3] float32 of keys [...], already on the
    device: it stands where those keys do.  Indexing takes the leading
    axes."""

    __slots__ = ("u",)

    def __init__(self, u: Tensor):
        self.u = u

    def __getitem__(self, i) -> "Uniforms":
        return Uniforms(self.u[i])


def device_uniforms(key, n_hyp: int, device) -> Uniforms:
    """The draws of keys [..., 2], [..., n_hyp, 3], made on the host and
    put on `device` in one upload (the span `prng.uniforms`)."""
    with span("prng.uniforms"):
        return Uniforms(upload(uniform(key, (n_hyp, 3)), device))


def _left_to_right(x: Tensor) -> Tensor:
    """Inclusive prefix sums along the last axis, one add after another."""
    cols = list(x.unbind(-1))
    for c in range(1, len(cols)):
        cols[c] = cols[c - 1] + cols[c]
    return torch.stack(cols, dim=-1)


def _total(x: Tensor) -> Tensor:
    """The sum along the last axis, one add after another."""
    cols = x.unbind(-1)
    acc = cols[0]
    for col in cols[1:]:
        acc = acc + col
    return acc


def _sum_last(x: Tensor) -> Tensor:
    """`jnp.sum(x, -1)` of float32 as XLA:CPU orders it: the axis is cut
    into windows of 32 (zero padding split low = pad // 2, high = the
    rest), each window summed left to right, and the window sums summed
    the same way until 32 or fewer remain, which are summed left to
    right."""
    while x.shape[-1] > _SUM_WINDOW:
        n = x.shape[-1]
        nb = -(-n // _SUM_WINDOW)
        pad = nb * _SUM_WINDOW - n
        x = F.pad(x, (pad // 2, pad - pad // 2)).reshape(
            *x.shape[:-1], nb, _SUM_WINDOW)
        x = _total(x)
    return _total(x)


def _cumsum_last(x: Tensor) -> Tensor:
    """`jnp.cumsum(x, -1)` of float32 as XLA:CPU orders it: prefix sums
    left to right within blocks of 16 (zero padding at the end), the
    block totals scanned the same way (recursively), and each block's
    exclusive prefix added to its entries."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _left_to_right(x)
    nb = -(-n // _SCAN_BLOCK)
    local = _left_to_right(F.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], nb, _SCAN_BLOCK))
    totals = _cumsum_last(local[..., -1])
    before = F.pad(totals[..., :-1], (1, 0))
    return (local + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def _search_left(sorted_: Tensor, q: Tensor) -> Tensor:
    """`jnp.searchsorted(sorted_, q, side="left")` by JAX's default
    method: ceil(log2(N + 1)) halvings of [0, N], each going left where
    q <= sorted_[mid]; int64 [..., Q]."""
    n = sorted_.shape[-1]
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    for _ in range(n.bit_length()):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        left = q <= torch.gather(sorted_, -1, mid)
        lo = torch.where(left, lo, mid)
        hi = torch.where(left, mid, hi)
    return hi


def rows_from_uniforms(u: Tensor, valid: Tensor) -> Tensor:
    """Uniforms u [..., H, 3] and masks valid [..., N] -> the rows
    `jax.random.choice` draws from them, int64 [..., H, 3] on valid's
    device: probs = (valid + 1e-9) / sum, cdf = cumsum(probs),
    r = cdf[-1] * (1 - u), searchsorted(cdf, r)."""
    batch = torch.broadcast_shapes(u.shape[:-2], valid.shape[:-1])
    u = u.to(valid.device).expand(*batch, *u.shape[-2:])
    p = (valid.to(torch.float32) + _EPS).expand(*batch, valid.shape[-1])
    p = p / _sum_last(p)[..., None]
    cdf = _cumsum_last(p)
    r = cdf[..., -1:, None] * (1.0 - u)
    rows = _search_left(cdf, r.reshape(*batch, -1))
    return rows.reshape(u.shape)


def choice_rows(key: Union[np.ndarray, Uniforms], valid: Tensor,
                n_hyp: int) -> Tensor:
    """`jax.random.choice(key, N, (n_hyp, 3), replace=True, p=probs)`
    with pnp.py's probabilities, for keys [..., 2] (or their `Uniforms`)
    and masks valid [..., N] -> int64 rows [..., n_hyp, 3] on valid's
    device."""
    if not isinstance(key, Uniforms):
        key = device_uniforms(key, n_hyp, valid.device)
    return rows_from_uniforms(key.u, valid)
