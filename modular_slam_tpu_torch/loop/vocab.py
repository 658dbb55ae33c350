"""Bag-of-binary-words vocabulary as a matrix product (counterpart of
modular_slam_tpu/loop/vocab.py).

The vocabulary is a fixed ±1 codebook [V, 256]; a descriptor's word is
its most similar codeword (first index on ties, as `argmax`), a frame's BoW
vector is the L2-normalized word histogram, and database scoring is a
matrix-vector product.  The packaged codebook, `data/vocab_1024_256.npz`,
is a byte copy of the JAX package's: the port reads nothing of that
package.

The ±1 dot products are integers of at most 256 in magnitude, exact in a
float32 product (TF32 is off), so the words, the histogram counts and
their norm are exact, and equal to the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

Tensor = torch.Tensor

_SEED = 0xB0BA
_VOCAB_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def make_vocab(vocab_size: int = 1024, n_bits: int = 256,
               seed: int = _SEED) -> np.ndarray:
    """[V, n_bits] ±1 int8 random-projection codebook; prefer
    `load_trained_vocab`."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-1, 1], np.int8), size=(vocab_size, n_bits))


def train_vocab(desc_pm1: np.ndarray, vocab_size: int = 1024,
                iters: int = 12, seed: int = _SEED) -> np.ndarray:
    """Spherical k-means over ±1 descriptors -> sign-binarized ±1 int8
    codebook [V, n_bits] (host numpy, as in the JAX package)."""
    rng = np.random.default_rng(seed)
    X = np.asarray(desc_pm1, np.float32)
    n = X.shape[0]
    if n < vocab_size:
        raise ValueError(f"need >= {vocab_size} descriptors, got {n}")
    C = X[rng.choice(n, vocab_size, replace=False)].copy()
    for _ in range(iters):
        assign = np.argmax(X @ C.T, axis=1)                # [N]
        sums = np.zeros_like(C)
        np.add.at(sums, assign, X)
        counts = np.bincount(assign, minlength=vocab_size)[:, None]
        # empty words re-seed from random descriptors (keeps V live words)
        empty = counts[:, 0] == 0
        C = np.where(empty[:, None], X[rng.choice(n, vocab_size)], sums)
        C = np.sign(C) + (C == 0)                          # ±1, ties -> +1
    return C.astype(np.int8)


def load_trained_vocab(vocab_size: int = 1024,
                       n_bits: int = 256) -> np.ndarray:
    """The packaged descriptor-calibrated codebook; the random-projection
    codebook when no packaged file has this size."""
    path = os.path.join(_VOCAB_DIR, f"vocab_{vocab_size}_{n_bits}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            return f["vocab"].astype(np.int8)
    return make_vocab(vocab_size, n_bits)


def descriptor_words(desc_pm1: Tensor, vocab: Tensor) -> Tensor:
    """[N, 256] ±1 -> [N] int32 word ids (most similar codeword)."""
    sim = torch.matmul(desc_pm1.to(torch.float32),
                       vocab.to(torch.float32).T)
    return torch.argmax(sim, dim=1).to(torch.int32)


def bow_histogram(desc_pm1: Tensor, valid: Tensor, vocab: Tensor) -> Tensor:
    """[N, 256] ±1 + [N] mask -> [V] L2-normalized BoW vector.  Invalid
    rows count into a spare bucket V that is cut off."""
    V = vocab.shape[0]
    words = torch.where(valid, descriptor_words(desc_pm1, vocab).long(), V)
    hist = torch.zeros(V + 1, dtype=torch.float32, device=desc_pm1.device)
    hist.index_add_(0, words, torch.ones_like(words, dtype=torch.float32))
    hist = hist[:V]
    n = torch.linalg.vector_norm(hist)
    return hist / torch.clamp(n, min=1e-6)
