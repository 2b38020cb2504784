"""Synthetic datasets (offline substitutes for CIFAR/Tiny-ImageNet features).

The paper's pipeline is: frozen pre-trained backbone → embeddings → linear
head. Offline we cannot download CIFAR or ImageNet weights, so benchmarks use:

  * ``gaussian_mixture`` — embedding-space classification with controllable
    class separation. This stands in for "backbone features of a C-class
    dataset": AFL's exactness/invariance claims are feature-distribution
    independent, and accuracy degradation effects for gradient FL under
    non-IID splits reproduce qualitatively (benchmarks/table1 etc.).
  * ``dummy_regression`` — the paper's own Supp. D dummy dataset (512-dim,
    10k samples, 10 balanced classes) for the ΔW deviation experiment.
  * ``token_classification`` — token sequences whose class shifts the token
    distribution; used end-to-end with real (randomly-initialized, frozen)
    transformer backbones from the architecture pool.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dataset:
    x: np.ndarray          # features (N, d) float32 or tokens (N, S) int32
    y: np.ndarray          # labels (N,) int64
    num_classes: int

    def __len__(self):
        return len(self.y)


def gaussian_mixture(
    n: int = 20_000,
    dim: int = 512,
    num_classes: int = 100,
    separation: float = 1.0,
    within_scale: float = 1.0,
    seed: int = 0,
) -> Dataset:
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((num_classes, dim)) * separation
    y = rng.integers(0, num_classes, n)
    x = means[y] + rng.standard_normal((n, dim)) * within_scale
    return Dataset(x.astype(np.float32), y, num_classes)


def dummy_regression(seed: int = 0) -> Dataset:
    """Paper Supp. D: 512-dim, 10,000 samples, 10 balanced classes."""
    rng = np.random.default_rng(seed)
    n, dim, c = 10_000, 512, 10
    x = rng.standard_normal((n, dim)).astype(np.float32)
    y = np.repeat(np.arange(c), n // c)
    rng.shuffle(y)
    return Dataset(x, y, c)


def token_classification(
    n: int = 2_000,
    seq: int = 32,
    vocab: int = 512,
    num_classes: int = 16,
    skew: float = 3.0,
    seed: int = 0,
) -> Dataset:
    """Class k biases token frequencies toward a class-specific region of the
    vocab, so even a random frozen backbone's mean-pooled features separate."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n)
    base = np.ones(vocab)
    toks = np.empty((n, seq), np.int32)
    block = vocab // num_classes
    for i in range(n):
        w = base.copy()
        lo = y[i] * block
        w[lo : lo + block] *= np.exp(skew)
        w /= w.sum()
        toks[i] = rng.choice(vocab, size=seq, p=w)
    return Dataset(toks, y, num_classes)


def train_test_split(ds: Dataset, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ds))
    cut = int(len(ds) * (1 - test_frac))
    tr, te = perm[:cut], perm[cut:]
    return (Dataset(ds.x[tr], ds.y[tr], ds.num_classes),
            Dataset(ds.x[te], ds.y[te], ds.num_classes))


def lm_stream(batch: int, seq: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Learnable token stream for LM pre-training: a noisy random-walk
    bigram process (next token ≈ current + small step, mod vocab) over a
    Zipf-weighted alphabet — a few hundred SGD steps visibly lower CE."""
    rng = np.random.default_rng(seed)
    toks = np.empty((batch, seq), np.int32)
    toks[:, 0] = rng.zipf(1.5, batch) % vocab
    steps = rng.integers(-8, 9, (batch, seq - 1))
    jumps = rng.random((batch, seq - 1)) < 0.05
    jump_to = rng.integers(0, vocab, (batch, seq - 1))
    for t in range(1, seq):
        nxt = (toks[:, t - 1] + steps[:, t - 1]) % vocab
        toks[:, t] = np.where(jumps[:, t - 1], jump_to[:, t - 1], nxt)
    return toks
