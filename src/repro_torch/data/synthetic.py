"""Synthetic datasets; a copy of ``repro.data.synthetic``, which is plain
numpy.

* ``class_gaussian_images`` — CIFAR-like 32x32x3, 10 classes, class-conditional
  Gaussians (CIFAR-10 itself is not available offline; Dirichlet label skew —
  the quantity the paper varies — is preserved exactly).
* ``token_stream`` — per-worker heterogeneous LM token data: each worker draws
  from a distinct Zipf-ish unigram distribution mixed with shared bigram
  structure, so local objectives F_i genuinely differ.
"""

from __future__ import annotations

import numpy as np

__all__ = ["class_gaussian_images", "make_token_sampler"]


def class_gaussian_images(
    n: int = 10000, n_classes: int = 10, hw: int = 32, ch: int = 3, seed: int = 0
):
    """Returns (images [n,hw,hw,ch] f32, labels [n] int64)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1.0, size=(n_classes, 8))  # low-dim class codes
    proj = rng.normal(0, 1.0, size=(8, hw * hw * ch)) / np.sqrt(8)
    labels = rng.integers(0, n_classes, size=n)
    base = means[labels] @ proj
    x = base + rng.normal(0, 1.0, size=(n, hw * hw * ch))
    x = x.reshape(n, hw, hw, ch).astype(np.float32)
    x = (x - x.mean()) / (x.std() + 1e-8)
    return x, labels.astype(np.int64)


def make_token_sampler(
    n_workers: int, vocab: int, seq_len: int, batch: int,
    heterogeneity: float = 1.0, seed: int = 0,
):
    """Per-worker LM batch sampler with tunable distribution skew.

    Each worker i has unigram logits = shared + heterogeneity * private_i.
    Returns ``sample(worker, rng) -> {"tokens": [B,S], "labels": [B,S]}``.
    """
    rng0 = np.random.default_rng(seed)
    shared = rng0.normal(0, 1, size=vocab)
    private = rng0.normal(0, 1, size=(n_workers, vocab))

    probs = []
    for i in range(n_workers):
        logit = shared + heterogeneity * private[i]
        p = np.exp(logit - logit.max())
        probs.append(p / p.sum())

    def sample(worker: int, rng: np.random.Generator):
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs[worker])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    return sample
