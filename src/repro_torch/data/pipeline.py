"""Synthetic, deterministic, shardable data pipelines (a copy of
``repro.data.pipeline``, which holds no JAX code).

The container is offline (no CIFAR-10 / text corpora), so we generate
procedural data with enough learnable structure that accuracy *trends*
(the paper's concern — Sec. V-A "we primarily concern the range of
accuracy variation ... instead of the absolute value") are measurable:

* ``TokenTaskStream`` — language-model batches where the next token is a
  deterministic affine function of the previous k tokens (learnable by a
  small transformer; random baseline = 1/vocab accuracy).
* ``PatternImageStream`` — CIFAR-like 32x32x3 images whose class controls
  a spatial frequency/orientation pattern plus noise (learnable by ViT).

Both are iterator-style, seeded, and emit globally-batched numpy arrays
that the launcher shards over the (pod, data) mesh axes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class TokenTaskStream:
    """Periodic-copy LM task: each sequence is a random length-`period`
    pattern tiled to seq_len, so the next token equals the token `period`
    positions back — learnable by attention (induction) and by recurrent
    state within tens of steps, with 1/vocab random baseline."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    period: int = 4

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + 1)
        V, p = self.vocab_size, self.period
        reps = -(-(self.seq_len + 1) // p)
        while True:
            pat = rng.integers(0, V, size=(self.batch_size, p))
            toks = np.tile(pat, (1, reps))[:, : self.seq_len + 1].astype(np.int32)
            yield {
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
            }


@dataclasses.dataclass
class PatternImageStream:
    """Class-conditional oriented sinusoid gratings + noise, 32x32x3."""

    num_classes: int = 10
    image_size: int = 32
    batch_size: int = 64
    noise: float = 0.35
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        s = self.image_size
        yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        while True:
            labels = rng.integers(0, self.num_classes, size=self.batch_size)
            angles = labels * (np.pi / self.num_classes)
            freqs = 2.0 + (labels % 5)
            imgs = np.zeros((self.batch_size, s, s, 3), dtype=np.float32)
            for b in range(self.batch_size):
                phase = rng.uniform(0, 2 * np.pi)
                wave = np.sin(
                    2 * np.pi * freqs[b] / s
                    * (xx * np.cos(angles[b]) + yy * np.sin(angles[b]))
                    + phase)
                for c in range(3):
                    imgs[b, :, :, c] = wave * (0.5 + 0.5 * ((labels[b] >> c) & 1))
            imgs += rng.normal(0, self.noise, size=imgs.shape).astype(np.float32)
            yield {"images": imgs, "labels": labels.astype(np.int32)}


def skip_batches(stream_iter: Iterator[dict], n: int) -> Iterator[dict]:
    """Fast-forward a stream iterator past its first ``n`` batches.

    The streams are seeded and draw a fixed number of RNG variates per
    batch, so discarding ``n`` draws reproduces EXACTLY the generator
    state an uninterrupted run would have after ``n`` batches — this is
    how a resumed trainer re-aligns its data position with the checkpoint
    (cheap: the data is synthetic)."""
    for _ in range(n):
        next(stream_iter)
    return stream_iter


def patchify(images: np.ndarray, patch: int = 4) -> np.ndarray:
    """[B,H,W,C] -> [B, (H/p)*(W/p), p*p*C] patch embedding input."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, patch * patch * c)
    return x


def eval_accuracy(predict_fn, stream_iter, num_batches: int = 8) -> float:
    """Top-1 accuracy of `predict_fn(batch) -> logits` over held-out batches."""
    correct = total = 0
    for _ in range(num_batches):
        batch = next(stream_iter)
        logits = np.asarray(predict_fn(batch))
        pred = logits.argmax(-1)
        labels = batch["labels"]
        correct += (pred == labels).sum()
        total += labels.size
    return float(correct) / float(total)
