"""Deterministic synthetic data (offline: no downloads).

The counterpart of ``repro.data.synthetic``'s ``ImageClassDataset``
(class-conditional Gaussian prototypes plus noise at a configurable image
size and number of classes; GTSRB-like: 43 classes, CIFAR-like: 10) and
``TokenDataset`` (planted-bigram language-modelling sequences) and
``NLIDataset`` (uniform token sequences with 8 class-indicative tokens
planted at random positions, SNLI-like: 3 classes).  The numpy
generation is the JAX package's, draw for draw, so the same seed gives the
same examples in both packages; ``get`` returns CPU tensors, which the
trainer moves to its device.  ``EncDecDataset`` (the encoder-decoder's
tokens with Gaussian frame embeddings) has no counterpart there: the
JAX package's CLI feeds that family tokens only, which its loss cannot
take.

Examples are index-addressable (``get(indices)``) so the Poisson
subsampler can draw arbitrary subsets, and memoized: the first epoch pays
the Python-loop generation, later epochs are a numpy gather.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ImageClassDataset:
    n: int
    num_classes: int
    image_size: int = 32
    channels: int = 3
    noise: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        d = self.image_size * self.image_size * self.channels
        self.prototypes = rng.randn(self.num_classes, d).astype(np.float32)
        self.labels = rng.randint(0, self.num_classes,
                                  size=self.n).astype(np.int32)
        self._noise_seed = rng.randint(0, 2**31 - 1, size=self.n)
        self._cache: dict = {}

    def _example(self, idx: int) -> np.ndarray:
        x = self._cache.get(idx)
        if x is None:
            d = self.image_size * self.image_size * self.channels
            r = np.random.RandomState(self._noise_seed[idx])
            x = (self.prototypes[self.labels[idx]]
                 + self.noise * r.randn(d)).astype(np.float32)
            self._cache[idx] = x
        return x

    def get(self, indices: np.ndarray) -> dict:
        """{"image": (n, H, W, C) float32, "label": (n,) int32}, on the CPU."""
        ys = self.labels[indices]
        xs = np.stack([self._example(int(idx)) for idx in indices])
        xs = xs.reshape(len(indices), self.image_size, self.image_size,
                        self.channels)
        return {"image": torch.from_numpy(xs),
                "label": torch.from_numpy(np.ascontiguousarray(ys))}


@dataclasses.dataclass
class TokenDataset:
    """Planted-bigram language modelling data: every token has 8 likely
    successors (probability 0.9), otherwise a uniform token."""
    n: int
    vocab: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.successors = rng.randint(0, self.vocab,
                                      size=(self.vocab, 8)).astype(np.int32)
        self._seeds = rng.randint(0, 2**31 - 1, size=self.n)
        self._cache: dict = {}

    def _example(self, idx: int) -> np.ndarray:
        seq = self._cache.get(idx)
        if seq is None:
            r = np.random.RandomState(self._seeds[idx])
            seq = np.empty(self.seq_len, np.int32)
            seq[0] = r.randint(self.vocab)
            for t in range(1, self.seq_len):
                if r.rand() < 0.9:
                    seq[t] = self.successors[seq[t - 1], r.randint(8)]
                else:
                    seq[t] = r.randint(self.vocab)
            self._cache[idx] = seq
        return seq

    def get(self, indices: np.ndarray) -> dict:
        """{"tokens": (n, seq_len) int32}, on the CPU."""
        out = np.stack([self._example(int(idx)) for idx in indices])
        return {"tokens": torch.from_numpy(out)}


@dataclasses.dataclass
class NLIDataset:
    """Sequence classification data: uniform tokens, with 8 tokens drawn
    from the label's 16 class-indicative tokens planted at random
    positions."""
    n: int
    vocab: int
    seq_len: int = 64
    num_classes: int = 3
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.labels = rng.randint(0, self.num_classes,
                                  self.n).astype(np.int32)
        self.class_tokens = rng.randint(
            0, self.vocab, size=(self.num_classes, 16)).astype(np.int32)
        self._seeds = rng.randint(0, 2**31 - 1, size=self.n)
        self._cache: dict = {}

    def _example(self, idx: int) -> np.ndarray:
        seq = self._cache.get(idx)
        if seq is None:
            r = np.random.RandomState(self._seeds[idx])
            seq = r.randint(0, self.vocab, self.seq_len)
            pos = r.choice(self.seq_len, 8, replace=False)
            seq[pos] = self.class_tokens[self.labels[idx],
                                         r.randint(0, 16, 8)]
            seq = seq.astype(np.int32)
            self._cache[idx] = seq
        return seq

    def get(self, indices: np.ndarray) -> dict:
        """{"tokens": (n, seq_len) int32, "label": (n,) int32}, on the
        CPU."""
        ys = self.labels[indices]
        xs = np.stack([self._example(int(idx)) for idx in indices])
        return {"tokens": torch.from_numpy(xs),
                "label": torch.from_numpy(np.ascontiguousarray(ys))}


@dataclasses.dataclass
class EncDecDataset(TokenDataset):
    """``TokenDataset``'s sequences with the encoder's input: ``enc_embeds``
    (seq_len, d_model) N(0, 1) float32 a sequence, drawn from the PCG64
    stream of ``(seed, index)`` each time it is asked for (a Poisson
    re-draw of an index returns the same example).  Not cached: at
    whisper-medium's 448 x 1024 a dataset of 4096 would hold 7.5 GB."""
    d_model: int = 0

    def get(self, indices: np.ndarray) -> dict:
        """{"tokens": (n, seq_len) int32, "enc_embeds": (n, seq_len,
        d_model) float32}, on the CPU."""
        out = super().get(indices)
        embeds = np.empty((len(indices), self.seq_len, self.d_model),
                          np.float32)
        for row, idx in zip(embeds, indices):
            np.random.default_rng([self.seed, int(idx)]).standard_normal(
                dtype=np.float32, out=row)
        out["enc_embeds"] = torch.from_numpy(embeds)
        return out
