"""Deterministic synthetic datasets.  Counterpart of ``repro.data.synthetic``:
numpy, drawing the same numbers from the same seeds.

* ``make_image_dataset`` — F-MNIST / CIFAR-10-shaped 10-class image task
  (class-conditional Gaussian blobs over structured templates).
* ``make_online_ues`` — per-UE OnlineDataset streams (App. G: N(2000,200)
  arrivals, 5-of-10 label support non-iid).
* ``make_token_batches`` — zipf-distributed token batches for LM training.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.drift import OnlineDataset


def make_image_dataset(num: int = 20000, shape=(28, 28, 1),
                       num_classes: int = 10, seed: int = 0,
                       noise: float = 0.35):
    """Class-conditional structured images + test split."""
    rng = np.random.RandomState(seed)
    H, W, C = shape
    # class templates: low-frequency random patterns
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    templates = []
    for c in range(num_classes):
        f1, f2 = rng.uniform(0.5, 3.0, 2)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        t = np.sin(2 * np.pi * f1 * xx / W + p1) \
            * np.cos(2 * np.pi * f2 * yy / H + p2)
        t = t[..., None] * rng.uniform(0.5, 1.0, (1, 1, C))
        templates.append(t)
    templates = np.stack(templates)           # (K, H, W, C)
    y = rng.randint(0, num_classes, num)
    x = templates[y] + noise * rng.randn(num, H, W, C)
    x = x.astype(np.float32)
    n_test = num // 5
    return (x[n_test:], y[n_test:]), (x[:n_test], y[:n_test])


def make_online_ues(train_x, train_y, num_ue: int = 20,
                    labels_per_ue: int = 5, mean_arrivals: float = 2000.0,
                    std_arrivals: float = 200.0, seed: int = 0,
                    drift_labels: bool = False) -> List[OnlineDataset]:
    """App. G non-iid streams: each UE sees 5 of the 10 labels."""
    rng = np.random.RandomState(seed)
    num_classes = int(train_y.max()) + 1
    ues = []
    for n in range(num_ue):
        support = rng.choice(num_classes, labels_per_ue, replace=False)
        ues.append(OnlineDataset(
            features=train_x, labels=train_y, label_support=support,
            mean_arrivals=mean_arrivals, std_arrivals=std_arrivals,
            seed=seed * 1000 + n, drift_labels=drift_labels))
    return ues


def make_token_batches(vocab: int, n_dpu: int, n_micro: int, mb: int,
                       seq: int, seed: int = 0, enc_seq: int = 0,
                       d_model: int = 0):
    """CE-FL-layout LM batch: tokens / labels (n_dpu, n_micro, mb, S),
    int32, labels the tokens shifted left by one (wrapping); with
    ``enc_seq``, ``enc_embed`` (n_dpu, n_micro, mb, enc_seq, d_model)."""
    rng = np.random.RandomState(seed)
    # zipf-ish marginal with local repetition structure
    base = rng.zipf(1.3, (n_dpu, n_micro, mb, seq)).astype(np.int64)
    tokens = (base % vocab).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    out = {"tokens": tokens, "labels": labels}
    if enc_seq:
        out["enc_embed"] = rng.randn(
            n_dpu, n_micro, mb, enc_seq, d_model).astype(np.float32) * 0.1
    return out
