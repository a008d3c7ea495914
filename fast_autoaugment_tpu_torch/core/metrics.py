"""Losses and metric accumulation (``fast_autoaugment_tpu/core/metrics.py``).

- softmax cross entropy with integer labels, and its label-smoothed form
  (reference ``metrics.py:26-46``);
- top-k correctness and accuracy (reference ``metrics.py:10-23``);
- :class:`Accumulator` (reference ``metrics.py:49-85``): count-weighted
  sums normalized by the total sample count.  Values may be Python floats
  or tensors on any device; they are only read back to the host at
  ``normalize``/``__getitem__`` time, so the device is never stalled
  mid-loop.

Mixup (``core/metrics.py:58``, ``:73``) is not ported yet: no ported
configuration uses it, and it needs a Beta sampler (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import torch

__all__ = ["cross_entropy", "smooth_cross_entropy", "top_k_correct", "accuracy",
           "Accumulator"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  reduce_mean: bool = True) -> torch.Tensor:
    """Plain softmax cross entropy with integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.int64)[:, None])[:, 0]
    return nll.mean() if reduce_mean else nll


def smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, epsilon: float = 0.0,
                         reduce_mean: bool = True) -> torch.Tensor:
    """Label-smoothed cross entropy (``CrossEntropyLabelSmooth``, reference
    ``metrics.py:26-46``): targets ``(1 - eps) * onehot + eps / classes``;
    plain cross entropy when ``epsilon`` is 0."""
    if not epsilon:
        return cross_entropy(logits, labels, reduce_mean)
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64), num_classes).to(logits.dtype)
    targets = (1.0 - epsilon) * onehot + epsilon / num_classes
    nll = -(targets * logp).sum(dim=-1)
    return nll.mean() if reduce_mean else nll


def top_k_correct(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Number of samples whose true label is in the top-k logits."""
    topk = torch.topk(logits, k, dim=-1).indices
    return (topk == labels.to(torch.int64)[:, None]).any(dim=-1).sum()


def accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1,)):
    """Top-k accuracies as fractions (reference ``metrics.py:10-23``)."""
    n = logits.shape[0]
    return tuple(top_k_correct(logits, labels, k) / n for k in topk)


class Accumulator:
    """Count-weighted metric sums (reference ``metrics.py:49-85``).

    ``add_dict`` accumulates raw sums; ``normalize()`` divides everything
    except the counter key by the total count."""

    def __init__(self):
        self.metrics: dict = {}

    def add(self, key: str, value):
        self.metrics[key] = self.metrics.get(key, 0.0) + value

    def add_dict(self, d: dict):
        for k, v in d.items():
            self.add(k, v)

    def __getitem__(self, key: str) -> float:
        return float(self.metrics.get(key, 0.0))

    def __contains__(self, key: str) -> bool:
        return key in self.metrics

    def items(self):
        return self.metrics.items()

    def normalize(self, count_key: str = "num") -> dict:
        count = float(self.metrics.get(count_key, 0.0))
        out = {}
        for k, v in self.metrics.items():
            if k == count_key:
                out[k] = count
            else:
                out[k] = float(v) / count if count else 0.0
        return out

    def __repr__(self):
        return f"Accumulator({ {k: float(v) for k, v in self.metrics.items()} })"
