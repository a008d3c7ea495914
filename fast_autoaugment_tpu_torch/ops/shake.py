"""The models' own noise: ShakeShake, ShakeDrop, drop-connect and dropout
(``fast_autoaugment_tpu/ops/shake.py``, ``models/efficientnet.py:154-161``).

ShakeShake (reference ``networks/shakeshake/shakeshake.py:9-26``) mixes two
branches with per-sample ``alpha ~ U(0, 1)`` in the forward pass and
back-propagates through a fresh per-sample ``beta ~ U(0, 1)``.  ShakeDrop
(reference ``networks/shakedrop.py:9-45``) gates a residual branch with one
Bernoulli draw per call; on "drop" it scales the forward by per-sample
``alpha ~ U(-1, 1)`` and the backward by a fresh ``beta ~ U(0, 1)``.  Both
are ``torch.autograd.Function``s that take their noise as tensors and
return no gradient for it.

**Noise sites.**  A model's noise sites are its :class:`NoiseSite` modules,
numbered by :func:`number_noise_sites` in module registration order
(``model.modules()``), which is also the order in which the forward reaches
them: ShakeResNet's ``s{stage}_{i}_mix`` modules, PyramidNet's
``block{idx}.shake_drop``, EfficientNet's ``block{idx}.drop_connect`` (the
blocks with an identity skip and a rate above 0) and then its head's
``dropout``.  In train mode a model takes its noise as an explicit argument,
``model(x, noise=noise)`` with ``noise`` a :class:`ModelNoise`: one tuple of
tensors per site, either drawn from the train step's keys
(:meth:`ModelNoise.draw`: site ``i`` draws from ``fold_in(key_shake, i)``,
the dropout site from ``fold_in(key_drop, i)``) or handed in by a caller (a
test replays the JAX package's draws this way).  Train mode without noise
raises; eval mode takes none and uses the expectations (``0.5 (x1 + x2)``,
``(1 - p) x``, ``x (1 - p)``, identity).

The draws are Philox (``ops/rng.py``) and integer or exact float arithmetic
only, so the same keys give the same bits on the CPU and on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from fast_autoaugment_tpu_torch.ops import rng

__all__ = ["ShakeShake", "ShakeDrop", "shake_shake", "shake_shake_eval", "shake_drop",
           "shake_drop_eval", "NoiseSite", "ModelNoise", "number_noise_sites", "noise_sites",
           "SITE_KINDS"]

#: the kinds of noise site and the tensors each takes: shake_shake (alpha,
#: beta) [B, 1, 1, 1]; shake_drop (gate [] , alpha, beta [B, 1, 1, 1]);
#: drop_connect (keep [B, 1, 1, 1] float); dropout (keep [B, C] bool)
SITE_KINDS = ("shake_shake", "shake_drop", "drop_connect", "dropout")
_STREAM_SITE, _STREAM_DROPOUT = 9, 10


class ShakeShake(torch.autograd.Function):
    """Forward ``alpha x1 + (1 - alpha) x2``; backward ``beta g``,
    ``(1 - beta) g``."""

    @staticmethod
    def forward(ctx, x1, x2, alpha, beta):
        ctx.save_for_backward(beta)
        return alpha * x1 + (1.0 - alpha) * x2

    @staticmethod
    def backward(ctx, g):
        (beta,) = ctx.saved_tensors
        return beta * g, (1.0 - beta) * g, None, None


class ShakeDrop(torch.autograd.Function):
    """Forward ``x`` where ``gate > 0.5``, else ``alpha x``; backward ``g``
    or ``beta g``.  ``gate`` is a 0-dim tensor (one draw per call)."""

    @staticmethod
    def forward(ctx, x, gate, alpha, beta):
        keep = gate > 0.5
        ctx.save_for_backward(keep, beta)
        return torch.where(keep, x, alpha * x)

    @staticmethod
    def backward(ctx, g):
        keep, beta = ctx.saved_tensors
        return torch.where(keep, g, beta * g), None, None, None


def shake_shake(x1, x2, alpha, beta):
    return ShakeShake.apply(x1, x2, alpha, beta)


def shake_shake_eval(x1, x2):
    """Eval: the deterministic 0.5 mix (reference ``shakeshake.py:17``)."""
    return 0.5 * (x1 + x2)


def shake_drop(x, gate, alpha, beta):
    return ShakeDrop.apply(x, gate, alpha, beta)


def shake_drop_eval(x, p_drop: float):
    """Eval: the expectation ``(1 - p) x`` (reference ``shakedrop.py:22``)."""
    return (1.0 - p_drop) * x


class NoiseSite(nn.Module):
    """A place where a model draws noise in train mode: `kind` is one of
    :data:`SITE_KINDS`, `p` its rate (ShakeDrop's death rate, drop-connect's
    or dropout's rate), `width` a dropout's feature count.  ``site`` is set
    by :func:`number_noise_sites`."""

    def __init__(self, kind: str, p: float = 0.0, width: int = 0):
        super().__init__()
        if kind not in SITE_KINDS:
            raise ValueError(f"unknown noise site kind {kind!r}")
        self.kind, self.p, self.width, self.site = kind, float(p), int(width), -1

    def extra_repr(self) -> str:
        return f"kind={self.kind}, p={self.p}, site={self.site}"

    def tensors(self, noise: "ModelNoise | None") -> tuple:
        """This site's tensors of `noise` (train mode)."""
        if noise is None:
            raise ValueError(
                "a model with noise sites runs in train mode only with its noise: call "
                "model(x, noise=ModelNoise...) (train/steps.py draws it from the step's keys), "
                "or model.eval()")
        return noise.take(self)

    def forward(self, *xs, noise: "ModelNoise | None" = None):
        if self.kind == "shake_shake":
            x1, x2 = xs
            if not self.training:
                return shake_shake_eval(x1, x2)
            return shake_shake(x1, x2, *self.tensors(noise))
        (x,) = xs
        if self.kind == "shake_drop":
            if not self.training:
                return shake_drop_eval(x, self.p)
            return shake_drop(x, *self.tensors(noise))
        if self.kind == "drop_connect":
            # the reference's semantics (utils.py:92-99): no rescaling in train
            if not self.training:
                return x * (1.0 - self.p)
            (keep,) = self.tensors(noise)
            return x * keep
        if not self.training or self.p == 0.0:  # dropout
            return x
        (keep,) = self.tensors(noise)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def noise_sites(model: nn.Module) -> list[NoiseSite]:
    """The model's noise sites in registration order."""
    return [m for m in model.modules() if isinstance(m, NoiseSite)]


def number_noise_sites(model: nn.Module) -> list[NoiseSite]:
    """Number the model's noise sites 0, 1, ... in registration order."""
    sites = noise_sites(model)
    for i, m in enumerate(sites):
        m.site = i
    return sites


class ModelNoise:
    """One train step's noise: ``tensors[i]`` is the tuple of site ``i``
    (:data:`SITE_KINDS` says what each kind holds).  Build it from explicit
    tensors, or draw it with :meth:`draw`."""

    def __init__(self, tensors: Sequence[tuple], kinds: Sequence[str] | None = None):
        self.tensors = [tuple(t) for t in tensors]
        self.kinds = list(kinds) if kinds is not None else None

    def take(self, site: NoiseSite) -> tuple:
        if not 0 <= site.site < len(self.tensors):
            raise ValueError(f"noise for {len(self.tensors)} sites has no site {site.site} "
                             "(number_noise_sites numbers a model's sites)")
        if self.kinds is not None and self.kinds[site.site] != site.kind:
            raise ValueError(f"site {site.site} is {site.kind}, the noise holds "
                             f"{self.kinds[site.site]}")
        return self.tensors[site.site]

    @classmethod
    def draw(cls, sites: Sequence[NoiseSite], batch: int, key_shake,
             key_drop) -> "ModelNoise":
        """Every site's tensors from the step's ``key_shake`` and ``key_drop``
        (``[2]`` int64 tensors on the device to draw on).  Site ``i`` (not a
        dropout) uses Philox block ``b`` of ``fold_in(key_shake, i)`` for
        sample ``b``: ``u0``, ``u1`` from its words 0 and 1 give ShakeShake's
        (alpha, beta), ShakeDrop's (2 u0 - 1, u1) and drop-connect's keep
        ``u0 < 1 - p``; ShakeDrop's gate is ``u < 1 - p`` from word 3 of
        block 0.  A dropout site ``i`` draws a uniform per element from
        ``fold_in(key_drop, i)``.  The shake sites are drawn in one pass of
        the generator."""
        dev = key_shake.device
        out: list[tuple] = [()] * len(sites)
        shake = [s for s in sites if s.kind != "dropout"]
        if shake:
            # stacked views, not a list index (which would copy the list from
            # the host: no CUDA graph could capture that)
            every = rng.fold_in_range(key_shake, len(sites))
            keys = torch.stack([every[s.site] for s in shake])
            w = rng.blocks(keys, batch, _STREAM_SITE)  # 4 x [S, B]
            u0, u1 = rng.uniform24(w[0]), rng.uniform24(w[1])
            u3 = rng.uniform24(w[3][:, 0])
            for j, s in enumerate(shake):
                a, b = u0[j].reshape(batch, 1, 1, 1), u1[j].reshape(batch, 1, 1, 1)
                if s.kind == "shake_shake":
                    out[s.site] = (a, b)
                elif s.kind == "shake_drop":
                    gate = (u3[j] < 1.0 - s.p).to(torch.float32)
                    out[s.site] = (gate, a * 2.0 - 1.0, b)
                else:
                    out[s.site] = ((a < 1.0 - s.p).to(torch.float32),)
        for s in sites:
            if s.kind == "dropout":
                key = rng.fold_in(key_drop.to(dev), s.site)
                u = rng.uniform24(rng.blocks(key, batch * s.width, _STREAM_DROPOUT)[0])
                out[s.site] = ((u < 1.0 - s.p).reshape(batch, s.width),)
        return cls(out, [s.kind for s in sites])
