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
only, so the same keys give the same bits on the CPU and on the card: on
the CPU :meth:`ModelNoise.draw_plain`, on the card one launch of the
train-noise kernel (``csrc/sampler.cu noise_kernel``, K8) that writes every
site into one packed buffer (:class:`NoiseLayout`), whose views are the
sites' tensors.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from fast_autoaugment_tpu_torch.ops import _kernels, rng

__all__ = ["ShakeShake", "ShakeDrop", "shake_shake", "shake_shake_eval", "shake_drop",
           "shake_drop_eval", "NoiseSite", "ModelNoise", "NoiseLayout", "noise_layout",
           "number_noise_sites", "noise_sites", "SITE_KINDS"]

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


@dataclass(frozen=True)
class NoiseLayout:
    """Where one train step's noise lies in its packed byte buffer: the
    float32 tensors of the ShakeShake, ShakeDrop and drop-connect sites
    first (``float_bytes``), then the dropout sites' bool masks
    (``nbytes`` in all).  Per site, in site order: ``begin`` its first work
    item of the train-noise kernel (a sample, or a dropout element),
    ``out`` its first float or byte, ``meta`` its model site number ``|
    kind << 16`` and ``thr`` the float32 ``1 - p`` its uniforms are held
    against.  ``shake`` lists the shake sites' indices in `sites` and
    ``gather`` the packed floats' places in the plain version's source
    (:meth:`ModelNoise.draw_plain`)."""

    batch: int
    kinds: tuple
    widths: tuple
    count: int
    items: int
    float_bytes: int
    nbytes: int
    begin: np.ndarray
    out: np.ndarray
    meta: np.ndarray
    thr: np.ndarray
    shake: tuple
    gather: np.ndarray


@functools.lru_cache(maxsize=64)
def _layout(batch: int, kinds: tuple, numbers: tuple, ps: tuple, widths: tuple) -> NoiseLayout:
    b = batch
    begin, out, meta, thr = [], [], [], []
    items = floats = 0
    shake = [i for i, k in enumerate(kinds) if k != "dropout"]
    n_shake = len(shake)
    # the plain version's source, concatenated: u0 [S, B], u1 [S, B],
    # 2 u0 - 1 [S, B], keep [S, B], gate [S], over the S shake sites
    u0, u1, two, keep, gate = (k * n_shake * b for k in range(5))
    gather = []
    for i, kind in enumerate(kinds):
        begin.append(items)
        meta.append(numbers[i] | SITE_KINDS.index(kind) << 16)
        thr.append(np.float32(1.0 - ps[i]))
        if kind == "dropout":
            out.append(0)
            items += b * widths[i]
            continue
        j = shake.index(i)
        row = np.arange(b) + j * b
        out.append(floats)
        if kind == "shake_shake":
            gather += [u0 + row, u1 + row]
        elif kind == "shake_drop":
            gather += [np.asarray([gate + j]), two + row, u1 + row]
        else:
            gather += [keep + row]
        floats = sum(len(g) for g in gather)
        items += b
    bools = 4 * floats
    for i, kind in enumerate(kinds):
        if kind == "dropout":
            out[i] = bools
            bools += b * widths[i]
    as32 = lambda v, t: np.ascontiguousarray(v, t)  # noqa: E731
    return NoiseLayout(b, kinds, widths, len(kinds), items, 4 * floats, bools,
                       as32(begin, np.int32), as32(out, np.int32), as32(meta, np.int32),
                       as32(thr, np.float32), tuple(shake),
                       np.concatenate(gather).astype(np.int64) if gather else
                       np.zeros(0, np.int64))


def noise_layout(sites: Sequence[NoiseSite], batch: int) -> NoiseLayout:
    """The :class:`NoiseLayout` of `sites` over `batch` samples."""
    return _layout(int(batch), tuple(s.kind for s in sites), tuple(s.site for s in sites),
                   tuple(s.p for s in sites), tuple(s.width for s in sites))


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
        (``[2]`` int64 tensors on the device to draw on): on the CPU
        :meth:`draw_plain`, on CUDA one launch of the train-noise kernel
        (``csrc/sampler.cu noise_kernel``) into the packed buffer, the same
        bits."""
        if not _kernels.on_card(key_shake):
            return cls.draw_plain(sites, batch, key_shake, key_drop)
        lay = noise_layout(sites, batch)
        keys = [k.to(device=key_shake.device, dtype=torch.int64).reshape(2).contiguous()
                for k in (key_shake, key_drop)]
        packed = _kernels.train_noise(batch=batch, sites=lay, key_shake=keys[0],
                                      key_drop=keys[1])["packed"]
        return cls.from_packed(lay, packed)

    @classmethod
    def from_packed(cls, lay: NoiseLayout, packed: torch.Tensor) -> "ModelNoise":
        """The per-site tuples as views of the packed buffer."""
        b = lay.batch
        f = packed[:lay.float_bytes].view(torch.float32)
        out: list[tuple] = []
        for i, kind in enumerate(lay.kinds):
            o = int(lay.out[i])
            col = lambda k: f[o + k * b:o + (k + 1) * b].view(b, 1, 1, 1)  # noqa: E731
            if kind == "shake_shake":
                out.append((col(0), col(1)))
            elif kind == "shake_drop":
                o += 1
                out.append((f[o - 1:o].view(()), col(0), col(1)))
            elif kind == "drop_connect":
                out.append((col(0),))
            else:
                out.append((packed[o:o + b * lay.widths[i]].view(torch.bool)
                            .view(b, lay.widths[i]),))
        return cls(out, list(lay.kinds))

    @classmethod
    def draw_plain(cls, sites: Sequence[NoiseSite], batch: int, key_shake,
                   key_drop) -> "ModelNoise":
        """The plain version of :meth:`draw`, on any device.  Site ``i`` (not
        a dropout) uses Philox block ``b`` of ``fold_in(key_shake, i)`` for
        sample ``b``: ``u0``, ``u1`` from its words 0 and 1 give ShakeShake's
        (alpha, beta), ShakeDrop's (2 u0 - 1, u1) and drop-connect's keep
        ``u0 < 1 - p``; ShakeDrop's gate is ``u < 1 - p`` from word 3 of
        block 0.  A dropout site ``i`` draws a uniform per element from
        ``fold_in(key_drop, i)``.  The shake sites are drawn in one pass of
        the generator and gathered into the packed buffer at once."""
        dev = key_shake.device
        lay = noise_layout(sites, batch)
        packed = torch.empty((lay.nbytes,), dtype=torch.uint8, device=dev)
        if lay.shake:
            every = rng.fold_in_range_plain(key_shake, len(sites))
            keys = torch.stack([every[sites[i].site] for i in lay.shake])
            w = rng.blocks_plain(keys, batch, _STREAM_SITE)  # 4 x [S, B]
            u0, u1 = rng.uniform24(w[0]), rng.uniform24(w[1])
            u3 = rng.uniform24(w[3][:, 0])
            thr = torch.from_numpy(lay.thr[list(lay.shake)]).to(dev)
            source = torch.cat([u0.flatten(), u1.flatten(), (u0 * 2.0 - 1.0).flatten(),
                                (u0 < thr[:, None]).to(torch.float32).flatten(),
                                (u3 < thr).to(torch.float32)])
            packed[:lay.float_bytes].view(torch.float32).copy_(
                source[torch.from_numpy(lay.gather).to(dev)])
        for i, s in enumerate(sites):
            if s.kind == "dropout":
                key = rng.fold_in_plain(key_drop.to(dev), s.site)
                u = rng.uniform24(rng.blocks_plain(key, batch * s.width, _STREAM_DROPOUT)[0])
                o = int(lay.out[i])
                packed[o:o + u.numel()].view(torch.bool).copy_(u < 1.0 - s.p)
        return cls.from_packed(lay, packed)
