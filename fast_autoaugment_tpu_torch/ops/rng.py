"""Counter-based random draws that are bit-identical on the CPU and the card.

The JAX package draws with ``jax.random`` (threefry) key trees.  The port
does not reproduce those streams.  It keeps the same *structure*: every
random number is a pure function of a 64-bit key and a counter, so a
lane's draws depend on nothing but its own key.

The generator is Philox4x32-10 (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC'11).  It is written with int64 torch ops only:
each 32x32-bit product is split into 16-bit halves so that no
intermediate leaves the int64 range.  Integer ops are exact on every
device, so the same key and counter give the same bits on the CPU and
on CUDA.

Uniforms are ``(word >> 8) * 2**-24``: 24 random bits, exactly
representable in float32, in ``[0, 1)``.
"""

from __future__ import annotations

import torch

__all__ = ["philox4x32", "uniform24", "fold_in", "split", "MASK32"]

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_ROUNDS = 10


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product ``a * b``.

    `a` is a 32-bit constant, `b` an int64 tensor of 32-bit words.  The
    product is built from two 16x32-bit partial products (< 2**48 each),
    so every intermediate fits in int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    p0 = b * a_lo
    p1 = b * a_hi
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (t >> 32), t & MASK32


def philox4x32(key: tuple[torch.Tensor, torch.Tensor],
               counter: tuple[torch.Tensor, ...]) -> list[torch.Tensor]:
    """Philox4x32-10 on broadcastable int64 tensors holding 32-bit words.

    ``key`` is ``(k0, k1)``, ``counter`` is ``(c0, c1, c2, c3)``; returns
    the four output words as int64 tensors in ``[0, 2**32)``."""
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    c0, c1, c2, c3 = (c & MASK32 for c in counter)
    for r in range(_ROUNDS):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def uniform24(word: torch.Tensor) -> torch.Tensor:
    """A 32-bit word -> float32 uniform in [0, 1) on 24 bits (exact)."""
    return (word >> 8).to(torch.float32) * (1.0 / (1 << 24))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A fresh key derived from ``key`` ``[..., 2]`` and an integer (one
    Philox block at counter ``(data, "Fold", 0, 0)``); same shape as `key`."""
    key = key.to(torch.int64)
    data_t = torch.full((), int(data) & MASK32, dtype=torch.int64,
                        device=key.device)
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    w = philox4x32((key[..., 0], key[..., 1]), (data_t, zero + 0x466F6C64, zero, zero))
    return torch.stack([w[0], w[1]], dim=-1)


def split(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``num`` fresh keys from each key: ``keys [..., 2]`` -> ``[..., num, 2]``.

    Key ``j`` of a key is one Philox block of that key at counter
    ``(j, "Splt", 0, 0)``, so it depends on the key and ``j`` alone."""
    keys = keys.to(torch.int64)
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    j = torch.arange(num, dtype=torch.int64, device=keys.device)
    zero = torch.zeros_like(j)
    w = philox4x32((k0, k1), (j, zero + 0x53706C74, zero, zero))
    return torch.stack([w[0], w[1]], dim=-1)
