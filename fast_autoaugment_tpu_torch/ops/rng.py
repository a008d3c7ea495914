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

The float draws that are not uniforms (the ImageNet lighting normals, the
Beta of mixup) are built from correctly rounded float64 operations only:
each +, -, x and / is its own torch op, and log, exp, cos and sin are
fixed polynomials after a range reduction that is exact.  Library ``log``,
``exp`` and ``pow`` are not correctly rounded and differ between the CPU and
the card, so they are not used; nor is the CPU's ``sqrt`` on float64 (a
vector library's, an ulp off on about 1% of values), which
:func:`sqrt_f64` rounds correctly.
"""

from __future__ import annotations

import math

import torch

__all__ = ["philox4x32", "uniform24", "fold_in", "fold_in_range", "split", "blocks",
           "MASK32", "log_unit", "cos_sin_turn", "log_f64", "exp_f64", "sqrt_f64", "normal_f64",
           "gamma_log", "beta_symmetric", "permutation", "BETA_CANDIDATES"]

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


def fold_in(key: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """A fresh key derived from ``key`` ``[..., 2]`` and an integer (one
    Philox block at counter ``(data, "Fold", 0, 0)``); same shape as `key`.
    `data` may be a 0-dim integer tensor on the key's device, so that a
    captured CUDA graph reads it at replay time."""
    key = key.to(torch.int64)
    if torch.is_tensor(data):
        data_t = data.to(device=key.device, dtype=torch.int64) & MASK32
    else:
        data_t = torch.full((), int(data) & MASK32, dtype=torch.int64, device=key.device)
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


def fold_in_range(key: torch.Tensor, num: int) -> torch.Tensor:
    """``fold_in(key, i)`` for ``i`` in ``range(num)``: ``[2]`` -> ``[num, 2]``."""
    key = key.to(torch.int64).reshape(2)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    zero = torch.zeros_like(i)
    w = philox4x32((key[0], key[1]), (i, zero + 0x466F6C64, zero, zero))
    return torch.stack([w[0], w[1]], dim=-1)


def blocks(keys: torch.Tensor, num: int, stream: int) -> list[torch.Tensor]:
    """Philox blocks ``j`` in ``range(num)`` of stream `stream` under each key
    of ``keys [..., 2]``: four int64 tensors of 32-bit words, ``[..., num]``
    (counter ``(j, stream, 0, 0)``)."""
    keys = keys.to(torch.int64)
    j = torch.arange(num, dtype=torch.int64, device=keys.device)
    zero = torch.zeros_like(j)
    return philox4x32((keys[..., 0:1], keys[..., 1:2]), (j, zero + stream, zero, zero))


# Box-Muller from correctly rounded float64 operations only: every +, -, x
# and / below is its own torch op (no op that a compiler may contract
# into a fused multiply-add, no division by a scalar, which CUDA turns into
# a product with its reciprocal), so the CPU and the card round each one the
# same way and give the same bits.  log and cos/sin are fixed polynomials
# after a range reduction that is exact on the integer draws.
_LN2 = 0.6931471805599453  # ln 2 rounded to float64
_SQRT2 = 1.4142135623730951
_HALF_PI = 1.5707963267948966
# ln m = 2 atanh(s), s = (m - 1) / (m + 1): 2 s sum_i s^(2i) / (2i + 1); |s| <= 0.172
# on [sqrt(1/2), sqrt(2)], so 12 terms leave a relative error below 2^-60
_ATANH = [1.0 / (2 * i + 1) for i in range(12)]
# sin a = a sum_i (-1)^i a^(2i) / (2i + 1)!, cos a = sum_i (-1)^i a^(2i) / (2i)!
# on [0, pi/4]: 10 terms each leave an error below 2^-60
_SIN = [(-1.0) ** i / math.factorial(2 * i + 1) for i in range(10)]
_COS = [(-1.0) ** i / math.factorial(2 * i) for i in range(10)]


def _horner(z: torch.Tensor, coeffs: list[float]) -> torch.Tensor:
    """``sum_i coeffs[i] * z^i``, one product and one sum per step."""
    p = torch.full_like(z, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        p = p * z
        p = p + c
    return p


def log_unit(k: torch.Tensor) -> torch.Tensor:
    """``ln(k * 2^-24)`` in float64 for int64 ``k`` in ``[1, 2^24]``
    (:func:`log_f64`; the product is exact)."""
    return log_f64(k.to(torch.float64) * 2.0**-24)


def cos_sin_turn(j: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of the angle ``2 pi j 2^-24`` in float64, for int64 ``j``
    in ``[0, 2^24)``.  The quadrant and the reflection to ``[0, pi/4]`` are
    taken on the integer ``j``, exactly."""
    q = j >> 22
    x = (j & (2**22 - 1)).to(torch.float64) * 2.0**-22  # the turn within the quadrant
    refl = x > 0.5
    a = torch.where(refl, 1.0 - x, x) * _HALF_PI  # [0, pi/4]
    z = a * a
    s = _horner(z, _SIN) * a
    c = _horner(z, _COS)
    s, c = torch.where(refl, c, s), torch.where(refl, s, c)  # pi/2 - a for the upper half
    cos = torch.where(q == 0, c, torch.where(q == 1, -s, torch.where(q == 2, -c, s)))
    sin = torch.where(q == 0, s, torch.where(q == 1, c, torch.where(q == 2, -s, -c)))
    return cos, sin


def log_f64(v: torch.Tensor) -> torch.Tensor:
    """``ln v`` for positive normal float64 ``v``: ``v = m 2^e`` with ``m`` in
    ``[sqrt(1/2), sqrt(2))``, read from the bits and halved where needed
    (exact), then ``ln v = e ln 2 + 2 atanh(s)``, ``s = (m - 1) / (m + 1)``."""
    bits = v.to(torch.float64).contiguous().view(torch.int64)
    e = (bits >> 52) - 1023
    m = ((bits & ((1 << 52) - 1)) | (1023 << 52)).view(torch.float64)  # [1, 2)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int64)
    s = (m - 1.0) / (m + 1.0)
    log_m = _horner(s * s, _ATANH) * s
    log_m = log_m * 2.0
    return e.to(torch.float64) * _LN2 + log_m


# exp z = 2^k exp r with k = round(z / ln 2) and r = z - k ln 2 in two parts
# (Cody and Waite: k * _LN2_HI is exact for |k| < 2^11); |r| <= 0.347, where
# 19 Taylor terms leave a relative error below 2^-80
_INV_LN2 = 1.4426950408889634
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_EXP = [1.0 / math.factorial(i) for i in range(19)]
_EXP_RANGE = 700.0  # exp_f64 saturates outside it (2^k stays a normal float64)


def exp_f64(z: torch.Tensor) -> torch.Tensor:
    """``exp z`` in float64 for ``z`` clamped to ``[-700, 700]``; ``2^k`` is
    made from its bits."""
    z = torch.clamp(z, -_EXP_RANGE, _EXP_RANGE)
    k = torch.round(z * _INV_LN2)
    r = z - k * _LN2_HI
    r = r - k * _LN2_LO
    scale = ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    return _horner(r, _EXP) * scale


_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitting constant


def _above_product(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x > a b`` decided exactly, for float64 with ``a b`` within a factor
    of 2 of ``x`` and below 2^900: ``a b = p + e`` exactly by Dekker's product
    on Veltkamp's halves, and ``x - p`` is exact (Sterbenz)."""
    ca, cb = a * _SPLIT, b * _SPLIT
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    p = a * b
    e = ah * bh - p
    e = e + ah * bl
    e = e + al * bh
    e = e + al * bl
    return x - p > e


def sqrt_f64(x: torch.Tensor) -> torch.Tensor:
    """``sqrt x`` correctly rounded, for float64 ``x`` zero or normal below
    2^900.  torch's root ``y`` is within an ulp of it on the CPU (exact on the
    card); Tuckerman's test picks the rounded root among ``y`` and its two
    neighbours: ``r = RN(sqrt x)`` exactly when ``r r- < x <= r r+``, with
    ``r-``, ``r+`` the doubles next to ``r`` and the products exact."""
    y = torch.sqrt(x)
    up = torch.nextafter(y, torch.full_like(y, math.inf))
    down = torch.nextafter(y, torch.zeros_like(y))
    to_up = _above_product(x, y, up)
    to_down = ~_above_product(x, down, y) & (y > 0)
    return torch.where(to_up, up, torch.where(to_down, down, y))


def normal_f64(w_radius: torch.Tensor, w_turn: torch.Tensor) -> torch.Tensor:
    """A standard normal per pair of 32-bit words, by Box-Muller: the radius
    from ``u = 1 - j 2^-24`` in (0, 1] (the top 24 bits of `w_radius`), the
    angle ``2 pi j' 2^-24`` (those of `w_turn`), cosine branch."""
    r = sqrt_f64(log_unit((1 << 24) - (w_radius >> 8)) * -2.0)
    return r * cos_sin_turn(w_turn >> 8)[0]


_STREAM_GAMMA, _STREAM_PERM = 7, 8
#: candidates of the Gamma sampler.  Marsaglia and Tsang's test accepts a
#: candidate with probability at least 0.9516 for every shape >= 1 (0.9634 at
#: the 1.2 of mixup alpha 0.2, boosted), measured over 2,000,000 numpy draws;
#: so none of 16 is accepted with probability below 1e-21 (about 1e-23 at
#: 1.2), and :func:`gamma_log` then fails loudly
BETA_CANDIDATES = 16


def gamma_log(keys: torch.Tensor, shape: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ln X, accepted)`` for ``X ~ Gamma(shape, 1)``, one per key of
    ``keys [..., 2]``, in float64: Marsaglia and Tsang's method ("A simple
    method for generating gamma variables", 2000) on ``shape + 1`` with the
    boost ``X = Y U^(1/shape)`` when ``shape < 1``.  Candidate ``j`` of a key
    is its Philox block ``j``: a normal from words 0 and 1, the acceptance
    uniform from word 2, the boost uniform from word 3; the first accepted
    candidate is taken.  ``accepted`` (bool, ``[...]``) is False where no
    candidate passed."""
    a = shape + 1.0 if shape < 1.0 else shape
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    w = blocks(keys, BETA_CANDIDATES, _STREAM_GAMMA)  # 4 x [..., candidates]
    x = normal_f64(w[0], w[1])
    v = x * c
    v = v + 1.0
    v3 = v * v
    v3 = v3 * v
    ok = v3 > 0.0
    v3 = torch.where(ok, v3, torch.ones_like(v3))
    rhs = x * x
    rhs = rhs * 0.5
    rhs = rhs + d
    rhs = rhs - v3 * d
    rhs = rhs + log_f64(v3) * d
    accept = ok & (log_unit((1 << 24) - (w[2] >> 8)) < rhs)
    first = torch.argmax(accept.to(torch.int32), dim=-1, keepdim=True)  # the first True
    log_x = log_f64(torch.gather(v3, -1, first)[..., 0] * d)
    if shape < 1.0:
        boost = log_unit((1 << 24) - (torch.gather(w[3], -1, first)[..., 0] >> 8))
        log_x = log_x + boost * (1.0 / shape)
    return log_x, accept.any(dim=-1)


def beta_symmetric(keys: torch.Tensor, alpha: float) -> torch.Tensor:
    """A ``Beta(alpha, alpha)`` draw per key of ``keys [..., 2]``, float64
    ``[...]`` on the keys' device: ``X / (X + Y)`` with ``X``, ``Y``
    Gamma(alpha) draws (:func:`gamma_log`) from the two keys of
    ``split(key, 2)``, formed as ``e^(ln X - m) / (e^(ln X - m) + e^(ln Y -
    m))`` with ``m`` the larger log (:func:`exp_f64`).  Raises
    (asynchronously on the card: a device-side assertion) where a Gamma
    accepted no candidate."""
    pair = split(keys, 2)
    lx, ok_x = gamma_log(pair[..., 0, :], alpha)
    ly, ok_y = gamma_log(pair[..., 1, :], alpha)
    torch._assert_async((ok_x & ok_y).all(), "the Beta sampler's Gamma accepted none of "
                                             f"its {BETA_CANDIDATES} candidates")
    m = torch.maximum(lx, ly)
    ex, ey = exp_f64(lx - m), exp_f64(ly - m)
    return ex / (ex + ey)


def permutation(key: torch.Tensor, num: int) -> torch.Tensor:
    """A random permutation of ``range(num)`` from a key ``[2]``: the stable
    sort order of ``num`` Philox words (int64, on the key's device)."""
    words = blocks(key.reshape(2), num, _STREAM_PERM)[0]
    return torch.sort(words, stable=True).indices
