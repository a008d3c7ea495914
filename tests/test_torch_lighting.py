"""The ImageNet stack's lighting normals (``ops/augment.py sample_imagenet``,
``ops/rng.py log_unit``, ``cos_sin_turn``): built only from correctly rounded float64
operations, so that the CPU and the card give the same bits.

The oracle is numpy's float64 ``log``, ``cos`` and ``sin`` on the same
Philox words (the JAX draws are not one: the port does not reproduce
threefry).  Bounds:

- ``log_unit(k) = ln(k 2^-24)``: within 2^-50 relative, for every k of a
  stride through [1, 2^24] and the ends;
- ``cos_sin_turn(j)``: within 2^-50 absolute of ``cos``/``sin`` of the
  float64 angle ``2 pi j 2^-24``, whose own rounding is up to 2^-51 x 2 pi;
- the float32 normals x 0.1 of 2^20 lanes: within 4 float32 ulp of the
  float64 Box-Muller value, plus 2^-49 x radius x 0.1 for the reference's
  rounding of its angle (a value near 0 has a tiny ulp).

The card check (the same 2^20 keys on the CPU and the card, ``ints`` and
``floats`` bitwise) is ``chip_smoke.py``'s ``lighting_cpu_vs_card`` phase
and ``tests/test_torch_kernels.py``.
"""

import numpy as np
import torch

from fast_autoaugment_tpu_torch.ops import augment as A
from fast_autoaugment_tpu_torch.ops.rng import cos_sin_turn, log_unit, philox4x32

LANES = 1 << 20


def test_log_unit_against_float64():
    k = torch.cat([torch.arange(1, 1 << 24, 17, dtype=torch.int64),
                   torch.tensor([1, 2, 3, (1 << 24) - 1, 1 << 24])])
    got = log_unit(k).numpy()
    want = np.log(k.numpy() * 2.0**-24)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 2.0**-24)
    assert rel.max() <= 2.0**-50, rel.max()
    assert got[-1] == 0.0  # ln 1


def test_cos_sin_turn_against_float64():
    j = torch.cat([torch.arange(0, 1 << 24, 13, dtype=torch.int64),
                   torch.tensor([1 << 22, 1 << 23, 3 << 22, (1 << 24) - 1])])
    c, s = cos_sin_turn(j)
    theta = 2 * np.pi * j.numpy() * 2.0**-24
    assert np.abs(c.numpy() - np.cos(theta)).max() <= 2.0**-50
    assert np.abs(s.numpy() - np.sin(theta)).max() <= 2.0**-50
    # exact quarter turns
    assert c[-4:-1].tolist() == [0.0, -1.0, 0.0] and s[-4:-1].tolist() == [1.0, 0.0, -1.0]


def test_lighting_normals_against_float64_box_muller():
    keys = torch.stack([torch.full((LANES,), 7, dtype=torch.int64),
                        torch.arange(LANES, dtype=torch.int64)], dim=1)
    ints, floats = A.sample_imagenet(keys, 224, 224)
    assert floats.dtype == torch.float32 and floats.shape == (LANES, 6)
    got = floats[:, 3:].numpy()
    # the same Philox words, float64 numpy Box-Muller
    block = torch.arange(3, dtype=torch.int64)
    zero = torch.zeros_like(block)
    w = [x[:, 2].numpy() >> 8 for x in philox4x32((keys[:, 1:2], keys[:, 0:1]),
                                                   (block, zero + 5, zero, zero))]
    r0 = np.sqrt(-2.0 * np.log(1.0 - w[0] * 2.0**-24))
    r1 = np.sqrt(-2.0 * np.log(1.0 - w[2] * 2.0**-24))
    t0, t1 = 2 * np.pi * w[1] * 2.0**-24, 2 * np.pi * w[3] * 2.0**-24
    want = np.stack([r0 * np.cos(t0), r0 * np.sin(t0), r1 * np.cos(t1)], axis=1) * 0.1
    radius = np.stack([r0, r0, r1], axis=1) * 0.1
    bound = 4 * np.spacing(np.abs(want).astype(np.float32)).astype(np.float64) \
        + 2.0**-49 * radius
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), (err / bound).max()
    ulps = err / np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.median(ulps) <= 0.5  # rounded once: most are the nearest float32
    assert abs(float(got.std()) - 0.1) < 1e-3 and abs(float(got.mean())) < 1e-3


def test_lighting_draws_are_a_function_of_the_key_alone():
    keys = torch.stack([torch.arange(64, dtype=torch.int64), torch.arange(64) * 3], dim=1)
    ints, floats = A.sample_imagenet(keys, 17, 23)
    ints2, floats2 = A.sample_imagenet(keys[10:20], 17, 23)
    assert torch.equal(ints[10:20], ints2) and torch.equal(floats[10:20], floats2)
    assert torch.isfinite(floats).all()
