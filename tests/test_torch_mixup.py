"""The port's mixup (``core/metrics.py mixup_batch``, ``mixup_cross_entropy``)
and its draws (``ops/rng.py beta_symmetric``, ``permutation``,
``search/tta.py PhiloxDraws.mixup_draws``) against the JAX package and
against the distributions they sample, on the CPU.

Oracles and bounds:

- ``mixup_batch`` with the JAX draws (``lam`` and the permutation taken from
  the key as the JAX ``mixup_batch`` takes them) against the JAX
  ``mixup_batch``: the mixed batch, both label sets and ``lam`` bitwise;
  ``mixup_cross_entropy`` against the JAX one within 1e-6 relative;
- the Beta sampler at alpha = 0.2 (mixup's) and 1.0: the Kolmogorov-Smirnov
  test against ``scipy.stats.beta`` over 10,000 draws (float64, before the
  rounding to float32 that sends a share of 2^-25-close draws to 1.0), at a
  p-value above 0.001; ``mixup_draws``' ``lam`` that draw rounded once to
  float32; its Gamma at shapes 0.2, 1.0 and 2.5 the same way against
  ``scipy.stats.gamma``; every candidate set accepted somewhere;
- ``log_f64`` within 2^-50 relative of float64 ``log`` over 2^20 values
  across the float64 exponent range, ``exp_f64`` within 2^-50 relative of
  float64 ``exp`` on [-700, 700]; ``sqrt_f64`` bitwise equal to numpy's
  correctly rounded ``sqrt`` on the Box-Muller range, across the exponent
  range, on squares, their neighbours and powers of 2, and on signed zeros;
- ``permutation``: every index once, for batches up to 4096; the mixup
  draws a function of the key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from fast_autoaugment_tpu.core import metrics as JM
from fast_autoaugment_tpu_torch.core import metrics as M
from fast_autoaugment_tpu_torch.ops import rng
from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_batch_and_loss_match_jax(seed):
    g = np.random.default_rng(seed)
    images = g.standard_normal((16, 8, 8, 3)).astype(np.float32)
    labels = g.integers(0, 10, 16).astype(np.int32)
    logits = g.standard_normal((16, 10)).astype(np.float32)
    key = jax.random.PRNGKey(seed + 40)
    mixed, la, lb, lam = JM.mixup_batch(key, jnp.asarray(images), jnp.asarray(labels), 0.2)
    key_lam, key_perm = jax.random.split(key)
    raw = np.asarray(jax.random.beta(key_lam, 0.2, 0.2), np.float32)
    perm = np.array(jax.random.permutation(key_perm, 16))
    got = M.mixup_batch(torch.from_numpy(images), torch.from_numpy(labels).long(),
                        torch.tensor(raw), torch.from_numpy(perm).long())
    assert np.array_equal(got[0].numpy(), np.asarray(mixed))
    assert np.array_equal(got[1].numpy(), np.asarray(la))
    assert np.array_equal(got[2].numpy(), np.asarray(lb))
    assert float(got[3]) == float(lam) >= 0.5
    for eps in (0.0, 0.1):
        want = float(JM.mixup_cross_entropy(jnp.asarray(logits), la, lb, lam, eps))
        have = float(M.mixup_cross_entropy(torch.from_numpy(logits), got[1], got[2], got[3], eps))
        assert abs(have - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_beta_sampler_ks_against_scipy(alpha):
    keys = rng.fold_in_range(torch.tensor([0, 7]), 10_000)
    draws = rng.beta_symmetric(keys, alpha)
    assert draws.dtype == torch.float64
    draws = draws.numpy()
    assert ((draws >= 0) & (draws <= 1)).all()
    res = stats.kstest(draws, stats.beta(alpha, alpha).cdf)
    assert res.pvalue > 1e-3, res
    lam, perm = PhiloxDraws().mixup_draws(torch.tensor([0, 7]), 16, alpha, "cpu")
    key_lam = rng.split(torch.tensor([0, 7]), 2)[0]
    assert lam.dtype == torch.float32 and lam.shape == ()
    assert torch.equal(lam, rng.beta_symmetric(key_lam, alpha).float())
    assert sorted(perm.tolist()) == list(range(16))


@pytest.mark.parametrize("shape", [0.2, 1.0, 2.5])
def test_gamma_sampler_ks_against_scipy(shape):
    keys = rng.fold_in_range(torch.tensor([3, 1]), 10_000)
    log_x, accepted = rng.gamma_log(keys, shape)
    assert bool(accepted.all())
    res = stats.kstest(np.exp(log_x.numpy()), stats.gamma(shape).cdf)
    assert res.pvalue > 1e-3, res


def test_log_and_exp_from_rounded_operations():
    g = np.random.default_rng(0)
    v = np.exp(g.uniform(-700, 700, 1 << 20))
    got = rng.log_f64(torch.from_numpy(v)).numpy()
    want = np.log(v)
    assert (np.abs(got - want) <= 2.0**-50 * np.maximum(np.abs(want), 1.0)).all()
    z = np.concatenate([g.uniform(-700, 700, 1 << 18), g.uniform(-1, 1, 1 << 18), [0.0]])
    got = rng.exp_f64(torch.from_numpy(z)).numpy()
    assert (np.abs(got - np.exp(z)) <= 2.0**-50 * np.exp(z)).all()
    assert got[-1] == 1.0


def test_sqrt_correctly_rounded():
    g = np.random.default_rng(3)
    k = np.arange(1, 1 << 16, dtype=np.float64)
    x = np.concatenate([g.uniform(0, 40, 1 << 20), np.exp2(g.uniform(-1000, 899, 1 << 18)),
                        k * k, np.nextafter(k * k, np.inf), np.nextafter(k * k, 0),
                        np.exp2(np.arange(-1000, 899, dtype=np.float64)), [0.0, -0.0]])
    got = rng.sqrt_f64(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int64), np.sqrt(x).view(np.int64))


@pytest.mark.parametrize("n", [1, 7, 128, 4096])
def test_permutation_is_a_permutation(n):
    for k in range(3):
        p = rng.permutation(torch.tensor([k, 11]), n)
        assert p.dtype == torch.int64 and sorted(p.tolist()) == list(range(n))
    if n > 1:
        assert not torch.equal(rng.permutation(torch.tensor([0, 11]), n),
                               rng.permutation(torch.tensor([1, 11]), n))


def test_mixup_draws_are_a_function_of_the_key():
    src = PhiloxDraws()
    a = src.mixup_draws(torch.tensor([2, 3]), 32, 0.2, "cpu")
    b = src.mixup_draws(np.asarray([2, 3], np.uint32), 32, 0.2, "cpu")
    c = src.mixup_draws(torch.tensor([2, 4]), 32, 0.2, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])
    assert a[0].shape == () and a[0].dtype == torch.float32 and 0 <= float(a[0]) <= 1
    assert sorted(a[1].tolist()) == list(range(32))
