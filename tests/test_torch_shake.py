"""The port's shake regularizers and model noise (``fast_autoaugment_tpu_torch.
ops.shake``) against the JAX package's ``ops/shake.py``, on the CPU.

Oracles and bounds:

- ``shake_shake`` and ``shake_drop`` (both gate values): the forward and
  the VJP against ``jax.vjp`` of the JAX custom-VJP primitives on the same
  numpy inputs, bitwise (each side rounds the same products and sums once:
  eager JAX runs one XLA computation per operation, so nothing is fused into
  a multiply-add); the backward takes beta, not alpha (a run with the two
  swapped differs), and gives no gradient to the noise; the eval forms
  against ``shake_shake_eval`` and ``shake_drop_eval``, bitwise;
- the noise sites: numbered in registration order; train mode without
  noise raises, eval mode takes none; noise of the wrong kind raises;
- ``ModelNoise.draw``: a function of the keys (two draws equal bitwise),
  sites independent, each draw in its range, ShakeDrop's gate a 0-dim
  Bernoulli(1 - p) (its frequency over 4000 keys within 4 standard
  deviations), drop-connect's keep mask per sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fast_autoaugment_tpu.ops import shake as JS
from fast_autoaugment_tpu_torch.ops import rng
from fast_autoaugment_tpu_torch.ops import shake as S


def _inputs(seed, shape=(4, 3, 5, 5)):
    g = np.random.default_rng(seed)
    b = shape[0]
    return (g.standard_normal(shape).astype(np.float32),
            g.standard_normal(shape).astype(np.float32),
            g.uniform(0, 1, (b, 1, 1, 1)).astype(np.float32),
            g.uniform(0, 1, (b, 1, 1, 1)).astype(np.float32),
            g.standard_normal(shape).astype(np.float32))


def _nhwc(a):
    return jnp.asarray(np.transpose(a, (0, 2, 3, 1)))


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def test_shake_shake_forward_and_vjp_match_jax_bitwise():
    x1, x2, alpha, beta, g = _inputs(0)
    ab = lambda a: jnp.asarray(a.reshape(-1, 1, 1, 1))  # noqa: E731
    want, vjp = jax.vjp(JS.shake_shake, _nhwc(x1), _nhwc(x2), ab(alpha), ab(beta))
    wg1, wg2, wga, wgb = vjp(_nhwc(g))
    t1, t2 = (torch.from_numpy(a).requires_grad_() for a in (x1, x2))
    ta, tb = torch.from_numpy(alpha).requires_grad_(), torch.from_numpy(beta).requires_grad_()
    out = S.shake_shake(t1, t2, ta, tb)
    out.backward(torch.from_numpy(g))
    assert np.array_equal(out.detach().numpy(), _nchw(want))
    assert np.array_equal(t1.grad.numpy(), _nchw(wg1))
    assert np.array_equal(t2.grad.numpy(), _nchw(wg2))
    assert ta.grad is None and tb.grad is None
    assert not np.asarray(wga).any() and not np.asarray(wgb).any()
    # the backward takes beta: with alpha and beta swapped the gradient moves
    t1.grad = None
    S.shake_shake(t1, t2, tb, ta).backward(torch.from_numpy(g))
    assert not np.array_equal(t1.grad.numpy(), _nchw(wg1))
    assert np.array_equal(t1.grad.numpy(), alpha * g)
    assert np.array_equal(S.shake_shake_eval(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(),
                          _nchw(JS.shake_shake_eval(_nhwc(x1), _nhwc(x2))))


@pytest.mark.parametrize("gate", [0.0, 1.0])
def test_shake_drop_forward_and_vjp_match_jax_bitwise(gate):
    x, _, alpha, beta, g = _inputs(1)
    alpha = alpha * 2 - 1  # U(-1, 1)
    ab = lambda a: jnp.asarray(a.reshape(-1, 1, 1, 1))  # noqa: E731
    want, vjp = jax.vjp(JS.shake_drop, _nhwc(x), jnp.float32(gate), ab(alpha), ab(beta))
    wgx, *rest = vjp(_nhwc(g))
    tx = torch.from_numpy(x).requires_grad_()
    out = S.shake_drop(tx, torch.tensor(gate), torch.from_numpy(alpha), torch.from_numpy(beta))
    out.backward(torch.from_numpy(g))
    assert np.array_equal(out.detach().numpy(), _nchw(want))
    assert np.array_equal(tx.grad.numpy(), _nchw(wgx))
    assert all(not np.asarray(r).any() for r in rest)
    if gate == 0.0:  # dropped: forward by alpha, backward by beta
        assert np.array_equal(tx.grad.numpy(), beta * g)
        assert not np.array_equal(tx.grad.numpy(), alpha * g)
    else:
        assert np.array_equal(out.detach().numpy(), x) and np.array_equal(tx.grad.numpy(), g)
    for p in (0.1, 0.5):
        assert np.array_equal(S.shake_drop_eval(torch.from_numpy(x), p).numpy(),
                              _nchw(JS.shake_drop_eval(_nhwc(x), p)))


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = S.NoiseSite("shake_shake")
        self.inner = nn.Sequential(S.NoiseSite("shake_drop", 0.3),
                                   S.NoiseSite("drop_connect", 0.2))
        self.head = S.NoiseSite("dropout", 0.25, width=6)
        S.number_noise_sites(self)


def test_sites_are_numbered_in_registration_order_and_need_noise_in_train_mode():
    toy = _Toy()
    assert [(s.site, s.kind) for s in S.noise_sites(toy)] == [
        (0, "shake_shake"), (1, "shake_drop"), (2, "drop_connect"), (3, "dropout")]
    x = torch.ones(2, 3, 4, 4)
    with pytest.raises(ValueError, match="noise"):
        toy.a(x, x)
    noise = S.ModelNoise.draw(S.noise_sites(toy), 2, torch.tensor([0, 1]), torch.tensor([0, 2]))
    toy.a(x, x, noise=noise)
    wrong = S.ModelNoise(noise.tensors[::-1], noise.kinds[::-1])
    with pytest.raises(ValueError, match="site 0"):
        toy.a(x, x, noise=wrong)
    toy.eval()
    assert torch.equal(toy.a(x, 2 * x), 1.5 * x)
    assert torch.equal(toy.inner[0](x), 0.7 * x)
    assert torch.equal(toy.inner[1](x), x * 0.8)
    assert torch.equal(toy.head(x[:, :, 0, 0]), x[:, :, 0, 0])


def test_model_noise_draws_are_a_function_of_the_keys():
    toy = _Toy()
    sites = S.noise_sites(toy)
    b = 64
    draw = lambda ks, kd: S.ModelNoise.draw(sites, b, torch.tensor(ks), torch.tensor(kd))  # noqa
    n1, n2, n3 = draw([3, 4], [5, 6]), draw([3, 4], [5, 6]), draw([3, 5], [5, 6])
    for t1, t2 in zip(n1.tensors, n2.tensors):
        assert all(torch.equal(a, c) for a, c in zip(t1, t2))
    assert not torch.equal(n1.tensors[0][0], n3.tensors[0][0])
    assert torch.equal(n1.tensors[3][0], n3.tensors[3][0])  # dropout: key_drop alone
    alpha, beta = n1.tensors[0]
    assert alpha.shape == (b, 1, 1, 1) and not torch.equal(alpha, beta)
    assert float(alpha.min()) >= 0 and float(alpha.max()) < 1
    gate, a2, b2 = n1.tensors[1]
    assert gate.shape == () and float(gate) in (0.0, 1.0)
    assert -1 <= float(a2.min()) < 0 < float(a2.max()) < 1 and float(b2.min()) >= 0
    assert not torch.equal(a2.abs(), alpha)  # another site, other draws
    (keep,) = n1.tensors[2]
    assert keep.shape == (b, 1, 1, 1) and set(keep.flatten().tolist()) <= {0.0, 1.0}
    (mask,) = n1.tensors[3]
    assert mask.shape == (b, 6) and mask.dtype == torch.bool
    # ShakeDrop's gate is Bernoulli(1 - p): its frequency over many keys
    n = 4000
    keys = rng.fold_in_range(torch.tensor([9, 9]), n)
    one = [s for s in sites if s.kind == "shake_drop"]
    w = rng.blocks(torch.stack([rng.fold_in(k, one[0].site) for k in keys]), 1, S._STREAM_SITE)
    gates = (rng.uniform24(w[3][:, 0]) < 0.7).double()
    sd = (0.7 * 0.3 / n) ** 0.5
    assert abs(float(gates.mean()) - 0.7) < 4 * sd
    # ... and ModelNoise.draw takes its gate from those words
    got = S.ModelNoise.draw(sites, 1, keys[0], keys[0]).tensors[1][0]
    assert float(got) == float(gates[0])
