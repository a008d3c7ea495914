"""The port's ImageNet train and eval stacks (``fast_autoaugment_tpu_torch.
ops.preprocess_imagenet``) against the JAX package, on the CPU.

Oracles and bounds:

- ``imagenet_train_batch`` of the JAX package, compiled without fused
  multiply-add in reference processes (``test_torch_replay.
  jax_reference_groups``, one per case), against the port's plain stack given the draws the JAX
  key tree consumes (``test_torch_replay.jax_imagenet_draws``, drawn in the
  same process; ``jax_threefry_partitionable`` pinned to True, the jax
  default).  Keys are chosen so that every case covers all six ColorJitter
  orders with both flip bits; cases cover cutout 0 and 16, exact and
  grouped dispatch, no policy, the 498-sub-policy ImageNet archive and a
  one-sub-policy policy, at 4x32x32 and 3x17x23.  Bound: bitwise, except
  that an image whose drawn sub-policy has a gated-on Rotate slot may
  differ (torch's and XLA's float32 cos/sin differ in the last place;
  ``test_torch_augment.py`` bounds that op on its own);
- ``imagenet_eval_batch`` of the JAX package: bitwise over all 256 levels;
- the compiled forms of ``img / 255`` and ``(img01 - mean) / std``: XLA
  multiplies by the float32 reciprocals, bitwise, and the true divisions
  differ from that form;
- the kernel against the plain version: ``test_torch_kernels.py`` (needs
  the card).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops import augment as T
from fast_autoaugment_tpu_torch.ops import preprocess as P
from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as PI
from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws
from test_torch_replay import imagenet_draws_to_torch, jax_imagenet_draws, jax_reference_groups

PARTITIONABLE = True
FA_IMAGENET = policy_to_tensor(load_policy("fa_resnet50_rimagenet"))  # 498 x 2
SINGLE = np.float32([[[12, 0.9, 0.7], [10, 0.8, 0.3]]])  # brightness, contrast

# (name, dispatch, policy, batch, h, w, cutout, groups)
CASES = [
    ("exact_fa_imagenet_cutout16", "exact", FA_IMAGENET, 4, 32, 32, 16, 8),
    ("grouped_fa_imagenet", "grouped", FA_IMAGENET, 4, 32, 32, 0, 3),
    ("grouped_single_sub_odd_cutout16", "grouped", SINGLE, 3, 17, 23, 16, 8),
    ("exact_no_policy_odd", "exact", None, 3, 17, 23, 0, 8),
    ("exact_no_policy_cutout16", "exact", None, 4, 32, 32, 16, 8),
]


def _images(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def jax_case(job):
    """Reference runner for case ``job["index"]``: keys (from seed 1000 up)
    until its images cover all 12 (jitter order, flip) pairs, each key's
    draws and the JAX ``imagenet_train_batch`` output."""
    from fast_autoaugment_tpu.ops.preprocess_imagenet import imagenet_train_batch

    i = job["index"]
    _, dispatch, policy, b, h, w, cutout, groups = CASES[i]
    fn = jax.jit(functools.partial(imagenet_train_batch, cutout_length=cutout,
                                   aug_dispatch=dispatch, aug_groups=groups))
    shape = None if policy is None else policy.shape[:2]
    covered, calls = set(), []
    for seed in range(1000, 1200):
        key = np.asarray(jax.random.PRNGKey(seed), np.uint32)
        d = jax_imagenet_draws(key, b, shape, h, w, dispatch, groups)
        new = set(zip(d["order"].tolist(), d["flip"].tolist())) - covered
        if not new:
            continue
        covered |= new
        images = _images(seed + 100 * i, b, h, w)
        y = fn(jnp.asarray(images), jnp.asarray(key),
               None if policy is None else jnp.asarray(policy))
        calls.append((images, d, np.asarray(y)))
        if len(covered) == 12:
            break
    return calls


def jax_forms(job):
    """Reference runner: the compiled ``/255`` and normalization on every
    level, and ``imagenet_eval_batch``."""
    from fast_autoaugment_tpu.ops import preprocess as JP
    from fast_autoaugment_tpu.ops.preprocess_imagenet import imagenet_eval_batch

    out = {}
    levels = np.arange(256, dtype=np.float32)
    x = jnp.asarray(np.tile(levels[:, None], (1, 3)))
    out["div255"] = np.asarray(jax.jit(lambda v: v / 255.0)(x))
    mean = jnp.asarray(JP.IMAGENET_MEAN, jnp.float32)
    std = jnp.asarray(JP.IMAGENET_STD, jnp.float32)
    out["normalize01"] = np.asarray(jax.jit(lambda v: (v - mean) / std)(x / 256.0))
    out["eval"] = np.asarray(jax.jit(imagenet_eval_batch)(jnp.asarray(_levels())))
    return out


def _levels():
    return np.tile(np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1), (2, 1, 1, 3))


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    groups = [[{"runner": "test_torch_imagenet:jax_case", "index": i,
                "threefry_partitionable": PARTITIONABLE}] for i in range(len(CASES))]
    groups.append([{"runner": "test_torch_imagenet:jax_forms"}])
    out = jax_reference_groups(groups, tmp_path_factory.mktemp("imagenet"))
    return dict(out[-1][0], cases=[o[0] for o in out[:-1]])


def _has_gated_rotate(policy, sub, draws):
    rows = policy[sub]
    return bool(((rows[:, 0] == T.op_index("Rotate")) & (draws[:, 0] < rows[:, 1])).any())


@pytest.mark.parametrize("idx", range(len(CASES)), ids=[c[0] for c in CASES])
def test_imagenet_train_batch_bitwise_vs_jax(idx, refs):
    name, dispatch, policy, b, h, w, cutout, groups = CASES[idx]
    calls = refs["cases"][idx]
    pairs = set()
    compared = total = 0
    for images, d, want in calls:
        pairs |= set(zip(d["order"].tolist(), d["flip"].tolist()))
        draws = imagenet_draws_to_torch(d)
        got = PI.imagenet_train_batch(
            torch.from_numpy(images), draws, cutout_length=cutout,
            policy=None if policy is None else torch.from_numpy(policy))
        assert got.shape == (b, 3, h, w) and got.is_contiguous(memory_format=torch.channels_last)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        for i in range(b):
            total += 1
            if policy is not None and _has_gated_rotate(policy, d["sub_idx"][i], d["policy"][i]) \
                    and not np.array_equal(got[i], want[i]):
                continue  # Rotate's cos/sin, bounded in test_torch_augment.py
            assert np.array_equal(got[i], want[i]), (name, i, np.abs(got[i] - want[i]).max())
            compared += 1
    assert len(pairs) == 12, (name, sorted(pairs))  # all orders x both flip bits
    assert compared >= total - 1, name


def test_imagenet_eval_batch_bitwise_vs_jax(refs):
    got = PI.imagenet_eval_batch(torch.from_numpy(_levels())).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got, refs["eval"])


def test_scale_and_normalize_are_the_reciprocal_forms(refs):
    """XLA compiles ``img / 255`` and ``(img01 - mean) / std`` into
    multiplications by the float32 reciprocals; the true divisions differ
    from them, so the port (plain version and kernel) takes these forms."""
    levels = np.tile(np.arange(256, dtype=np.float32)[:, None], (1, 3))
    recip = levels * (np.float32(1) / np.float32(255))
    assert np.array_equal(refs["div255"], recip)
    assert int((levels / np.float32(255) != recip).sum()) > 0
    x01 = levels / np.float32(256)  # exact
    mean, std = np.float32(P.IMAGENET_MEAN), np.float32(P.IMAGENET_STD)
    rform = (x01 - mean) * (np.float32(1) / std)
    assert np.array_equal(refs["normalize01"], rform)
    assert int(((x01 - mean) / std != rform).sum()) > 0


def _draws(n, h, w, seed, policy_shape=None, dispatch="exact"):
    return PhiloxDraws().imagenet_draws(torch.tensor([0, seed]), batch=n,
                                        policy_shape=policy_shape, height=h, width=w,
                                        dispatch=dispatch, groups=8, device="cpu")


def test_plain_stack_vs_numpy_per_image():
    """The plain stack, image by image, against a numpy transcription of
    ``_train_one`` after the policy, over every order and both flips."""
    h, w = 9, 11
    n = 24
    imgs = _images(5, n, h, w)
    d = _draws(n, h, w, 7)
    d.order = torch.arange(n, dtype=torch.int32) % 6
    d.flip = (torch.arange(n, dtype=torch.int32) // 6) % 2
    got = PI.imagenet_stack(torch.from_numpy(imgs), d, cutout_length=4).permute(0, 2, 3, 1)
    f32 = np.float32
    vec, val = PI.PCA_EIGVEC, PI.PCA_EIGVAL
    for i in range(n):
        x = imgs[i].astype(f32)
        if int(d.flip[i]):
            x = x[:, ::-1]

        def blend(deg, img, f):
            return np.clip(np.trunc(deg + (img - deg) * f), f32(0), f32(255)).astype(f32)

        def grey(v):
            ii = np.clip(v, 0, 255).astype(np.int32)
            return (ii[..., 0] * 19595 + ii[..., 1] * 38470 + ii[..., 2] * 7471 + 0x8000) >> 16

        fb, fc, fs = (f32(v) for v in d.factors[i].tolist())
        for op in PI.JITTER_ORDERS[int(d.order[i])]:
            if op == 0:
                x = blend(f32(0), x, fb)
            elif op == 1:
                m = np.trunc(f32(grey(x).sum()) / f32(h * w) + f32(0.5))
                x = blend(f32(m), x, fc)
            else:
                x = blend(grey(x)[..., None].astype(f32), x, fs)
        t = vec * d.alpha[i].numpy()[None, :] * val[None, :]
        rgb = t[:, 0] + t[:, 1] + t[:, 2]
        x = x * (f32(1) / f32(255)) + rgb
        x = (x - f32(P.IMAGENET_MEAN)) * (f32(1) / f32(P.IMAGENET_STD))
        cy, cx = (int(v) for v in d.centre[i])
        ys, xs = np.mgrid[0:h, 0:w]
        x = np.where(((ys >= cy - 2) & (ys < cy + 2) & (xs >= cx - 2) & (xs < cx + 2))[..., None],
                     f32(0), x)
        assert np.array_equal(got[i].numpy(), x.astype(f32)), i


def test_imagenet_draws_ranges_and_independence():
    d = _draws(4000, 17, 23, 3, policy_shape=(498, 2))
    assert d.flip.dtype == d.order.dtype == d.centre.dtype == torch.int32
    assert set(d.flip.tolist()) == {0, 1} and set(d.order.tolist()) == set(range(6))
    assert int(d.centre[:, 0].max()) == 16 and int(d.centre[:, 1].max()) == 22
    assert float(d.factors.min()) >= 0.6 and float(d.factors.max()) < 1.4
    assert abs(float(d.alpha.std()) - 0.1) < 0.005 and abs(float(d.alpha.mean())) < 0.005
    assert d.sub_idx.shape == (4000,) and d.policy.shape == (4000, 2, 4)
    # a lane's stack draws depend on its key alone: the first lanes of a
    # shorter batch are the same
    e = _draws(10, 17, 23, 3, policy_shape=(498, 2))
    assert torch.equal(e.factors, d.factors[:10]) and torch.equal(e.alpha, d.alpha[:10])
    g = _draws(10, 17, 23, 3, policy_shape=(498, 2), dispatch="grouped")
    assert not torch.equal(g.flip, e.flip)  # grouped splits the key first, as JAX does
    assert _draws(10, 17, 23, 3).sub_idx is None


def test_cpu_path_never_reaches_the_kernel_and_validates():
    _kernels.reset_launch_counts()
    imgs = torch.from_numpy(_images(3, 2, 8, 8))
    d = _draws(2, 8, 8, 1)
    PI.imagenet_stack(imgs, d)
    PI.imagenet_eval_batch(imgs)
    assert all(v == 0 for v in _kernels.launch_counts().values())
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA tensors only
        _kernels.imagenet_stack(imgs, torch.zeros((2, 4), dtype=torch.int32),
                                torch.zeros((2, 6)), cutout_length=0, scale=1 / 255,
                                mean=(0, 0, 0), rstd=(1, 1, 1))
    with pytest.raises(TypeError):
        PI.imagenet_stack(imgs.to(torch.int32), d)
    d.order = d.order.to(torch.int64)
    with pytest.raises(ValueError):
        PI.imagenet_stack(imgs, d)
    with pytest.raises(ValueError):
        PI.imagenet_train_batch(imgs, _draws(2, 8, 8, 1), policy=torch.zeros((1, 1, 3)))
