"""The port's CIFAR train/eval stacks (``fast_autoaugment_tpu_torch.ops.
preprocess``) against the JAX package, on the CPU.

Oracles and bounds:

- ``cifar_train_batch`` and ``cifar_eval_batch`` of the JAX package,
  compiled without fused multiply-add in one reference process
  (``test_torch_replay.jax_reference``), given the draws its key tree
  consumes (``test_torch_replay.jax_cifar_draws``), under ``exact`` and
  ``grouped`` dispatch: bitwise.  The one exception is the augmentation
  tests' Rotate bound: an image whose drawn sub-policy has a gated-on
  Rotate slot may differ, because torch's and XLA's float32 cos/sin differ
  in the last place (``test_torch_augment.py`` bounds that op on its own);
- ``normalize`` in the reciprocal form ``(x * (1/255) - mean) * (1/std)``,
  which is what XLA compiles the reference's divisions into: bitwise over
  all 256 levels x 3 channels; the true divisions differ from it;
- the plain stack over every crop offset and flip bit against a plain
  numpy pad/slice/flip/normalize/cutout: bitwise;
- the CUDA kernel against the plain version: ``test_torch_kernels.py``
  (needs the card).
"""

import jax
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.ops import preprocess as JP
from fast_autoaugment_tpu_torch.ops import _kernels, rng
from fast_autoaugment_tpu_torch.ops import augment as T
from fast_autoaugment_tpu_torch.ops import preprocess as P
from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
from test_torch_replay import jax_cifar_draws, jax_reference

FA_CIFAR = policy_to_tensor(load_policy("fa_reduced_cifar10"))  # 493 x 2
SINGLE = np.float32([[[13, 0.9, 0.7], [14, 0.8, 0.4]]])  # sharpness, cutout

# (name, dispatch, policy, batch, h, w, cutout, groups)
CASES = [
    ("exact_fa_cifar", "exact", FA_CIFAR, 8, 32, 32, 16, 8),
    ("grouped_fa_cifar", "grouped", FA_CIFAR, 8, 32, 32, 16, 3),
    ("grouped_single_sub", "grouped", SINGLE, 6, 32, 32, 16, 8),
    ("exact_single_sub", "exact", SINGLE, 6, 32, 32, 16, 8),
    ("exact_no_policy_odd", "exact", None, 6, 17, 23, 0, 8),
    ("exact_no_policy_cutout", "exact", None, 16, 32, 32, 16, 8),
    ("grouped_no_policy_cutout7", "grouped", None, 5, 17, 23, 7, 8),
]


def _images(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _case_inputs(i, case):
    _, _, policy, b, h, w, _, _ = case
    return _images(100 + i, b, h, w), np.asarray(jax.random.PRNGKey(40 + i), np.uint32), policy


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Every case's JAX output, and ``cifar_eval_batch`` of an image that
    holds all 256 levels in each channel, from one FMA-free JAX process."""
    jobs = [{"kind": "cifar_train_batch", "cutout_length": c[6], "dispatch": c[1],
             "groups": c[7], "calls": [_case_inputs(i, c)]} for i, c in enumerate(CASES)]
    jobs.append({"kind": "cifar_eval_batch", "images": _levels()})
    out = jax_reference(jobs, tmp_path_factory.mktemp("pre"))
    return {"train": [o[0] for o in out[:-1]], "eval": out[-1]}


def _levels():
    return np.tile(np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1), (1, 1, 1, 3))


def _has_gated_rotate(policy, sub, draws):
    rows = policy[sub]
    return bool(((rows[:, 0] == T.op_index("Rotate")) & (draws[:, 0] < rows[:, 1])).any())


def test_constants_match_jax():
    assert P.CIFAR_MEAN == JP.CIFAR_MEAN and P.CIFAR_STD == JP.CIFAR_STD


@pytest.mark.parametrize("idx", range(len(CASES)), ids=[c[0] for c in CASES])
def test_cifar_train_batch_bitwise_vs_jax(idx, refs):
    name, dispatch, policy, b, h, w, cutout, groups = CASES[idx]
    images, key, _ = _case_inputs(idx, CASES[idx])
    shape = None if policy is None else policy.shape[:2]
    sub, draws, crop = jax_cifar_draws(key, b, shape, h, w, dispatch, groups)
    kwargs = {}
    if policy is not None:
        kwargs = dict(policy=torch.from_numpy(policy), sub_idx=torch.from_numpy(sub),
                      policy_draws=torch.from_numpy(draws))
    got = P.cifar_train_batch(torch.from_numpy(images), torch.from_numpy(crop),
                              cutout_length=cutout, **kwargs)
    assert got.shape == (b, 3, h, w) and got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).numpy()
    want = refs["train"][idx]
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    compared = 0
    for i in range(b):
        if policy is not None and _has_gated_rotate(policy, sub[i], draws[i]) \
                and not np.array_equal(got[i], want[i]):
            continue  # Rotate's cos/sin, bounded in test_torch_augment.py
        assert np.array_equal(got[i], want[i]), (name, i)
        compared += 1
    assert compared >= b - 1, name


def test_cifar_eval_batch_bitwise_vs_jax(refs):
    got = P.cifar_eval_batch(torch.from_numpy(_levels())).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got, refs["eval"])


def test_normalize_is_the_reciprocal_form():
    """The compiled reference divides by multiplying with reciprocals; the
    true divisions differ from it in the last place for most levels."""
    x = np.tile(np.arange(256, dtype=np.float32)[:, None], (1, 3)).reshape(1, 16, 16, 3)
    mean, std = np.float32(P.CIFAR_MEAN), np.float32(P.CIFAR_STD)
    recip = (x * (np.float32(1) / np.float32(255)) - mean) * (np.float32(1) / std)
    div = (x / np.float32(255) - mean) / std
    got = P.normalize(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, recip)
    assert int((recip != div).sum()) == 431


def _numpy_stack(img, oy, ox, flip, cy, cx, length, pad=4):
    h, w, _ = img.shape
    padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)))
    x = padded[oy:oy + h, ox:ox + w]
    if flip:
        x = x[:, ::-1]
    mean, std = np.float32(P.CIFAR_MEAN), np.float32(P.CIFAR_STD)
    x = (x * (np.float32(1) / np.float32(255)) - mean) * (np.float32(1) / std)
    ys, xs = np.mgrid[0:h, 0:w]
    half = length // 2
    inside = (ys >= cy - half) & (ys < cy + half) & (xs >= cx - half) & (xs < cx + half)
    return np.where(inside[..., None], np.float32(0), x).astype(np.float32)


@pytest.mark.parametrize("h,w,length", [(32, 32, 16), (17, 23, 16), (32, 32, 0)])
def test_stack_every_offset_flip_and_corner_vs_numpy(h, w, length):
    """All 9x9 crop offsets x both flip bits, with cutout centres at the
    corners, the edges and inside."""
    centres = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (h // 2, 0),
               (0, w // 2), (h // 2, w // 2), (3, w - 2)]
    rows = [(oy, ox, f, *centres[(oy * 9 + ox + f) % len(centres)])
            for oy in range(9) for ox in range(9) for f in (0, 1)]
    draws = np.int32(rows)
    img = _images(7, 1, h, w)[0].astype(np.float32)
    images = np.repeat(img[None], len(rows), axis=0)
    got = P.cifar_stack(torch.from_numpy(images), torch.from_numpy(draws),
                        cutout_length=length).permute(0, 2, 3, 1).numpy()
    for i, r in enumerate(rows):
        assert np.array_equal(got[i], _numpy_stack(img, *r, length)), r
    # a pad pixel is zero before normalization: -mean/std after it
    corner = P.cifar_stack(torch.from_numpy(images[:1]), torch.zeros((1, 5), dtype=torch.int32),
                           cutout_length=0).permute(0, 2, 3, 1).numpy()[0, 0, 0]
    mean, std = np.float32(P.CIFAR_MEAN), np.float32(P.CIFAR_STD)
    assert np.array_equal(corner, (np.float32(0) - mean) * (np.float32(1) / std))


def test_cpu_path_never_reaches_the_kernel():
    _kernels.reset_launch_counts()
    images = torch.from_numpy(_images(3, 4, 8, 8).astype(np.float32))
    P.cifar_stack(images, P.eval_draws(4, "cpu"))
    P.cifar_eval_batch(images)
    assert _kernels.launch_counts()["cifar_stack"] == 0
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA tensors only
        _kernels.cifar_stack(images, P.eval_draws(4, "cpu"), pad=4, cutout_length=0,
                             scale=1 / 255, mean=(0, 0, 0), rstd=(1, 1, 1))


def test_stack_validates_inputs():
    images = torch.zeros((2, 8, 8, 3))
    with pytest.raises(TypeError):
        P.cifar_stack(images, torch.zeros((2, 5)))  # float draws
    with pytest.raises(ValueError):
        P.cifar_stack(images, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        P.cifar_stack(images[..., :2], torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        P.cifar_stack(images.to("meta"), torch.zeros((2, 5), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        P.cifar_train_batch(images, torch.zeros((2, 5), dtype=torch.int32),
                            policy=torch.zeros((1, 1, 3)))  # a policy without draws


def test_sample_crop_ranges_and_lane_independence():
    keys = rng.split(torch.tensor([5, 9]), 4000)
    d = T.sample_crop(keys, 17, 23)
    assert d.dtype == torch.int32 and d.shape == (4000, 5)
    lo, hi = d.min(0).values.tolist(), d.max(0).values.tolist()
    assert lo == [0, 0, 0, 0, 0] and hi == [8, 8, 1, 16, 22]
    assert torch.equal(T.sample_crop(keys[17:18], 17, 23), d[17:18])
    # every offset and both flip bits occur, near-uniformly
    assert len(torch.unique(d[:, 0] * 9 + d[:, 1])) == 81
    assert 0.45 < d[:, 2].float().mean().item() < 0.55
