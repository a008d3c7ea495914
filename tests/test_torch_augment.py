"""The port's augmentation (``fast_autoaugment_tpu_torch.ops``) against the
JAX package and PIL, on the CPU.

Oracles and bounds:

- each of the 19 ops against the JAX op called directly, as
  ``tests/test_augment_golden.py`` calls them: bitwise, except Rotate;
- Rotate: torch's and XLA's float32 ``cos``/``sin`` differ in the last
  place for a few percent of angles, which moves a source coordinate across
  a pixel edge only at near-ties.  Bound: at most 1% of an image's
  elements, in at most 2 of 48 images per size (measured: 0 at 32x32 and
  1 image of 400, 3 elements, at 17x23);
- the ops against PIL on the golden cases: bitwise, except AutoContrast
  within 1 (the JAX package's documented deviation, ``ops/augment.py:233``);
- ``apply_subpolicy_draws`` with replayed JAX draws against
  ``apply_policy`` compiled without fused multiply-add (as
  ``jit(apply_subpolicy)`` on the sub-policy and key that ``apply_policy``
  splits off; see ``test_torch_replay.py``): bitwise for every image whose drawn
  sub-policy has no gated-on Rotate slot (those carry Rotate's cos/sin
  reason);
- the Philox generator against its published known-answer vectors, and
  the samplers for bit-identical draws and their stratification contract;
- the CUDA kernel against the plain version: ``test_torch_kernels.py``
  (needs the card).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import PIL.ImageDraw
import PIL.ImageEnhance
import PIL.ImageOps
import pytest
import torch

from fast_autoaugment_tpu.ops import augment as A
from fast_autoaugment_tpu.policies.archive import ARCHIVES as JAX_ARCHIVES
from fast_autoaugment_tpu_torch.ops import _kernels, rng
from fast_autoaugment_tpu_torch.ops import augment as T
from fast_autoaugment_tpu_torch.policies.archive import ARCHIVES, load_policy, policy_to_tensor
from test_torch_replay import jax_policy_draws, jax_reference, random_policy, split_policy_key

KEY = jax.random.PRNGKey(0)
SIZES = [(32, 32), (17, 23)]
RANDOM_POLICY_SEEDS = (11, 12)


def _imgs(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3)).astype(np.float32)


def _values(op: int) -> np.ndarray:
    """A sweep of levels through the range table, both signs for mirrored ops."""
    lv = np.float32([0.0, 0.13, 0.5, 0.77, 1.0])
    v = np.float32(lv * (T._OP_HIGH[op] - T._OP_LOW[op]) + T._OP_LOW[op])
    return np.concatenate([v, -v[1:]]) if T._OP_MIRROR[op] else v


def _jax_centre(key, h, w):
    kx, ky = jax.random.split(key)
    return (float(jax.random.uniform(kx, (), minval=0.0, maxval=float(w))),
            float(jax.random.uniform(ky, (), minval=0.0, maxval=float(h))))


# ------------------------------------------------------------- op parity


def test_op_table_matches_jax():
    assert T.OP_NAMES == A.OP_NAMES and T.NUM_OPS == 19
    assert T.augment_list(False) == A.augment_list(False)
    assert T.augment_list(True) == A.augment_list(True)
    assert T.CUTOUT_COLOR == A.CUTOUT_COLOR
    assert np.array_equal(T._OP_LOW, A._OP_LOW) and np.array_equal(T._OP_HIGH, A._OP_HIGH)
    assert np.array_equal(T._OP_MIRROR, A._OP_MIRROR)
    assert [T.op_index(n) for n in T.OP_NAMES] == list(range(19))


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("op", [i for i in range(19) if A.OP_NAMES[i] != "Rotate"])
def test_op_bitwise_vs_jax(op, h, w):
    vals = _values(op)
    imgs = _imgs(op, len(vals), h, w)
    imgs[1] = imgs[1] // 4 + 64  # low dynamic range for the histogram ops
    keys = [jax.random.PRNGKey(100 + i) for i in range(len(vals))]
    centres = np.float32([_jax_centre(k, h, w) for k in keys])
    port_fn = getattr(T, A._OP_FNS[op].__name__)
    got = port_fn(torch.from_numpy(imgs), torch.from_numpy(vals),
                  torch.from_numpy(centres)).numpy()
    for i, v in enumerate(vals):
        want = np.asarray(A._OP_FNS[op](jnp.asarray(imgs[i]), jnp.float32(v), keys[i]))
        assert np.array_equal(got[i], want), (A.OP_NAMES[op], float(v))


@pytest.mark.parametrize("h,w", SIZES)
def test_rotate_vs_jax_within_cos_sin_bound(h, w):
    vals = np.random.default_rng(5).uniform(-30, 30, 48).astype(np.float32)
    imgs = _imgs(6, 48, h, w)
    got = T.rotate(torch.from_numpy(imgs), torch.from_numpy(vals)).numpy()
    diff = np.array([int((got[i] != np.asarray(A.rotate(jnp.asarray(imgs[i]), jnp.float32(v), KEY))).sum())
                     for i, v in enumerate(vals)])
    assert diff.max() <= 0.01 * h * w * 3, diff.max()
    assert (diff > 0).sum() <= 2, diff


def test_warp_given_jax_matrix_is_bitwise():
    """With the same 2x3 matrix the warp itself is exact: Rotate's only
    source of difference is the matrix (cos/sin)."""
    h, w = 17, 23
    vals = np.random.default_rng(7).uniform(-30, 30, 16).astype(np.float32)
    imgs = _imgs(8, 16, h, w)
    cx, cy = w / 2.0, h / 2.0
    mats = []
    for v in vals:
        rad = jnp.float32(v) * (np.pi / 180.0)
        ca, sa = jnp.cos(rad), jnp.sin(rad)
        mats.append([ca, -sa, cx - ca * cx + sa * cy, sa, ca, cy - sa * cx - ca * cy])
    mats = np.float32(mats)
    got = T._warp_affine_nearest(torch.from_numpy(imgs), torch.from_numpy(mats)).numpy()
    for i in range(16):
        want = A._warp_affine_nearest(jnp.asarray(imgs[i]), jnp.asarray(mats[i].reshape(2, 3)))
        assert np.array_equal(got[i], np.asarray(want))


# ------------------------------------------------------------ PIL parity


def _pil_check(got, pil_img, atol=0):
    diff = np.abs(np.asarray(got).astype(np.int32) - np.asarray(pil_img).astype(np.int32))
    assert diff.max() <= atol, diff.max()


def _one(fn, img, v, centre=None):
    c = None if centre is None else torch.tensor([centre], dtype=torch.float32)
    return fn(torch.from_numpy(img[None].astype(np.float32)), torch.tensor([v], dtype=torch.float32),
              c).numpy()[0]


def _u8(seed, h=32, w=32):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("h,w", SIZES)
def test_geometric_vs_pil(h, w):
    img = _u8(0, h, w)
    pim = PIL.Image.fromarray(img)
    for v in (-0.3, -0.1, 0.17, 0.3):
        _pil_check(_one(T.shear_x, img, v), pim.transform(pim.size, PIL.Image.AFFINE, (1, v, 0, 0, 1, 0)))
        _pil_check(_one(T.shear_y, img, v), pim.transform(pim.size, PIL.Image.AFFINE, (1, 0, 0, v, 1, 0)))
    for v in (-0.45, -0.2, 0.11, 0.45):
        _pil_check(_one(T.translate_x, img, v),
                   pim.transform(pim.size, PIL.Image.AFFINE, (1, 0, v * w, 0, 1, 0)))
        _pil_check(_one(T.translate_y, img, v),
                   pim.transform(pim.size, PIL.Image.AFFINE, (1, 0, 0, 0, 1, v * h)))
    for v in (-10, -3, 0, 7, 10):
        _pil_check(_one(T.translate_x_abs, img, v),
                   pim.transform(pim.size, PIL.Image.AFFINE, (1, 0, v, 0, 1, 0)))
        _pil_check(_one(T.translate_y_abs, img, v),
                   pim.transform(pim.size, PIL.Image.AFFINE, (1, 0, 0, 0, 1, v)))
    for v in (-30.0, -12.5, 7.3, 30.0):
        _pil_check(_one(T.rotate, img, v), pim.rotate(v))


def test_histogram_ops_vs_pil():
    for seed in range(4):
        img = _u8(seed)
        if seed == 1:
            img = (img // 4 + 64).astype(np.uint8)
        if seed == 2:
            img = (img.astype(np.float32) ** 2 / 255.0).astype(np.uint8)
        pim = PIL.Image.fromarray(img)
        _pil_check(_one(T.auto_contrast, img, 0.0), PIL.ImageOps.autocontrast(pim), atol=1)
        _pil_check(_one(T.equalize, img, 0.0), PIL.ImageOps.equalize(pim))
    flat = np.full((8, 8, 3), 77, np.uint8)
    _pil_check(_one(T.auto_contrast, flat, 0.0), PIL.ImageOps.autocontrast(PIL.Image.fromarray(flat)))
    _pil_check(_one(T.equalize, flat, 0.0), PIL.ImageOps.equalize(PIL.Image.fromarray(flat)))


def test_pointwise_ops_vs_pil():
    img = _u8(5)
    pim = PIL.Image.fromarray(img)
    _pil_check(_one(T.invert, img, 0.0), PIL.ImageOps.invert(pim))
    for v in (0, 77.5, 128, 255, 256):
        _pil_check(_one(T.solarize, img, v), PIL.ImageOps.solarize(pim, v))
    for v in (0, 1, 2.7, 4, 4.9, 6, 8):
        _pil_check(_one(T.posterize, img, v), PIL.ImageOps.posterize(pim, int(v)))
        _pil_check(_one(T.posterize2, img, v), PIL.ImageOps.posterize(pim, int(v)))


@pytest.mark.parametrize("v", [0.1, 0.6, 1.0, 1.33, 1.9])
def test_enhance_ops_vs_pil(v):
    img = _u8(8)
    pim = PIL.Image.fromarray(img)
    _pil_check(_one(T.contrast, img, v), PIL.ImageEnhance.Contrast(pim).enhance(v))
    _pil_check(_one(T.color, img, v), PIL.ImageEnhance.Color(pim).enhance(v))
    _pil_check(_one(T.brightness, img, v), PIL.ImageEnhance.Brightness(pim).enhance(v))
    for h, w in SIZES:
        small = _u8(9, h, w)
        _pil_check(_one(T.sharpness, small, v), PIL.ImageEnhance.Sharpness(PIL.Image.fromarray(small)).enhance(v))


@pytest.mark.parametrize("v", [0.0, 4.0, 11.3, 20.0])
def test_cutout_abs_vs_pil_rectangle(v):
    img = _u8(10)
    centre = (21.7, 3.2)
    x0 = int(max(0, centre[0] - v / 2.0))
    y0 = int(max(0, centre[1] - v / 2.0))
    pim = PIL.Image.fromarray(img).copy()
    PIL.ImageDraw.Draw(pim).rectangle((x0, y0, min(32, x0 + v), min(32, y0 + v)),
                                      tuple(int(c) for c in T.CUTOUT_COLOR))
    _pil_check(_one(T.cutout_abs, img, v, centre), pim)
    assert np.array_equal(_one(T.cutout, img, 0.0, centre), img)


# ------------------------------------------------ policy-level parity


def _has_gated_rotate(policy, sub, draws):
    rows = policy[sub]
    return bool(((rows[:, 0] == T.op_index("Rotate")) & (draws[:, 0] < rows[:, 1])).any())


def _policy_case(policy, h, w, n, seed):
    imgs = _imgs(seed, n, h, w)
    keys = np.stack([np.asarray(jax.random.PRNGKey(seed * 1000 + i), np.uint32) for i in range(n)])
    sub, draws = jax_policy_draws(keys, policy.shape[0], policy.shape[1], h, w)
    return {"kind": "apply_subpolicy", "images": imgs, "subpolicies": policy[sub],
            "keys": split_policy_key(keys)[1], "policy": policy, "sub": sub, "draws": draws}


def _random_policy_case(seed):
    policy = random_policy(np.random.default_rng(seed), 8, 3)
    policy[..., 1] = np.maximum(policy[..., 1], 0.6)  # mostly gated on
    return _policy_case(policy, 17, 23, 12, seed=seed)


@pytest.fixture(scope="module")
def policy_refs(tmp_path_factory):
    """``apply_policy``'s outputs for every policy case (as ``jit(apply_subpolicy)``
    on the sub-policy and key it splits off), computed in one FMA-free JAX
    process."""
    cases = {name: _policy_case(policy_to_tensor(load_policy(name)), 32, 32, 8,
                                seed=ARCHIVES.index(name) + 1) for name in ARCHIVES}
    cases.update({seed: _random_policy_case(seed) for seed in RANDOM_POLICY_SEEDS})
    refs = jax_reference(list(cases.values()), tmp_path_factory.mktemp("refs"))
    return {k: (case, ref) for (k, case), ref in zip(cases.items(), refs)}


def _check_policy_parity(case, want):
    policy, imgs, sub, draws = case["policy"], case["images"], case["sub"], case["draws"]
    got = T.apply_subpolicy_draws(torch.from_numpy(imgs), torch.from_numpy(policy),
                                  torch.from_numpy(sub), torch.from_numpy(draws)).numpy()
    for i in range(len(imgs)):
        if _has_gated_rotate(policy, sub[i], draws[i]) and not np.array_equal(got[i], want[i]):
            continue  # cos/sin: the Rotate bound's reason, checked per op above
        assert np.array_equal(got[i], want[i]), (i, policy[sub[i]].tolist())


@pytest.mark.parametrize("name", ARCHIVES)
def test_archive_policy_bitwise_vs_apply_policy(name, policy_refs):
    _check_policy_parity(*policy_refs[name])


@pytest.mark.parametrize("seed", RANDOM_POLICY_SEEDS)
def test_random_policy_bitwise_vs_apply_policy(seed, policy_refs):
    """Random 8x3 policies (three op slots) on 17x23 images."""
    _check_policy_parity(*policy_refs[seed])


def test_gate_off_is_identity_and_inputs_untouched():
    imgs = _imgs(1, 3, 9, 9)
    before = imgs.copy()
    policy = np.float32([[[6, 0.5, 0.0], [7, 0.5, 0.0]]])
    draws = np.zeros((3, 2, 4), np.float32)
    draws[..., 0] = 0.9  # every gate off
    out = T.apply_subpolicy_draws(torch.from_numpy(imgs), torch.from_numpy(policy),
                                  torch.zeros(3, dtype=torch.int32), torch.from_numpy(draws))
    assert np.array_equal(out.numpy(), before) and np.array_equal(imgs, before)


def test_apply_subpolicy_draws_validates_inputs():
    imgs = torch.zeros((2, 8, 8, 3))
    pol = torch.zeros((1, 2, 3))
    good = (torch.zeros(2, dtype=torch.int32), torch.zeros((2, 2, 4)))
    with pytest.raises(ValueError):
        T.apply_subpolicy_draws(imgs, pol, torch.tensor([0, 1]), good[1])  # sub_idx out of range
    with pytest.raises(ValueError):
        T.apply_subpolicy_draws(imgs, pol, good[0], torch.zeros((2, 3, 4)))
    with pytest.raises(TypeError):
        T.apply_subpolicy_draws(imgs.double(), pol, *good)
    with pytest.raises(ValueError):
        T.apply_subpolicy_draws(imgs.to("meta"), pol.to("meta"), good[0].to("meta"),
                                good[1].to("meta"))
    with pytest.raises(ValueError):
        T.check_policy(np.float32([[[19, 1.0, 0.5]]]))
    with pytest.raises(ValueError):
        T.check_policy(np.float32([[[2.5, 1.0, 0.5]]]))


def test_cpu_path_never_reaches_the_kernel():
    _kernels.reset_launch_counts()
    imgs = torch.from_numpy(_imgs(2, 4, 8, 8))
    pol = torch.from_numpy(policy_to_tensor(load_policy("autoaug_paper_cifar10")))
    sub, draws = T.sample_exact(torch.arange(8).reshape(4, 2), pol.shape[0], 2, 8, 8)
    T.apply_subpolicy_draws(imgs, pol, sub, draws)
    assert _kernels.launch_counts() == {"augment_slot": 0, "cifar_stack": 0, "imagenet_stack": 0}
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA tensors only
        _kernels.augment(imgs, torch.zeros((4, 2, 16)))


# ------------------------------------------------------ generator + samplers


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF,) * 4,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(key, ctr, want):
    t = functools.partial(torch.tensor, dtype=torch.int64)
    got = rng.philox4x32((t(key[0]), t(key[1])), tuple(t(c) for c in ctr))
    assert tuple(int(x) for x in got) == want


def test_sample_exact_lane_depends_on_its_key_only():
    keys = torch.tensor([[0, 5], [7, 9], [0, 5], [123, 456]], dtype=torch.int64)
    sub, draws = T.sample_exact(keys, 25, 2, 32, 32)
    sub1, draws1 = T.sample_exact(keys[3:], 25, 2, 32, 32)
    assert sub.dtype == torch.int32 and draws.dtype == torch.float32
    assert torch.equal(sub[0], sub[2]) and torch.equal(draws[0], draws[2])
    assert torch.equal(sub[3], sub1[0]) and torch.equal(draws[3], draws1[0])
    assert not torch.equal(draws[0], draws[1])
    many_sub, many = T.sample_exact(torch.arange(4000).reshape(2000, 2), 25, 2, 17, 23)
    assert int(many_sub.min()) == 0 and int(many_sub.max()) == 24
    assert float(many[..., :2].min()) >= 0 and float(many[..., :2].max()) < 1
    assert float(many[..., 2].max()) < 23 and float(many[..., 3].max()) < 17


def test_sample_grouped_is_stratified():
    key = torch.tensor([3, 11], dtype=torch.int64)
    sub, draws = T.sample_grouped(key, 13, 4, 50, 2, 8, 8)
    assert sub.shape == (13,) and draws.shape == (13, 2, 4)
    # 4 chunks of ceil(13/4) = 4 positions: at most 4 distinct sub-policies
    # and every chunk's images share one
    assert len(set(sub.tolist())) <= 4
    assert max(np.bincount(sub.numpy())) >= 4 or len(set(sub.tolist())) < 4
    again = T.sample_grouped(key, 13, 4, 50, 2, 8, 8)
    assert torch.equal(sub, again[0]) and torch.equal(draws, again[1])


def test_sample_draws_layout_matches_jax_keys():
    """npz seeds map to JAX's ``PRNGKey(seed)`` words, (0, seed)."""
    for s in (0, 5, 2**31 - 1):
        assert np.asarray(jax.random.PRNGKey(s), np.uint32).tolist() == [0, s]
    sub, draws = T.sample_draws("exact", np.uint32([[0, 5], [0, 6]]), 2, num_sub=3,
                                num_op=2, height=8, width=8, groups=1, device="cpu")
    ref_sub, ref_draws = T.sample_exact(torch.tensor([[0, 5], [0, 6]]), 3, 2, 8, 8)
    assert torch.equal(sub, ref_sub) and torch.equal(draws, ref_draws)


def test_jax_archive_list_unchanged():
    assert ARCHIVES == JAX_ARCHIVES
