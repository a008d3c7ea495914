"""The draw sampler (K7) and the train noise (K8) on the CPU.

Oracles and bounds:

- the golden file ``tests/data/torch_sampler_golden.npz``: the records of
  every sampler entry point (``sample_exact``, ``sample_grouped`` at B = 13
  with 4 groups, 128 with 8, 5 with 8 and others, ``sample_crop``,
  ``sample_imagenet``, ``PhiloxDraws.draws``, ``imagenet_lane_draws``,
  ``imagenet_draws``, ``model_noise``, ``mixup_draws``, the Beta and the
  permutation, ``fold_in`` with a tensor counter, ``split``,
  ``fold_in_range``, ``blocks``) as the int64 torch generator made them
  before the kernels existed (``python tests/test_torch_sampler.py --record
  PATH`` writes it from :func:`golden_records`).  Bound: bitwise, for the
  ``*_plain`` functions and for the public names, which on the CPU take the
  plain versions;
- the grouped record against the JAX ``apply_policy_batch_grouped``
  contract (``fast_autoaugment_tpu/ops/augment.py:520``): ``g = min(groups,
  B)`` chunks of ``ceil(B / g)`` positions of a permutation (JAX's chunk
  sizes, from its own ``grouped_permutation`` layout), one sub-policy per
  chunk, and the single-sub short-circuit to the exact draws: exact;
- the slice as a whole: a ``PolicyApplier`` call and a TTA step on the CPU
  with the new routing equal the same calls fed the golden draws, bitwise,
  and the applier's images equal the JAX package's ops fed the same
  explicit draws (``test_torch_replay.jax_apply_from_draws``, in one
  FMA-free JAX process), bitwise, on a policy without Rotate (whose cos/sin
  is the per-op bound of ``test_torch_augment.py``);
- the CPU never reaches ``ops/_kernels.py``; ``_SIGNATURES["sampler"]``
  matches the ``extern "C"`` declarations of ``csrc/sampler.cu``.
"""

import functools
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN_SEED = 20261018
#: the TTA step of the slice test: its key, draws per image and batch
TTA_KEY, TTA_P, TTA_BATCH = (0, 3), 3, 6


def _keys(g, n):
    """``[n, 2]`` int64 keys of full 32-bit words."""
    return torch.from_numpy(g.integers(0, 2**32, (n, 2), dtype=np.int64))


def _sites():
    """Every kind of noise site, numbered as a model numbers them."""
    from fast_autoaugment_tpu_torch.ops.shake import NoiseSite

    sites = [NoiseSite("shake_shake"), NoiseSite("shake_drop", 0.3),
             NoiseSite("dropout", 0.25, 7), NoiseSite("drop_connect", 0.2),
             NoiseSite("shake_drop", 0.0), NoiseSite("shake_shake"),
             NoiseSite("dropout", 0.5, 3)]
    for i, s in enumerate(sites):
        s.site = i
    return sites


def golden_records(plain: bool = False) -> dict:
    """Every sampler entry point's records on seeded keys, as numpy arrays by
    name (the bits of float arrays as integers).  With `plain` the samplers,
    key helpers and draws are called by their ``*_plain`` names."""
    from types import SimpleNamespace

    from fast_autoaugment_tpu_torch.ops import augment, rng as rng_mod
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    def names(mod, *fns):
        return SimpleNamespace(**{f: getattr(mod, f + "_plain", getattr(mod, f)) if plain
                                  else getattr(mod, f) for f in fns})

    T = names(augment, "sample_exact", "sample_grouped", "sample_crop", "sample_imagenet")
    rng = names(rng_mod, "beta_symmetric", "permutation", "fold_in", "fold_in_range", "split",
                "blocks")

    g = np.random.default_rng(GOLDEN_SEED)
    out = {}

    def put(name, t):
        t = t.detach().cpu()
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        elif t.dtype == torch.float64:
            t = t.view(torch.int64)
        elif t.dtype == torch.bool:
            t = t.to(torch.uint8)
        out[name] = t.numpy().copy()

    keys = _keys(g, 37)
    for num_op in (1, 2, 3):
        for hw in (32, 224):
            sub, pol = T.sample_exact(keys, 25, num_op, hw, hw)
            put(f"exact_{num_op}_{hw}_sub", sub)
            put(f"exact_{num_op}_{hw}_pol", pol)
    for b, groups, num_sub in ((13, 4, 25), (128, 8, 25), (5, 8, 7), (1, 8, 3), (200, 3, 2)):
        sub, pol = T.sample_grouped(keys[b % 37], b, groups, num_sub, 2, 32, 32)
        put(f"grouped_{b}_{groups}_sub", sub)
        put(f"grouped_{b}_{groups}_pol", pol)
    put("crop_32", T.sample_crop(keys, 32, 32))
    put("crop_17x23", T.sample_crop(keys, 17, 23))
    ints, floats = T.sample_imagenet(keys, 224, 224)
    put("imagenet_ints", ints)
    put("imagenet_floats", floats)
    ints, floats = T.sample_imagenet(keys, 17, 23, strength=0.25, alphastd=0.3)
    put("imagenet_odd_ints", ints)
    put("imagenet_odd_floats", floats)

    src = PhiloxDraws()
    draw_keys = _keys(g, 3)
    for dispatch in ("exact", "grouped"):
        for num_sub in (1, 5):
            d = src.draws(draw_keys, batch=13, num_sub=num_sub, num_op=2, height=32, width=32,
                          dispatch=dispatch, groups=4, device="cpu")
            for f in ("sub_idx", "policy", "crop"):
                put(f"draws_{dispatch}_{num_sub}_{f}", getattr(d, f))
            d = src.imagenet_lane_draws(draw_keys, batch=6, num_sub=num_sub, num_op=3,
                                        height=24, width=20, dispatch=dispatch, groups=4,
                                        device="cpu")
            for f in ("sub_idx", "policy", "flip", "order", "factors", "alpha", "centre"):
                put(f"imagenet_lane_{dispatch}_{num_sub}_{f}", getattr(d, f))
    d = src.imagenet_draws(draw_keys[0], batch=9, policy_shape=None, height=224, width=224,
                           dispatch="grouped", groups=8, device="cpu")
    for f in ("flip", "order", "factors", "alpha", "centre"):
        put(f"imagenet_nopolicy_{f}", getattr(d, f))

    noise_keys = _keys(g, 2)
    if plain:
        from fast_autoaugment_tpu_torch.ops.shake import ModelNoise

        noise = ModelNoise.draw_plain(_sites(), 5, noise_keys[0], noise_keys[1])
    else:
        noise = src.model_noise(_sites(), 5, noise_keys[0], noise_keys[1], "cpu")
    for i, tensors in enumerate(noise.tensors):
        for j, t in enumerate(tensors):
            put(f"noise_{i}_{j}", t)
    for alpha, batch in ((0.2, 64), (1.0, 1), (2.0, 128)):
        lam, perm = src.mixup_draws(_keys(g, 1)[0], batch, alpha, "cpu")
        put(f"mixup_{alpha}_{batch}_lam", lam)
        put(f"mixup_{alpha}_{batch}_perm", perm)
    beta_keys = _keys(g, 4096)
    put("beta_0.2", rng.beta_symmetric(beta_keys, 0.2))
    put("beta_1.0", rng.beta_symmetric(beta_keys[:64], 1.0))
    put("beta_2.0", rng.beta_symmetric(beta_keys[:64], 2.0))
    for n in (1, 64, 4096):
        put(f"perm_{n}", rng.permutation(beta_keys[n % 4096], n))

    put("fold_in_tensor", rng.fold_in(keys[0], torch.tensor(1234567)))
    put("fold_in_tensor_wide", rng.fold_in(keys[1], torch.tensor(2**40 + 3)))
    put("fold_in_stack", rng.fold_in(keys[:5], 77))
    put("fold_in_range", rng.fold_in_range(keys[2], 9))
    put("split", rng.split(keys[:4], 6))
    put("split_one", rng.split(keys[3], 2))
    for i, w in enumerate(rng.blocks(keys[:3], 5, 9)):
        put(f"blocks_{i}", w)

    # the draws of the TTA step of test_tta_step_equals_its_golden_draws
    draw_keys = rng.split(torch.tensor(TTA_KEY), TTA_P)
    for dispatch in ("exact", "grouped"):
        d = src.draws(draw_keys, batch=TTA_BATCH, num_sub=5, num_op=2, height=32, width=32,
                      dispatch=dispatch, groups=4, device="cpu")
        for f in ("sub_idx", "policy", "crop"):
            put(f"tta_{dispatch}_{f}", getattr(d, f))
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the float64 draws crawl on a pool shared with the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=2)
def _records(plain: bool) -> dict:
    return golden_records(plain)


@functools.lru_cache(maxsize=1)
def _golden() -> dict:
    with np.load(Path(__file__).parent / "data" / "torch_sampler_golden.npz") as z:
        return {k: z[k] for k in z.files}


GROUPS = ("exact", "grouped", "crop", "imagenet_ints", "imagenet_floats", "imagenet_odd",
          "draws_exact", "draws_grouped", "imagenet_lane_exact", "imagenet_lane_grouped",
          "imagenet_nopolicy", "noise", "mixup", "beta", "perm", "fold_in", "split", "blocks",
          "tta")


def test_golden_covers_every_record():
    assert set(_golden()) == {k for k in _golden() if k.startswith(GROUPS)} == set(_records(False))


@pytest.mark.parametrize("plain", [False, True], ids=["public", "plain"])
@pytest.mark.parametrize("group", GROUPS)
def test_records_equal_the_golden(plain, group):
    got, want = _records(plain), _golden()
    names = [k for k in want if k.startswith(group + "_") or k == group]
    assert names
    for k in names:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


# ------------------------------------------------- the JAX grouped contract


@pytest.mark.parametrize("b,groups", [(13, 4), (128, 8), (5, 8), (5, 4), (1, 8), (200, 3),
                                      (64, 64), (7, 1)])
def test_grouped_record_follows_the_jax_contract(b, groups):
    import jax

    from fast_autoaugment_tpu.ops import augment as JA
    from fast_autoaugment_tpu_torch.ops import augment as T
    from fast_autoaugment_tpu_torch.ops import rng

    key = torch.tensor([5, 31 * b + groups])
    num_sub = 25
    sub, pol = T.sample_grouped(key, b, groups, num_sub, 2, 32, 32)
    # the port's permutation: image i sits at position pos[i]
    lane = torch.arange(b)
    zero = torch.zeros_like(lane)
    words = rng.philox4x32((key[1], key[0]), (lane, zero + 2, zero, zero))[0]
    pos = torch.empty_like(lane)
    pos[torch.sort(words, stable=True).indices] = lane
    # JAX's layout: the permutation of the batch padded to g full chunks
    g = min(groups, b)
    chunk = -(-b // g)
    perm, _ = JA.grouped_permutation(jax.random.PRNGKey(b), b)
    jax_pos = np.concatenate([np.asarray(perm), np.asarray(perm)[:g * chunk - b]])
    jax_sizes = [int((np.arange(g * chunk)[gi * chunk:(gi + 1) * chunk] < b).sum())
                 for gi in range(g)]
    assert len(jax_pos) == g * chunk
    sizes = [int((pos // chunk == gi).sum()) for gi in range(g)]
    assert sizes == jax_sizes
    group_words = rng.philox4x32((key[1], key[0]), (torch.arange(g), torch.full((g,), 3), 0, 0))
    group_sub = ((group_words[0] >> 8) * num_sub) >> 24
    assert torch.equal(sub.to(torch.int64), group_sub[pos // chunk])
    # per-image slots: each image's own draws, not its chunk's
    assert len({tuple(r) for r in pol[:, 0, :2].tolist()}) == b


def test_single_sub_grouped_takes_the_exact_draws():
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    src = PhiloxDraws()
    kw = dict(batch=13, num_sub=1, num_op=2, height=32, width=32, groups=4, device="cpu")
    keys = torch.tensor([[1, 2], [3, 4]])
    a, b = src.draws(keys, dispatch="grouped", **kw), src.draws(keys, dispatch="exact", **kw)
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("sub_idx", "policy", "crop"))
    shape = dict(batch=13, num_sub=1, num_op=2, height=24, width=20, groups=4, device="cpu")
    a = src.imagenet_lane_draws(keys, dispatch="grouped", **shape)
    b = src.imagenet_lane_draws(keys, dispatch="exact", **shape)
    assert all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("sub_idx", "policy", "flip", "order", "factors", "alpha", "centre"))


# --------------------------------------------------------- the slice


def _no_rotate_policy(num_sub, num_op, seed):
    from fast_autoaugment_tpu_torch.ops import augment as T

    g = np.random.default_rng(seed)
    ops = [i for i in range(T.NUM_OPS) if T.OP_NAMES[i] != "Rotate"]
    pol = np.zeros((num_sub, num_op, 3), np.float32)
    pol[..., 0] = g.choice(ops, (num_sub, num_op))
    pol[..., 1] = g.uniform(0.3, 1.0, (num_sub, num_op))
    pol[..., 2] = g.uniform(0.0, 1.0, (num_sub, num_op))
    return pol


#: the applier's cases: (dispatch, images, golden keys, golden record, groups)
APPLIER = {"exact": (8, slice(0, 8), "exact_2_32", 8), "grouped": (13, 13, "grouped_13_4", 4)}


def _applier_draws(dispatch):
    n, rows, record, _ = APPLIER[dispatch]
    rows = rows if dispatch == "exact" else slice(None)
    return _golden_tensor(record + "_sub", rows), _golden_tensor(record + "_pol", rows)


def _golden_tensor(name, rows=slice(None)):
    a = _golden()[name][rows]
    return torch.from_numpy(a.view(np.float32) if name.endswith(("_pol", "_policy")) else a)


def _applier_case(dispatch):
    from fast_autoaugment_tpu_torch.serve.policy_server import PolicyApplier

    n, rows, _, groups = APPLIER[dispatch]
    keys = _keys(np.random.default_rng(GOLDEN_SEED), 37)[rows].numpy().astype(np.uint32)
    images = np.random.default_rng(n).integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    policy = _no_rotate_policy(25, 2, seed=n)

    def golden(d, k, batch, **kw):
        assert d == dispatch and np.array_equal(np.asarray(k, np.uint32).reshape(-1),
                                                keys.reshape(-1))
        return _applier_draws(dispatch)

    kw = dict(image=32, shapes=(n,), dispatch=dispatch, groups=groups, device="cpu")
    new = PolicyApplier(policy, **kw).apply(images, keys)
    old = PolicyApplier(policy, draw_source=golden, **kw).apply(images, keys)
    return images, policy, new, old


@pytest.fixture(scope="module")
def jax_applied(tmp_path_factory):
    """The JAX package's ops on each applier case's images, fed the golden
    draws, in one FMA-free JAX process."""
    from test_torch_replay import jax_reference

    jobs = []
    for dispatch in APPLIER:
        images, policy, _, _ = _applier_case(dispatch)
        sub, draws = _applier_draws(dispatch)
        jobs.append({"runner": "test_torch_sampler:jax_from_draws",
                     "images": images.astype(np.float32), "policy": policy,
                     "sub": sub.numpy(), "draws": draws.numpy()})
    return dict(zip(APPLIER, jax_reference(jobs, tmp_path_factory.mktemp("sampler"))))


def jax_from_draws(job):
    """Reference runner: ``jax_apply_from_draws`` image by image."""
    import jax.numpy as jnp

    from test_torch_replay import jax_apply_from_draws

    return np.stack([np.asarray(jax_apply_from_draws(jnp.asarray(img), jnp.asarray(job["policy"]),
                                                     int(s), jnp.asarray(d)))
                     for img, s, d in zip(job["images"], job["sub"], job["draws"])])


@pytest.mark.parametrize("dispatch", list(APPLIER))
def test_policy_applier_equals_its_golden_draws_and_jax(dispatch, jax_applied):
    _, _, new, old = _applier_case(dispatch)
    assert new.dtype == old.dtype and np.array_equal(new, old)
    assert np.array_equal(new.astype(np.float32), jax_applied[dispatch])


@pytest.mark.parametrize("dispatch", ["exact", "grouped"])
def test_tta_step_equals_its_golden_draws(dispatch):
    from fast_autoaugment_tpu_torch.models.wideresnet import WideResNet
    from fast_autoaugment_tpu_torch.ops import rng
    from fast_autoaugment_tpu_torch.search import tta

    class GoldenDraws(tta.PhiloxDraws):
        def draws(self, draw_keys, **kw):
            assert torch.equal(draw_keys, rng.split(torch.tensor(TTA_KEY), TTA_P))
            return tta.LaneDraws(*(_golden_tensor(f"tta_{dispatch}_{f}")
                                   for f in ("sub_idx", "policy", "crop")))

    torch.manual_seed(0)
    model = WideResNet(10, 1, 10)
    g = np.random.default_rng(1)
    images = torch.from_numpy(g.integers(0, 256, (TTA_BATCH, 32, 32, 3)).astype(np.uint8))
    labels = torch.from_numpy(g.integers(0, 10, TTA_BATCH).astype(np.int32))
    mask = torch.ones(TTA_BATCH)
    policy = torch.from_numpy(_no_rotate_policy(5, 2, seed=7))
    kw = dict(num_policy=TTA_P, aug_dispatch=dispatch, aug_groups=4)
    new = tta.make_tta_step(model, **kw)(images, labels, mask, policy, torch.tensor(TTA_KEY))
    old = tta.make_tta_step(model, draw_source=GoldenDraws(), **kw)(images, labels, mask, policy,
                                                                    torch.tensor(TTA_KEY))
    assert set(new) == set(old) and all(torch.equal(new[k], old[k]) for k in new)


# ------------------------------------------------ the CPU and the kernels


def test_cpu_path_never_reaches_the_kernels(monkeypatch):
    """Every sampler entry point, the train step's draws and the applier on
    the CPU: no wrapper of ``_kernels`` is called, nothing is built, no launch
    is counted; the wrappers refuse CPU tensors."""
    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    _kernels.reset_launch_counts()
    keys = torch.tensor([[1, 2], [3, 4]])
    with pytest.raises(ValueError):
        _kernels.sampler_keys(keys, 2, _kernels.SPLIT)
    with pytest.raises(ValueError):
        _kernels.sampler_lanes(keys, batch=2, height=8, width=8, crop=True)
    with pytest.raises(ValueError):
        _kernels.sampler_grouped(keys, batch=2, groups=2, num_sub=2, num_op=1, height=8, width=8)
    with pytest.raises(ValueError):
        _kernels.train_noise(mix_keys=keys, perm_n=4, gamma=(1.0, 1.0, 1.0, False))

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernels")

    for name in ("load_libraries", "sampler_keys", "sampler_lanes", "sampler_grouped",
                 "train_noise"):
        monkeypatch.setattr(_kernels, name, refuse)
    golden_records(False)
    src = PhiloxDraws()
    noise, lam, perm = src.train_draws(_sites(), 4, keys[0], keys[1], torch.tensor([5, 6]), 0.2,
                                       "cpu")
    assert lam.shape == () and perm.shape == (4,) and len(noise.tensors) == 7
    _applier_case("exact")
    _applier_case("grouped")
    assert all(v == 0 for v in _kernels.launch_counts().values())


_CTYPES = {"int": "c_int", "unsigned": "c_uint", "float": "c_float", "double": "c_double",
           "long long": "c_longlong", "*": "c_void_p"}


def test_sampler_signatures_match_the_source():
    """``_SIGNATURES["sampler"]`` against the ``extern "C"`` declarations of
    ``csrc/sampler.cu``: every function, every argument's ctypes type (a
    pointer is ``c_void_p``)."""
    from fast_autoaugment_tpu_torch.ops import _kernels

    import ctypes

    src = _kernels.SOURCES["sampler"].read_text()
    decls = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        kinds = []
        for arg in args.split(","):
            arg = " ".join(arg.replace("const ", "").split())
            kinds.append(getattr(ctypes, _CTYPES["*" if "*" in arg else arg.rsplit(" ", 1)[0]]))
        decls[name] = kinds
    assert decls == _kernels._SIGNATURES["sampler"]
    assert "faa_error_string" in src


if __name__ == "__main__" and sys.argv[1:2] == ["--record"]:
    np.savez_compressed(sys.argv[2], **golden_records())
