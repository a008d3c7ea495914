"""Replay of the JAX augmentation key tree, for the port's parity tests.

The port (``fast_autoaugment_tpu_torch``) takes its random draws as
tensors: a sub-policy index per image and ``draws [B, num_op, 4]`` =
(gate uniform, mirror uniform, cutout x centre, cutout y centre).  The
helpers here extract, from a JAX key, exactly the draws that
``fast_autoaugment_tpu.ops.augment`` consumes:

- ``apply_policy`` (``:459``): ``key_choice, key_sub = split(key)``, the
  sub-policy is ``randint(key_choice, (), 0, S)``;
- ``apply_subpolicy`` (``:434``): per slot ``key, key_gate, key_op =
  split(key, 3)``, the gate is ``uniform(key_gate)``;
- ``apply_op`` (``:409``): ``key_mirror, key_op = split(key_op)``, the
  mirror draw is ``uniform(key_mirror)``;
- ``_cutout_abs`` (``:333``): ``kx, ky = split(key_op)``, the centre is
  ``uniform(kx, 0, W), uniform(ky, 0, H)``;
- ``apply_policy_batch_grouped`` (``:520``): the permutation, the
  per-chunk sub-policy and the per-image keys of ``apply_subpolicy_batch``.

The replay reads the ``jax_threefry_partitionable`` flag in force and is
self-consistent under either value; :func:`test_replay_reproduces_apply_policy`
checks both.  Other ``tests/test_torch_*.py`` files import these helpers.

Compiled references run in a fresh process (:func:`jax_reference`, which
runs this file as a script) whose XLA is capped at ``--xla_cpu_max_isa=AVX``.
On an FMA-capable CPU, XLA contracts some multiply-adds of the compiled
JAX programs into fused ones, and differently from one program to the next
(``jit(apply_policy)``, the ``AotPolicyApplier`` exact and grouped
programs and the eager ops then disagree with each other in a few
elements of the blend ops and ``level * (high - low) + low``).  Without
FMA every JAX program rounds each product and sum on its own, the
reference's documented PIL semantics, which the port implements.

The CIFAR stack and the TTA step (``ops/preprocess.py``, ``search/tta.py``)
add to the tree:

- ``cifar_train_batch`` (``:109``): per draw key, ``split(key, B)`` gives
  each image's key (after ``key, key_pol = split(key)`` under ``grouped``
  with a multi-sub policy, whose policy draws are then those of
  ``apply_policy_batch_grouped(key_pol)``);
- ``_cifar_train_one`` (``:91``): ``k_policy, k_crop, k_flip, k_cutout =
  split(key, 4)``; the crop offsets are ``randint(ky/kx, (), 0, 9)`` with
  ``ky, kx = split(k_crop)``, the flip ``uniform(k_flip) < 0.5``, the cutout
  centre ``randint(ky, (), 0, H), randint(kx, (), 0, W)`` with ``ky, kx =
  split(k_cutout)``;
- ``make_tta_step`` (``:76``): a batch's P draw keys are ``split(key, P)``;
  ``make_audit_step``: ``split(key, S * P)``; ``eval_tta``: batch i's key
  is ``fold_in(key, i)``.

:class:`JaxDraws` is that tree as a draw source of the port's TTA step.

The ImageNet stack and the train step (``ops/preprocess_imagenet.py``,
``train/steps.py``) add:

- ``imagenet_train_batch`` (``:191``): ``split(key, B)`` gives each image's
  key (after ``key, key_pol = split(key)`` under ``grouped`` with a
  multi-sub policy);
- ``_train_one`` (``:168``): ``k_pol, k_flip, k_jit, k_light, k_cut =
  split(key, 5)``; the flip is ``uniform(k_flip) < 0.5``; ``_color_jitter``
  splits ``k_jit`` into ``(k_perm, k_b, k_c, k_s)``, the factors are
  ``uniform(k, (), 0.6, 1.4)`` and the order ``randint(k_perm, (), 0, 6)``;
  the lighting noise is ``normal(k_light, (3,)) * 0.1``; the cutout centre
  is ``randint(ky, (), 0, H), randint(kx, (), 0, W)`` with ``ky, kx =
  split(k_cut)``;
- ``make_train_step`` (``train/steps.py:154``): step s's key is
  ``fold_in(key, s)``, split into ``(key_aug, key_model)``.

The ImageNet stack's factors and normals are float arithmetic
(``u * (max - min) + min``, an inverse error function), which XLA on an FMA
CPU contracts differently from the FMA-free reference process.  So they are
drawn in that process (:func:`jax_imagenet_draws`, job kind
``imagenet_draws``) and handed to :class:`JaxDraws` as a table by key.
"""

import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_autoaugment_tpu.ops import augment as A

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: XLA without fused multiply-add: the JAX programs' documented rounding
NO_FMA_XLA_FLAGS = "--xla_cpu_max_isa=AVX"

# ------------------------------------------------------------ the replay


def _subpolicy_draws(key, num_op: int, h: int, w: int):
    rows = []
    for _ in range(num_op):
        key, key_gate, key_op = jax.random.split(key, 3)
        key_mirror, key_cut = jax.random.split(key_op)
        kx, ky = jax.random.split(key_cut)
        rows.append(jnp.stack([
            jax.random.uniform(key_gate),
            jax.random.uniform(key_mirror),
            jax.random.uniform(kx, (), minval=0.0, maxval=float(w)),
            jax.random.uniform(ky, (), minval=0.0, maxval=float(h))]))
    return jnp.stack(rows)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _policy_draws(keys, num_sub, num_op: int, h: int, w: int):
    def one(key):
        key_choice, key_sub = jax.random.split(key)
        idx = jax.random.randint(key_choice, (), 0, num_sub)
        return idx, _subpolicy_draws(key_sub, num_op, h, w)

    return jax.vmap(one)(keys)


def jax_policy_draws(keys, num_sub: int, num_op: int, h: int, w: int):
    """Per-image keys ``[B, 2]`` uint32 -> (sub_idx [B] int32, draws
    [B, num_op, 4] float32) as numpy, the draws of ``apply_policy`` (and of
    ``apply_policy_scalar_single`` for a one-sub policy)."""
    sub, draws = _policy_draws(jnp.asarray(np.asarray(keys, np.uint32)),
                               jnp.int32(num_sub), num_op, h, w)
    return np.array(sub, np.int32), np.array(draws, np.float32)


def jax_grouped_draws(key, batch: int, groups: int, num_sub: int, num_op: int,
                      h: int, w: int):
    """The draws of ``apply_policy_batch_grouped(images[batch], policy, key,
    groups=groups)``, per image in the batch's own order."""
    key = jnp.asarray(np.asarray(key, np.uint32))
    if num_sub == 1:  # the scalar short-circuit: per-image keys
        return jax_policy_draws(np.asarray(jax.random.split(key, batch)),
                                1, num_op, h, w)
    g = min(groups, batch)
    chunk = -(-batch // g)
    key_perm, key_groups = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(key_perm, batch))
    group_keys = jax.random.split(key_groups, g)
    sub = np.zeros(batch, np.int32)
    draws = np.zeros((batch, num_op, 4), np.float32)
    for gi in range(g):
        key_choice, key_apply = jax.random.split(group_keys[gi])
        idx = int(jax.random.randint(key_choice, (), 0, num_sub))
        lane_keys = jax.random.split(key_apply, chunk)
        for j in range(chunk):
            p = gi * chunk + j
            if p < batch:  # positions past the batch are padding duplicates
                sub[perm[p]] = idx
                draws[perm[p]] = np.asarray(_subpolicy_draws(lane_keys[j], num_op, h, w))
    return sub, draws


def jax_draw_source(dispatch, keys, batch, *, num_sub, num_op, height, width,
                    groups, device):
    """A ``PolicyApplier`` draw source that replays the JAX key tree, so the
    port's applier can be held bitwise against ``AotPolicyApplier``."""
    import torch  # not at import: the reference subprocess runs this file

    if dispatch == "exact":
        sub, draws = jax_policy_draws(np.asarray(keys).reshape(batch, 2),
                                      num_sub, num_op, height, width)
    else:
        sub, draws = jax_grouped_draws(keys, batch, groups, num_sub, num_op,
                                       height, width)
    return torch.from_numpy(sub).to(device), torch.from_numpy(draws).to(device)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _cifar_lane_draws(keys, h: int, w: int, pad: int = 4):
    """Per-image keys ``[B, 2]`` -> (``k_policy [B, 2]``, ``[B, 5]`` int32 =
    (oy, ox, flip, cy, cx)), as ``_cifar_train_one`` consumes its key."""
    def one(key):
        k_policy, k_crop, k_flip, k_cutout = jax.random.split(key, 4)
        ky, kx = jax.random.split(k_crop)
        oy = jax.random.randint(ky, (), 0, 2 * pad + 1)
        ox = jax.random.randint(kx, (), 0, 2 * pad + 1)
        flip = (jax.random.uniform(k_flip) < 0.5).astype(jnp.int32)
        cy_k, cx_k = jax.random.split(k_cutout)
        cy = jax.random.randint(cy_k, (), 0, h)
        cx = jax.random.randint(cx_k, (), 0, w)
        return k_policy, jnp.stack([oy, ox, flip, cy, cx]).astype(jnp.int32)

    return jax.vmap(one)(keys)


def jax_cifar_draws(key, batch: int, policy_shape, h: int, w: int,
                    dispatch: str = "exact", groups: int = 8):
    """The draws of ``cifar_train_batch(images[batch], key, policy,
    aug_dispatch=dispatch, aug_groups=groups)``: (sub_idx [B], policy draws
    [B, num_op, 4], stack draws [B, 5]) as numpy.  ``policy_shape`` is
    ``(num_sub, num_op)``, or None for no policy."""
    key = jnp.asarray(np.asarray(key, np.uint32))
    grouped = (dispatch == "grouped" and policy_shape is not None
               and policy_shape[0] > 1)
    if grouped:
        key, key_pol = jax.random.split(key)
    k_policy, crop = _cifar_lane_draws(jax.random.split(key, batch), h, w)
    if policy_shape is None:
        return None, None, np.array(crop, np.int32)
    num_sub, num_op = policy_shape
    if grouped:
        sub, draws = jax_grouped_draws(np.asarray(key_pol), batch, groups, num_sub,
                                       num_op, h, w)
    else:
        sub, draws = jax_policy_draws(np.asarray(k_policy), num_sub, num_op, h, w)
    return sub, draws, np.array(crop, np.int32)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _imagenet_lane_draws(keys, h: int, w: int):
    """Per-image keys ``[B, 2]`` -> (``k_pol [B, 2]``, ints ``[B, 4]`` =
    (flip, order, cy, cx), factors ``[B, 3]``, alpha ``[B, 3]``), as
    ``_train_one`` and ``_color_jitter`` consume their keys."""
    def one(key):
        k_pol, k_flip, k_jit, k_light, k_cut = jax.random.split(key, 5)
        flip = (jax.random.uniform(k_flip) < 0.5).astype(jnp.int32)
        k_perm, k_b, k_c, k_s = jax.random.split(k_jit, 4)
        factors = jnp.stack([jax.random.uniform(k, (), minval=1 - 0.4, maxval=1 + 0.4)
                             for k in (k_b, k_c, k_s)])
        order = jax.random.randint(k_perm, (), 0, 6)
        alpha = jax.random.normal(k_light, (3,)) * 0.1
        ky, kx = jax.random.split(k_cut)
        cy = jax.random.randint(ky, (), 0, h)
        cx = jax.random.randint(kx, (), 0, w)
        return k_pol, jnp.stack([flip, order, cy, cx]).astype(jnp.int32), factors, alpha

    return jax.vmap(one)(keys)


def jax_imagenet_draws(key, batch: int, policy_shape, h: int, w: int,
                       dispatch: str = "exact", groups: int = 8) -> dict:
    """The draws of ``imagenet_train_batch(images[batch], key, policy,
    aug_dispatch=dispatch, aug_groups=groups)`` as numpy: ``{"sub_idx",
    "policy"}`` (None without a policy) and ``{"flip", "order", "factors",
    "alpha", "centre"}``.  Run it in the FMA-free reference process."""
    key = jnp.asarray(np.asarray(key, np.uint32))
    grouped = (dispatch == "grouped" and policy_shape is not None
               and policy_shape[0] > 1)
    if grouped:
        key, key_pol = jax.random.split(key)
    k_pol, ints, factors, alpha = _imagenet_lane_draws(jax.random.split(key, batch), h, w)
    ints = np.array(ints, np.int32)
    out = {"sub_idx": None, "policy": None, "flip": ints[:, 0].copy(),
           "order": ints[:, 1].copy(), "centre": ints[:, 2:].copy(),
           "factors": np.array(factors, np.float32), "alpha": np.array(alpha, np.float32)}
    if policy_shape is not None:
        num_sub, num_op = policy_shape
        if grouped:
            out["sub_idx"], out["policy"] = jax_grouped_draws(
                np.asarray(key_pol), batch, groups, num_sub, num_op, h, w)
        else:
            out["sub_idx"], out["policy"] = jax_policy_draws(np.asarray(k_pol), num_sub,
                                                             num_op, h, w)
    return out


def imagenet_draws_to_torch(d: dict, device="cpu"):
    """:func:`jax_imagenet_draws`' dict -> the port's ``ImageNetDraws``."""
    import torch  # not at import: the reference subprocess runs this file

    from fast_autoaugment_tpu_torch.ops.preprocess_imagenet import ImageNetDraws

    t = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in d.items()}
    return ImageNetDraws(**t)


class JaxDraws:
    """A draw source for the port's TTA, audit and train steps that replays
    the JAX key tree (keys are ``[..., 2]`` uint32 JAX keys as numpy).

    ``imagenet_table`` maps a key (a tuple of its two words) to the
    :func:`jax_imagenet_draws` dict of that key, drawn in the reference
    process."""

    def __init__(self, imagenet_table: dict | None = None):
        self.imagenet_table = imagenet_table or {}

    @staticmethod
    def _keys(key):
        return jnp.asarray(np.asarray(key, np.uint32))

    def fold_in(self, key, i, device):
        k = self._keys(key)
        flat = jax.vmap(lambda kk: jax.random.fold_in(kk, i))(k.reshape(-1, 2))
        return np.asarray(flat.reshape(k.shape), np.uint32)

    def split(self, key, num, device):
        k = self._keys(key)
        flat = jax.vmap(lambda kk: jax.random.split(kk, num))(k.reshape(-1, 2))
        return np.asarray(flat.reshape(k.shape[:-1] + (num, 2)), np.uint32)

    def draws(self, draw_keys, *, batch, num_sub, num_op, height, width, dispatch,
              groups, device):
        import torch  # not at import: the reference subprocess runs this file

        from fast_autoaugment_tpu_torch.search.tta import LaneDraws

        parts = [jax_cifar_draws(k, batch, (num_sub, num_op), height, width,
                                 dispatch, groups)
                 for k in np.asarray(draw_keys, np.uint32).reshape(-1, 2)]
        sub, pol, crop = (torch.from_numpy(np.concatenate(p)).to(device)
                          for p in zip(*parts))
        return LaneDraws(sub, pol, crop)

    def imagenet_draws(self, key, *, batch, policy_shape, height, width, dispatch, groups,
                       device):
        k = tuple(int(v) for v in np.asarray(key, np.uint32).reshape(2))
        d = self.imagenet_table[k]
        assert d["flip"].shape == (batch,) and d["centre"].max() < max(height, width)
        assert (d["sub_idx"] is None) == (policy_shape is None)
        return imagenet_draws_to_torch(d, device)


# ----------------------------------------- the self-check, in JAX alone


def _jax_cutout_at(img, v, centre):
    """``A._cutout_abs`` with its two uniforms given as ``centre``."""
    h, w = img.shape[0], img.shape[1]
    x0 = jnp.trunc(jnp.maximum(0.0, centre[0] - v / 2.0))
    y0 = jnp.trunc(jnp.maximum(0.0, centre[1] - v / 2.0))
    x1 = jnp.minimum(float(w), x0 + v)
    y1 = jnp.minimum(float(h), y0 + v)
    ys, xs = jnp.mgrid[0:h, 0:w]
    inside = ((xs.astype(jnp.float32) >= x0) & (xs.astype(jnp.float32) <= x1)
              & (ys.astype(jnp.float32) >= y0) & (ys.astype(jnp.float32) <= y1))
    out = jnp.where(inside[..., None], jnp.asarray(A.CUTOUT_COLOR, img.dtype), img)
    return jnp.where(v < 0.0, img, out)


def _jax_branches():
    fns = []
    for i, fn in enumerate(A._OP_FNS):
        if A.OP_NAMES[i] == "Cutout":
            fns.append(lambda img, v, c: jnp.where(
                v <= 0.0, img, _jax_cutout_at(img, v * img.shape[1], c)))
        elif A.OP_NAMES[i] == "CutoutAbs":
            fns.append(_jax_cutout_at)
        else:
            fns.append(functools.partial(lambda f, img, v, c: f(img, v, None), fn))
    return fns


@jax.jit
def jax_apply_from_draws(img, policy, sub_idx, draws):
    """``apply_policy`` written with the draws as inputs instead of a key,
    in JAX and with the JAX package's own ops."""
    op_low, op_high, op_mirror = A._op_range_constants()
    sub = policy[sub_idx]
    branches = _jax_branches()
    for i in range(policy.shape[1]):
        op_idx = sub[i, 0].astype(jnp.int32)
        value = sub[i, 2] * (op_high[op_idx] - op_low[op_idx]) + op_low[op_idx]
        value = value * jnp.where(op_mirror[op_idx] & (draws[i, 1] > 0.5), -1.0, 1.0)
        out = jax.lax.switch(op_idx, branches, img, value, draws[i, 2:4])
        img = jnp.where(draws[i, 0] < sub[i, 1], out, img)
    return img


def random_policy(rng, num_sub: int, num_op: int) -> np.ndarray:
    pol = np.zeros((num_sub, num_op, 3), np.float32)
    pol[..., 0] = rng.integers(0, A.NUM_OPS, (num_sub, num_op))
    pol[..., 1] = rng.uniform(0.0, 1.0, (num_sub, num_op))
    pol[..., 2] = rng.uniform(0.0, 1.0, (num_sub, num_op))
    return pol


@pytest.mark.parametrize("partitionable", [True, False])
def test_replay_reproduces_apply_policy(partitionable):
    """Replayed draws fed to the draws-as-inputs JAX program reproduce
    ``jit(apply_policy)`` bitwise, under either threefry mode (the mode in
    force by default here is ``jax.config.jax_threefry_partitionable``)."""
    rng = np.random.default_rng(3)
    policy = random_policy(rng, 6, 2)
    policy[0, 0, 0] = A.op_index("CutoutAbs")
    policy[1, 1, 0] = A.op_index("Cutout")
    policy[:, :, 1] = np.maximum(policy[:, :, 1], 0.5)
    h, w = 12, 10
    imgs = rng.integers(0, 256, (12, h, w, 3)).astype(np.float32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(500 + i), np.uint32) for i in range(12)])
    ref_fn = jax.jit(A.apply_policy)
    with jax.threefry_partitionable(partitionable):
        sub, draws = jax_policy_draws(keys, 6, 2, h, w)
        _, key_sub = split_policy_key(keys)
        for i in range(12):
            want = np.asarray(ref_fn(jnp.asarray(imgs[i]), jnp.asarray(policy), jnp.asarray(keys[i])))
            got = np.asarray(jax_apply_from_draws(jnp.asarray(imgs[i]), jnp.asarray(policy),
                                                  jnp.int32(sub[i]), jnp.asarray(draws[i])))
            assert np.array_equal(want, got), (i, partitionable)
            if partitionable == jax.config.jax_threefry_partitionable:
                # the mode in force: apply_policy is apply_subpolicy on the
                # (sub-policy, key) of its first split (the reference the
                # augment tests compile)
                via_sub = np.asarray(jax.jit(A.apply_subpolicy)(
                    jnp.asarray(imgs[i]), jnp.asarray(policy[sub[i]]), jnp.asarray(key_sub[i])))
                assert np.array_equal(want, via_sub), (i, partitionable)
    assert len(set(sub.tolist())) > 1  # several sub-policies were drawn


def test_grouped_replay_reproduces_grouped_kernel():
    """The grouped replay reproduces ``apply_policy_batch_grouped`` on a
    ragged batch (5 images in 2 chunks of 3: one padding duplicate)."""
    rng = np.random.default_rng(4)
    policy = random_policy(rng, 6, 2)  # the self-check's shapes: its compile is reused
    policy[:, :, 1] = 1.0
    h, w = 12, 10
    imgs = rng.integers(0, 256, (5, h, w, 3)).astype(np.float32)
    key = np.asarray(jax.random.PRNGKey(17), np.uint32)
    want = np.asarray(jax.jit(functools.partial(A.apply_policy_batch_grouped, groups=2))(
        jnp.asarray(imgs), jnp.asarray(policy), jnp.asarray(key)))
    sub, draws = jax_grouped_draws(key, 5, 2, 6, 2, h, w)
    got = np.stack([np.asarray(jax_apply_from_draws(
        jnp.asarray(imgs[i]), jnp.asarray(policy), jnp.int32(sub[i]), jnp.asarray(draws[i])))
        for i in range(5)])
    assert np.array_equal(want, got)


# ------------------------------- compiled JAX references, without FMA


def split_policy_key(keys):
    """``apply_policy``'s first split: per-image ``(key_choice, key_sub)``
    as two ``[B, 2]`` uint32 arrays."""
    pairs = np.stack([np.asarray(jax.random.split(jnp.asarray(k))) for k in keys])
    return pairs[:, 0].astype(np.uint32), pairs[:, 1].astype(np.uint32)


def _run_job(job: dict):
    if "threefry_partitionable" in job:
        jax.config.update("jax_threefry_partitionable", job["threefry_partitionable"])
    if "runner" in job:  # "module:function" of a test file, run here
        import importlib

        mod, fn = job["runner"].split(":")
        return getattr(importlib.import_module(mod), fn)(job)
    if job["kind"] == "imagenet_draws":
        return [jax_imagenet_draws(*call) for call in job["calls"]]
    if job["kind"] == "apply_subpolicy":
        # apply_policy(img, policy, key) == apply_subpolicy(img, policy[idx],
        # key_sub) with (idx, key_sub) from its first split; one compile
        # serves every policy, whatever its number of sub-policies
        fn = jax.jit(A.apply_subpolicy)
        return np.stack([np.asarray(fn(jnp.asarray(img), jnp.asarray(sub), jnp.asarray(k)))
                         for img, sub, k in zip(job["images"], job["subpolicies"], job["keys"])])
    if job["kind"] == "aot":
        from fast_autoaugment_tpu.serve.policy_server import AotPolicyApplier

        ap = AotPolicyApplier(job["policy"], image=job["image"], shapes=job["shapes"],
                              dispatch=job["dispatch"], groups=job["groups"])
        return {"dispatch": ap.dispatch,
                "outputs": [ap.apply(imgs, keys) for imgs, keys in job["calls"]]}
    if job["kind"] == "cifar_train_batch":
        from fast_autoaugment_tpu.ops.preprocess import cifar_train_batch

        fn = jax.jit(functools.partial(cifar_train_batch, cutout_length=job["cutout_length"],
                                       aug_dispatch=job["dispatch"], aug_groups=job["groups"]))
        return [np.asarray(fn(jnp.asarray(imgs), jnp.asarray(key),
                              policy=None if pol is None else jnp.asarray(pol)))
                for imgs, key, pol in job["calls"]]
    if job["kind"] == "cifar_eval_batch":
        from fast_autoaugment_tpu.ops.preprocess import cifar_eval_batch

        return np.asarray(jax.jit(cifar_eval_batch)(jnp.asarray(job["images"])))
    if job["kind"] == "tta":
        return _run_tta_job(job)
    raise ValueError(f"unknown reference job {job['kind']!r}")


def _run_tta_job(job: dict) -> list:
    """The JAX TTA entry points on a WideResNet with the given variables."""
    from fast_autoaugment_tpu.models.wideresnet import WideResNet
    from fast_autoaugment_tpu.search import tta

    model = WideResNet(*job["model"])
    params, stats = job["variables"]["params"], job["variables"]["batch_stats"]
    batches = [{"x": jnp.asarray(x), "y": jnp.asarray(y), "m": jnp.asarray(m)}
               for x, y, m in job["batches"]]
    out = []
    for run in job["runs"]:
        opts = dict(num_policy=run["num_policy"], cutout_length=run["cutout_length"],
                    aug_dispatch=run["dispatch"], aug_groups=run["groups"])
        if run["fn"] == "eval_tta":
            step = tta.make_tta_step(model, **opts)
            out.append(tta.eval_tta(step, params, stats, batches,
                                    jnp.asarray(run["policy"]), jnp.asarray(run["key"])))
        elif run["fn"] == "eval_tta_batched":
            step = tta.make_tta_step(model, num_candidates=len(run["policy"]), **opts)
            out.append(tta.eval_tta_batched(step, params, stats, batches,
                                            jnp.asarray(run["policy"]),
                                            jnp.asarray(run["key"])))
        elif run["fn"] == "audit":
            step = tta.make_audit_step(model, **opts)
            b = batches[run["batch"]]
            res = step(params, stats, b["x"], b["y"], b["m"], jnp.asarray(run["policy"]),
                       jnp.asarray(run["key"]))
            out.append({k: np.asarray(v) for k, v in res.items()})
        else:
            raise ValueError(f"unknown TTA run {run['fn']!r}")
    return out


def jax_reference(jobs: list[dict], tmp_dir) -> list:
    """Run reference jobs in a fresh process with FMA-free XLA:
    ``{"kind": "apply_subpolicy", "images", "subpolicies", "keys"}`` -> the
    stacked ``jit(apply_subpolicy)`` outputs; ``{"kind": "aot", "policy", "image",
    "shapes", "dispatch", "groups", "calls": [(images, keys), ...]}`` ->
    ``{"dispatch", "outputs"}`` of ``AotPolicyApplier.apply``;
    ``{"kind": "cifar_train_batch", "cutout_length", "dispatch", "groups",
    "calls": [(images, key, policy or None), ...]}`` -> the outputs;
    ``{"kind": "cifar_eval_batch", "images"}`` -> the output;
    ``{"kind": "tta", "model": (depth, widen, classes), "variables",
    "batches": [(x, y, m), ...], "runs": [...]}`` -> the result of each run
    (``eval_tta``, ``eval_tta_batched`` or one ``audit`` step call);
    ``{"kind": "imagenet_draws", "calls": [(key, batch, policy_shape, h, w,
    dispatch, groups), ...]}`` -> a :func:`jax_imagenet_draws` dict per call;
    ``{"runner": "module:function", ...}`` -> that function of a test module
    called with the job (a test file keeps its own JAX references).  A job
    may pin ``"threefry_partitionable"``."""
    return jax_reference_groups([jobs], tmp_dir)[0]


def jax_reference_groups(groups: list[list[dict]], tmp_dir) -> list[list]:
    """:func:`jax_reference` for several lists of jobs at once, one FMA-free
    process per list, the processes running side by side."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + NO_FMA_XLA_FLAGS).strip(),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for i, jobs in enumerate(groups):
        src = os.path.join(tmp_dir, f"jobs{i}.pkl")
        dst = os.path.join(tmp_dir, f"refs{i}.pkl")
        with open(src, "wb") as fh:
            pickle.dump(jobs, fh)
        procs.append((dst, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), src, dst], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out = []
    try:
        for dst, proc in procs:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            with open(dst, "rb") as fh:
                out.append(pickle.load(fh))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


if __name__ == "__main__":
    # python tests/test_torch_replay.py JOBS.pkl OUT.pkl (see jax_reference)
    assert NO_FMA_XLA_FLAGS in os.environ.get("XLA_FLAGS", "")
    with open(sys.argv[1], "rb") as fh:
        todo = pickle.load(fh)
    results = [_run_job(j) for j in todo]
    with open(sys.argv[2], "wb") as fh:
        pickle.dump(results, fh)
