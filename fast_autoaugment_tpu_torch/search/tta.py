"""Density-matching TTA evaluation: the search's inner loop
(``fast_autoaugment_tpu/search/tta.py``).

Every candidate policy of phase 2 is scored on a fold model's held-out
split: ``num_policy`` (P) independently augmented copies of each batch go
through the frozen model, and per batch the step records

- ``minus_loss_sum``: minus the MINIMUM NLL over all (draw, sample) pairs
  of the batch, masked -- a batch-global scalar, not per sample;
- ``correct_sum``: per sample, whether ANY draw was top-1 correct;
- ``correct_mean_sum``: per sample, the MEAN top-1 correctness over draws;
- ``cnt``: the number of real (unmasked) samples.

:func:`eval_tta` sums those over a fold and normalizes by the count.

One step is one pass over the P x B lanes of a batch: the sampler makes
every lane's draws, the augmentation kernel applies the candidate policy
(one launch per op slot over all lanes), the CIFAR stack kernel crops,
flips, normalizes and cuts out (one launch), the model runs ONE forward
over the flattened batch in eval mode, and the reductions run as torch
ops.  With ``num_candidates=K`` the step gains a leading candidate axis:
the K x P x B lanes still go through one launch per kernel and one
forward, and candidate k's fields are those of the single step on
``(policy[k], key[k])``, up to the convolutions' batch-size-dependent
rounding.

Randomness comes from a *draw source*: keys in, per-lane draws out
(:class:`PhiloxDraws`, the port's counter-based one, is the default).  The
key tree follows the JAX package: a batch's key is ``fold_in(key, i)``,
its P draw keys are ``split(key, P)``, and each draw key makes the draws
of one ``cifar_train_batch`` call.  The tests pass a source that replays
the JAX key tree, so the port is held against the JAX step lane for lane.

The weights live in the module: the step takes the model when it is made,
so ``eval_tta(step, batches, policy, key)`` drops the JAX ``params`` and
``batch_stats`` arguments (load a fold's weights with
``model.load_state_dict``).  The step runs on the device of its inputs,
under ``torch.no_grad``, and puts the model in eval mode.  The JAX
module's trace counter and compile seam (``seam_jit``), its dispatch
enqueue guard and its telemetry spans are not ported (ROADMAP Queue 1
item 12); the ``trace(t0, t1)`` callback is.  Each stage of a step runs in
a ``torch.profiler.record_function`` range (``tta.sampler``,
``tta.augment``, ``tta.model``, ``tta.reductions``), so a profiler trace
splits the device time by stage; outside a profiler a range costs about a
microsecond.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from fast_autoaugment_tpu_torch.core.metrics import Accumulator
from fast_autoaugment_tpu_torch.core.telemetry import mono
from fast_autoaugment_tpu_torch.ops import rng
from fast_autoaugment_tpu_torch.ops.augment import (
    sample_crop,
    sample_exact,
    sample_grouped,
    sample_imagenet,
)
from fast_autoaugment_tpu_torch.ops.preprocess import cifar_train_batch
from fast_autoaugment_tpu_torch.ops.preprocess_imagenet import ImageNetDraws

__all__ = ["AUG_DISPATCH_MODES", "LaneDraws", "PhiloxDraws", "cifar_augment_fn",
           "make_tta_step", "make_audit_step", "eval_tta", "eval_tta_batched"]

AUG_DISPATCH_MODES = ("exact", "grouped")


@dataclass
class LaneDraws:
    """Every random draw of a set of lanes (one lane = one augmented image).

    ``sub_idx [L]`` int32 indexes the step's policy tensor, ``policy
    [L, num_op, 4]`` float32 holds the op slots' (gate, mirror, cutout x,
    cutout y), ``crop [L, 5]`` int32 the CIFAR stack's (oy, ox, flip, cy,
    cx)."""

    sub_idx: torch.Tensor
    policy: torch.Tensor
    crop: torch.Tensor


class PhiloxDraws:
    """The port's draw source: Philox4x32-10 keys (``[..., 2]`` int64
    tensors of 32-bit words), bit-identical on the CPU and the card.  It
    makes the draws of the CIFAR stack (:meth:`draws`) and of the ImageNet
    stack (:meth:`imagenet_draws`).

    A draw key's lanes are its images: lane b's key is ``split(draw_key,
    B)[b]``, which gives the exact sampler's sub-policy and op-slot draws
    and the CIFAR stack's draws.  Under ``grouped`` a multi-sub policy is
    sampled per draw key by the grouped sampler over the B images (a
    permutation cut into ``groups`` chunks, one sub-policy per chunk); a
    single-sub policy takes the exact sampler, as in the JAX package."""

    @staticmethod
    def key(key, device) -> torch.Tensor:
        if not torch.is_tensor(key):
            key = np.asarray(key, np.int64)
        return torch.as_tensor(key, dtype=torch.int64, device=device)

    def fold_in(self, key, i: int, device) -> torch.Tensor:
        return rng.fold_in(self.key(key, device), i)

    def split(self, key, num: int, device) -> torch.Tensor:
        return rng.split(self.key(key, device), num)

    def draws(self, draw_keys, *, batch: int, num_sub: int, num_op: int, height: int,
              width: int, dispatch: str, groups: int, device) -> LaneDraws:
        keys = self.key(draw_keys, device).reshape(-1, 2)
        lanes = rng.split(keys, batch).reshape(-1, 2)  # [D * B, 2], draw-major
        crop = sample_crop(lanes, height, width)
        if dispatch == "grouped" and num_sub > 1:
            per_draw = [sample_grouped(k, batch, groups, num_sub, num_op, height, width)
                        for k in keys]
            sub = torch.cat([s for s, _ in per_draw])
            pol = torch.cat([d for _, d in per_draw])
        else:
            sub, pol = sample_exact(lanes, num_sub, num_op, height, width)
        return LaneDraws(sub, pol, crop)

    def imagenet_draws(self, key, *, batch: int, policy_shape: tuple[int, int] | None,
                       height: int, width: int, dispatch: str, groups: int,
                       device) -> ImageNetDraws:
        """The draws of one ``imagenet_train_batch`` call on `batch` images
        from one key, in the JAX tree's shape: under ``grouped`` with a
        multi-sub policy the key is split first and its second half draws
        the grouped policy; image b's lane key is ``split(key, batch)[b]``,
        which gives its exact policy draws and its stack draws
        (:func:`~fast_autoaugment_tpu_torch.ops.augment.sample_imagenet`).
        ``policy_shape`` is ``(num_sub, num_op)``, or None without a
        policy."""
        key = self.key(key, device).reshape(2)
        grouped = dispatch == "grouped" and policy_shape is not None and policy_shape[0] > 1
        if grouped:
            key, key_pol = rng.split(key, 2)
        lanes = rng.split(key, batch)
        ints, floats = sample_imagenet(lanes, height, width)
        sub = pol = None
        if policy_shape is not None:
            num_sub, num_op = policy_shape
            if grouped:
                sub, pol = sample_grouped(key_pol, batch, groups, num_sub, num_op, height, width)
            else:
                sub, pol = sample_exact(lanes, num_sub, num_op, height, width)
        return ImageNetDraws(sub, pol, flip=ints[:, 0].contiguous(),
                             order=ints[:, 1].contiguous(), factors=floats[:, :3].contiguous(),
                             alpha=floats[:, 3:].contiguous(), centre=ints[:, 2:].contiguous())


def check_aug_dispatch(mode: str) -> str:
    if mode not in AUG_DISPATCH_MODES:
        raise ValueError(f"aug_dispatch must be one of {AUG_DISPATCH_MODES}, got {mode!r}")
    return mode


def cifar_augment_fn(cutout_length: int) -> Callable:
    """The default ``augment_fn``: the CIFAR-family train stack, i.e. the
    policy (augmentation kernel), then crop/flip/normalize/cutout (CIFAR
    stack kernel)."""

    def augment_fn(images: torch.Tensor, policy: torch.Tensor,
                   draws: LaneDraws) -> torch.Tensor:
        return cifar_train_batch(images, draws.crop, policy=policy, sub_idx=draws.sub_idx,
                                 policy_draws=draws.policy, cutout_length=cutout_length)

    return augment_fn


def _score(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> dict:
    """The TTA reductions over ``logits [..., P, B, C]`` (``search/tta.py:132-160``)."""
    labels = labels.to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.reshape(1, -1, 1).expand(*logits.shape[:-1], 1)
    nll = -torch.gather(logp, -1, idx)[..., 0]  # [..., P, B]
    correct = torch.argmax(logits, dim=-1) == labels  # [..., P, B]
    valid = mask > 0
    # batch-global min loss over every (draw, sample) pair, masked
    nll_masked = torch.where(valid, nll, torch.full_like(nll, float("inf")))
    minus_loss = -torch.amin(nll_masked, dim=(-2, -1))
    # per-sample best across draws (the reference's reward)
    correct_max = correct.any(dim=-2) & valid
    # per-sample MEAN across draws (what the sub-policy audit ranks by)
    correct_mean = correct.to(torch.float32).mean(dim=-2) * valid
    return {
        "minus_loss_sum": minus_loss,
        "correct_sum": correct_max.sum(dim=-1).to(torch.float32),
        "correct_mean_sum": correct_mean.sum(dim=-1),
        "cnt": mask.sum().to(torch.float32).expand(minus_loss.shape),
    }


class _Step:
    """A TTA or audit step bound to its model and draw source; ``fold_in``
    derives per-batch keys the way the source's keys do."""

    def __init__(self, fn: Callable, draw_source):
        self._fn = fn
        self.draw_source = draw_source

    def __call__(self, images, labels, mask, policy, key) -> dict:
        with torch.no_grad():
            return self._fn(images, labels, mask, policy, key)

    def fold_in(self, key, i: int, device):
        with record_function("tta.sampler"):
            return self.draw_source.fold_in(key, i, device)


def _lanes(images: torch.Tensor, copies: int) -> torch.Tensor:
    """``[B, H, W, 3]`` -> float32 ``[copies * B, H, W, 3]``, copy-major."""
    x = images.to(torch.float32)
    return x.repeat(copies, 1, 1, 1)


def make_tta_step(model: torch.nn.Module, *, num_policy: int = 5, cutout_length: int = 16,
                  augment_fn: Callable | None = None, num_candidates: int | None = None,
                  aug_dispatch: str = "exact", aug_groups: int = 8, draw_source=None):
    """Build the TTA step.

    With ``num_candidates=None`` (default) returns ``step(images_u8,
    labels, mask, policy, key) -> {"minus_loss_sum", "correct_sum",
    "correct_mean_sum", "cnt"}`` (0-dim float32 tensors on the inputs'
    device) where `policy` is a ``[num_sub, num_op, 3]`` tensor applied
    `num_policy` times with independent draws.

    With ``num_candidates=K``, `policy` is ``[K, num_sub, num_op, 3]``,
    `key` a ``[K]`` stack of per-candidate keys, and every field gains a
    leading ``[K]``; all ``K * P * B`` lanes go through one launch per
    kernel and one forward.

    `augment_fn(images [L, H, W, 3] float32, policy, draws: LaneDraws) ->
    [L, 3, H, W]` replaces the CIFAR train stack.  ``aug_dispatch`` picks
    how a multi-sub policy is sampled (``exact``: per image; ``grouped``:
    per chunk of `aug_groups`)."""
    check_aug_dispatch(aug_dispatch)
    src = draw_source or PhiloxDraws()
    augment_fn = augment_fn or cifar_augment_fn(cutout_length)
    p = int(num_policy)
    model.eval()

    def run(images, labels, mask, policy, key):
        dev = images.device
        b, h, w = int(images.shape[0]), int(images.shape[1]), int(images.shape[2])
        policy = torch.as_tensor(policy, dtype=torch.float32, device=dev)
        k = 1 if num_candidates is None else int(num_candidates)
        if num_candidates is not None and policy.shape[0] != k:
            raise ValueError(f"candidate axis {policy.shape[0]} != num_candidates {k}")
        pol = policy.reshape((k,) + tuple(policy.shape[-3:]))
        num_sub, num_op = int(pol.shape[1]), int(pol.shape[2])
        with record_function("tta.sampler"):
            draw_keys = src.split(key, p, dev).reshape(-1, 2)  # [K * P, 2]
            d = src.draws(draw_keys, batch=b, num_sub=num_sub, num_op=num_op, height=h,
                          width=w, dispatch=aug_dispatch, groups=aug_groups, device=dev)
            if k > 1:  # candidate c's lanes index its own block of sub-policies
                cand = torch.arange(k * p * b, device=dev) // (p * b)
                d.sub_idx = (d.sub_idx.to(torch.int64) + cand * num_sub).to(torch.int32)
        with record_function("tta.augment"):
            augmented = augment_fn(_lanes(images, k * p),
                                   pol.reshape(k * num_sub, num_op, 3), d)
        with record_function("tta.model"):
            logits = model(augmented).to(torch.float32)
        with record_function("tta.reductions"):
            out = _score(logits.reshape(k, p, b, -1), labels, mask)
        if num_candidates is None:
            out = {f: v[0] for f, v in out.items()}
        return out

    return _Step(run, src)


def make_audit_step(model: torch.nn.Module, *, num_policy: int = 5, cutout_length: int = 16,
                    augment_fn: Callable | None = None, aug_dispatch: str = "exact",
                    aug_groups: int = 8, draw_source=None):
    """Batched sub-policy audit step: ``step(images_u8, labels, mask, subs
    [S, num_op, 3], key) -> {"correct_mean_sum": [S], "cnt": scalar}``, the
    mean-over-draws top-1 of every sub-policy alone in one pass over
    ``S * P * B`` lanes.  Draw ``(s, p)`` takes key ``split(key, S * P)[s * P
    + p]`` and applies sub-policy s alone; a single-sub policy is sampled
    the same way under either dispatch."""
    check_aug_dispatch(aug_dispatch)
    src = draw_source or PhiloxDraws()
    augment_fn = augment_fn or cifar_augment_fn(cutout_length)
    p = int(num_policy)
    model.eval()

    def run(images, labels, mask, subs, key):
        dev = images.device
        b, h, w = int(images.shape[0]), int(images.shape[1]), int(images.shape[2])
        subs = torch.as_tensor(subs, dtype=torch.float32, device=dev)
        s, num_op = int(subs.shape[0]), int(subs.shape[1])
        with record_function("tta.sampler"):
            draw_keys = src.split(key, s * p, dev).reshape(-1, 2)
            d = src.draws(draw_keys, batch=b, num_sub=1, num_op=num_op, height=h, width=w,
                          dispatch=aug_dispatch, groups=aug_groups, device=dev)
            d.sub_idx = (torch.arange(s * p * b, device=dev) // (p * b)).to(torch.int32)
        with record_function("tta.augment"):
            augmented = augment_fn(_lanes(images, s * p), subs, d)
        with record_function("tta.model"):
            logits = model(augmented).to(torch.float32).reshape(s, p, b, -1)
        with record_function("tta.reductions"):
            correct = torch.argmax(logits, dim=-1) == labels.to(torch.int64)
            correct_mean = correct.to(torch.float32).mean(dim=1) * (mask > 0)  # [S, B]
            return {"correct_mean_sum": correct_mean.sum(dim=1),
                    "cnt": mask.sum().to(torch.float32)}

    return _Step(run, src)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eval_tta(tta_step, batches, policy, key, trace=None) -> dict:
    """Run the TTA step over a fold's batches; returns ``{"minus_loss",
    "top1_valid", "top1_mean", "cnt"}`` normalized by the sample count
    (reference ``search.py:117-133``).

    `batches` yields ``{"x", "y", "m"}`` dicts on one device
    (:func:`~fast_autoaugment_tpu_torch.data.pipeline.device_batches`
    uploads a fold once for every trial).  Batch i's key is
    ``fold_in(key, i)``.  The sums stay on the device, in float32, until
    the end.  `trace(t0, t1)` (optional) receives each step's start and end
    monotonic times; tracing synchronizes after each step, which never
    changes values."""
    acc = Accumulator()
    for i, batch in enumerate(batches):
        dev = batch["x"].device
        t0 = mono()
        out = tta_step(batch["x"], batch["y"], batch["m"], policy,
                       tta_step.fold_in(key, i, dev))
        if trace is not None:
            _sync(dev)
            trace(t0, mono())
        acc.add_dict(out)
    cnt = acc["cnt"]
    return {
        "minus_loss": acc["minus_loss_sum"] / cnt if cnt else 0.0,
        "top1_valid": acc["correct_sum"] / cnt if cnt else 0.0,
        "top1_mean": acc["correct_mean_sum"] / cnt if cnt else 0.0,
        "cnt": cnt,
    }


def eval_tta_batched(tta_step_k, batches, policies, keys, trace=None) -> list[dict]:
    """Batched counterpart of :func:`eval_tta`: K candidate policies
    (``[K, num_sub, num_op, 3]``) with a ``[K]`` stack of trial keys through
    a ``make_tta_step(num_candidates=K)`` step, one pass per batch.
    Candidate k's batch key is ``fold_in(keys[k], i)``, as a sequential
    :func:`eval_tta` with ``key=keys[k]`` derives it.  Each batch's fields
    come back to the host and are summed there in float32, as the JAX
    package does; `trace(t0, t1)` receives each step's window."""
    sums: dict[str, np.ndarray] | None = None
    for i, batch in enumerate(batches):
        dev = batch["x"].device
        t0 = mono()
        out = tta_step_k(batch["x"], batch["y"], batch["m"], policies,
                         tta_step_k.fold_in(keys, i, dev))
        out = {f: v.cpu().numpy() for f, v in out.items()}
        if trace is not None:
            trace(t0, mono())
        sums = out if sums is None else {f: sums[f] + out[f] for f in sums}
    if sums is None:
        k_dim = int(np.shape(policies)[0])
        sums = {f: np.zeros(k_dim, np.float32) for f in
                ("minus_loss_sum", "correct_sum", "correct_mean_sum", "cnt")}
    results = []
    for k in range(int(sums["cnt"].shape[0])):
        cnt = float(sums["cnt"][k])
        results.append({
            "minus_loss": float(sums["minus_loss_sum"][k]) / cnt if cnt else 0.0,
            "top1_valid": float(sums["correct_sum"][k]) / cnt if cnt else 0.0,
            "top1_mean": float(sums["correct_mean_sum"][k]) / cnt if cnt else 0.0,
            "cnt": cnt,
        })
    return results
