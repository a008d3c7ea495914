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
(one launch for all op slots over all lanes), the CIFAR stack kernel crops,
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
under ``torch.no_grad``, and puts the model in eval mode.

Over a fold (:func:`eval_tta`, :func:`eval_tta_batched`,
:func:`eval_audit`) the step on the card is the counterpart of the JAX
package's one compiled program per argument shape: one CUDA graph per
policy shape and batch shape, captured at its first use (a warm-up step,
then capture under deterministic cuDNN) and replayed once per batch (a
fold padded to one batch shape needs one graph), with
the batch, policy and key staged into static buffers and the batch index a
device counter (``_GraphedSums``).  :func:`~fast_autoaugment_tpu_torch.
search.census.executable_census` counts the graphs.  Every batch is one
dispatch through the dispatch guard and the telemetry seam (labels ``tta``,
``tta_batched``, ``audit``); the first call of each label goes through the
compile seam (``core/compilecache.py``).  Each stage of a step runs in
a ``torch.profiler.record_function`` range (``tta.sampler``,
``tta.augment``, ``tta.model``, ``tta.reductions``), so a profiler trace
splits the device time by stage; outside a profiler a range costs about a
microsecond.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from fast_autoaugment_tpu_torch.core import compilecache, telemetry
from fast_autoaugment_tpu_torch.core.telemetry import mono
from fast_autoaugment_tpu_torch.core.watchdog import capture_guard, dispatch_enqueue_guard
from fast_autoaugment_tpu_torch.ops import _kernels, rng
from fast_autoaugment_tpu_torch.ops.augment import (
    sample_crop_plain,
    sample_exact_plain,
    sample_grouped_plain,
    sample_imagenet_plain,
)
from fast_autoaugment_tpu_torch.ops.preprocess import cifar_train_batch
from fast_autoaugment_tpu_torch.ops.preprocess_imagenet import ImageNetDraws, imagenet_train_batch
from fast_autoaugment_tpu_torch.ops.shake import ModelNoise, noise_layout

__all__ = ["AUG_DISPATCH_MODES", "LaneDraws", "PhiloxDraws", "prng_key", "lane_draws_plain",
           "imagenet_draws_plain", "mixup_draws_plain", "train_draws",
           "cifar_augment_fn", "imagenet_augment_fn", "make_tta_step", "make_audit_step",
           "eval_tta", "eval_tta_batched", "eval_audit"]

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
    makes the draws of the CIFAR stack (:meth:`draws`), of the ImageNet
    stack (:meth:`imagenet_draws`), and a train step's model noise
    (:meth:`model_noise`) and mixup draws (:meth:`mixup_draws`).

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
        grouped = dispatch == "grouped" and num_sub > 1
        if _kernels.on_card(keys):  # the whole record in one launch
            kw = dict(batch=batch, num_sub=num_sub, num_op=num_op, height=height, width=width,
                      crop=True)
            rec = (_kernels.sampler_grouped(keys.contiguous(), groups=groups, **kw) if grouped
                   else _kernels.sampler_lanes(keys.contiguous(), **kw))
            return LaneDraws(rec["sub"], rec["pol"], rec["crop"])
        return lane_draws_plain(keys, batch, num_sub, num_op, height, width, grouped, groups)

    def model_noise(self, sites, batch: int, key_shake, key_drop, device) -> ModelNoise:
        """The model's noise of one train step (``ops/shake.py ModelNoise.draw``)."""
        return ModelNoise.draw(sites, batch, self.key(key_shake, device),
                               self.key(key_drop, device))

    def mixup_draws(self, key, batch: int, alpha: float, device):
        """``(lam, perm)`` of one ``mixup_batch`` call (``core/metrics.py:66-68``)
        at ``alpha > 0``: the key splits into ``(key_lam, key_perm)``; ``lam``
        is a 0-dim ``Beta(alpha, alpha)`` draw rounded once to float32,
        ``perm`` a permutation of the batch.  On the card one launch of the
        train-noise kernel."""
        key = self.key(key, device).reshape(2)
        if _kernels.on_card(key):
            out = _kernels.train_noise(mix_keys=key.reshape(1, 2).contiguous(), perm_n=batch,
                                       gamma=rng.gamma_constants(alpha))
            return out["lam"].reshape(()), out["perm"]
        return mixup_draws_plain(key, batch, alpha)

    def train_draws(self, sites, batch: int, key_shake, key_drop, key_mix, alpha: float,
                    device) -> tuple:
        """``(noise, lam, perm)`` of one train step (:func:`train_draws`).  On
        the card one launch of the train-noise kernel makes them all."""
        keys = [self.key(k, device).reshape(2) for k in (key_shake, key_drop, key_mix)]
        if not _kernels.on_card(keys[0]):
            return train_draws(self, sites, batch, *keys, alpha, device)
        lay = noise_layout(sites, batch) if sites else None
        mix = alpha > 0.0
        out = _kernels.train_noise(
            batch=batch, sites=lay, key_shake=keys[0].contiguous(),
            key_drop=keys[1].contiguous(),
            mix_keys=keys[2].reshape(1, 2).contiguous() if mix else None,
            perm_n=batch if mix else 0, gamma=rng.gamma_constants(alpha) if mix else None)
        noise = ModelNoise.from_packed(lay, out["packed"]) if sites else None
        return (noise, out["lam"].reshape(()), out["perm"]) if mix else (noise, None, None)

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
        policy.  On the card the whole record is one launch."""
        key = self.key(key, device).reshape(1, 2)
        grouped = dispatch == "grouped" and policy_shape is not None and policy_shape[0] > 1
        if _kernels.on_card(key):
            return _imagenet_records(key, batch, policy_shape, height, width, grouped, groups)
        return imagenet_draws_plain(key, batch, policy_shape, height, width, grouped, groups)

    def imagenet_lane_draws(self, draw_keys, *, batch: int, num_sub: int, num_op: int,
                            height: int, width: int, dispatch: str, groups: int,
                            device) -> ImageNetDraws:
        """The draws of D ``imagenet_train_batch`` calls, one per draw key
        (``[D, 2]``), on the same `batch` images: draw-major lanes, as the
        TTA step lays them out (the JAX step maps ``imagenet_train_batch``
        over the split keys, ``search/tta.py:120-127``).  On the card the
        whole record of all D keys is one launch."""
        keys = self.key(draw_keys, device).reshape(-1, 2)
        grouped = dispatch == "grouped" and num_sub > 1
        if _kernels.on_card(keys):
            return _imagenet_records(keys, batch, (num_sub, num_op), height, width, grouped,
                                     groups)
        return imagenet_draws_plain(keys, batch, (num_sub, num_op), height, width, grouped,
                                    groups)


def lane_draws_plain(keys: torch.Tensor, batch: int, num_sub: int, num_op: int, height: int,
                     width: int, grouped: bool, groups: int) -> LaneDraws:
    """The plain version of :meth:`PhiloxDraws.draws` on the draw keys
    ``[D, 2]``, on any device: per draw key a Python loop of the plain
    samplers under ``grouped``."""
    lanes = rng.split_plain(keys, batch).reshape(-1, 2)  # [D * B, 2], draw-major
    crop = sample_crop_plain(lanes, height, width)
    if grouped:
        per_draw = [sample_grouped_plain(k, batch, groups, num_sub, num_op, height, width)
                    for k in keys]
        sub = torch.cat([s for s, _ in per_draw])
        pol = torch.cat([d for _, d in per_draw])
    else:
        sub, pol = sample_exact_plain(lanes, num_sub, num_op, height, width)
    return LaneDraws(sub, pol, crop)


def imagenet_draws_plain(keys: torch.Tensor, batch: int, policy_shape, height: int, width: int,
                         grouped: bool, groups: int) -> ImageNetDraws:
    """The plain version of :meth:`PhiloxDraws.imagenet_lane_draws` on the
    draw keys ``[D, 2]`` (``policy_shape`` None: no policy), on any device:
    a Python loop over the keys."""
    per_key = []
    for key in keys:
        if grouped:
            key, key_pol = rng.split_plain(key, 2)
        lanes = rng.split_plain(key, batch)
        ints, floats = sample_imagenet_plain(lanes, height, width)
        sub = pol = None
        if policy_shape is not None:
            num_sub, num_op = policy_shape
            if grouped:
                sub, pol = sample_grouped_plain(key_pol, batch, groups, num_sub, num_op,
                                                height, width)
            else:
                sub, pol = sample_exact_plain(lanes, num_sub, num_op, height, width)
        per_key.append(ImageNetDraws(sub, pol, flip=ints[:, 0].contiguous(),
                                     order=ints[:, 1].contiguous(),
                                     factors=floats[:, :3].contiguous(),
                                     alpha=floats[:, 3:].contiguous(),
                                     centre=ints[:, 2:].contiguous()))
    if len(per_key) == 1:
        return per_key[0]
    return ImageNetDraws(*(None if getattr(per_key[0], f.name) is None
                           else torch.cat([getattr(d, f.name) for d in per_key])
                           for f in dataclasses.fields(ImageNetDraws)))


def train_draws(src, sites, batch: int, key_shake, key_drop, key_mix, alpha: float,
                device) -> tuple:
    """``(noise, lam, perm)`` of one train step from a draw source's
    ``model_noise`` (None without sites) and ``mixup_draws`` (Nones at
    ``alpha == 0``), in that order: a draw source's ``train_draws``, which
    the train step calls."""
    noise = src.model_noise(sites, batch, key_shake, key_drop, device) if sites else None
    lam, perm = src.mixup_draws(key_mix, batch, alpha, device) if alpha > 0.0 else (None, None)
    return noise, lam, perm


def mixup_draws_plain(key: torch.Tensor, batch: int, alpha: float) -> tuple:
    """The plain version of :meth:`PhiloxDraws.mixup_draws` from a key
    ``[2]``, on any device."""
    key_lam, key_perm = rng.split_plain(key, 2)
    return (rng.beta_symmetric(key_lam, alpha).to(torch.float32),
            rng.permutation(key_perm, batch))


def _imagenet_records(keys: torch.Tensor, batch: int, policy_shape, height: int, width: int,
                      grouped: bool, groups: int) -> ImageNetDraws:
    """:meth:`PhiloxDraws.imagenet_lane_draws` of CUDA keys in one launch."""
    kw = dict(batch=batch, height=height, width=width, imagenet=True)
    if grouped:
        rec = _kernels.sampler_grouped(keys.contiguous(), groups=groups, num_sub=policy_shape[0],
                                       num_op=policy_shape[1], presplit=True, **kw)
    elif policy_shape is not None:
        rec = _kernels.sampler_lanes(keys.contiguous(), num_sub=policy_shape[0],
                                     num_op=policy_shape[1], **kw)
    else:
        rec = _kernels.sampler_lanes(keys.contiguous(), **kw)
    return ImageNetDraws(rec.get("sub"), rec.get("pol"), flip=rec["flip"], order=rec["order"],
                         factors=rec["factors"], alpha=rec["alpha"], centre=rec["centre"])


def prng_key(seed: int) -> np.ndarray:
    """The words of ``jax.random.PRNGKey(seed)`` as a ``[2]`` uint32 array:
    a key every draw source takes."""
    return np.asarray([(int(seed) >> 32) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF], np.uint32)


def check_aug_dispatch(mode: str) -> str:
    if mode not in AUG_DISPATCH_MODES:
        raise ValueError(f"aug_dispatch must be one of {AUG_DISPATCH_MODES}, got {mode!r}")
    return mode


def imagenet_augment_fn(cutout_length: int) -> Callable:
    """An ``augment_fn`` of the TTA and audit steps: the ImageNet train
    stack (the policy, then flip/ColorJitter/lighting/normalize/cutout), as
    the JAX driver wires ``imagenet_train_batch`` into its TTA and audit
    steps (``search/driver.py:336-345``).  Its lanes take the draws of one
    ImageNet train batch per draw key: its ``lane_draws`` names the draw
    source's method that makes them (``PhiloxDraws.imagenet_lane_draws``)."""

    def augment_fn(images: torch.Tensor, policy: torch.Tensor,
                   draws: ImageNetDraws) -> torch.Tensor:
        return imagenet_train_batch(images, draws, policy=policy, cutout_length=cutout_length)

    augment_fn.lane_draws = "imagenet_lane_draws"
    return augment_fn


def _lane_draws(src, augment_fn: Callable) -> Callable:
    """The draw source's method that makes `augment_fn`'s lane draws: the
    one its ``lane_draws`` names, else ``draws`` (:class:`LaneDraws`, the
    CIFAR stack's)."""
    return getattr(src, getattr(augment_fn, "lane_draws", "draws"))


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


#: how a step's fold sums add its batches' fields, as the JAX package's
#: loops do: float32 from zero (``eval_tta``'s ``Accumulator``), float32
#: from the first batch's fields (``eval_tta_batched``'s host sums), or
#: float64 from zero (the audit's host sums)
ACCUMULATE = ("float32", "float32_from_first", "float64")


class _Step:
    """A TTA or audit step bound to its model and draw source.

    Called directly it runs one batch eagerly.  :meth:`sums` runs it over a
    fold's batches and returns the fold's sums on the device: on a CUDA
    device as one CUDA-graph replay per batch (:class:`_GraphedSums`), on
    the CPU as the same step run eagerly (:func:`_eager_sums`).  `label`
    names its dispatches in the telemetry seam (``tta``, ``tta_batched``,
    ``audit``); `accumulate` is one of :data:`ACCUMULATE`."""

    def __init__(self, fn: Callable, draw_source, label: str, accumulate: str):
        if accumulate not in ACCUMULATE:
            raise ValueError(f"accumulate must be one of {ACCUMULATE}, got {accumulate!r}")
        self._fn = fn
        self.draw_source = draw_source
        self.label = label
        self.accumulate = accumulate
        self._graphs: dict[tuple, _GraphedSums] = {}
        self._lock = threading.Lock()

    def __call__(self, images, labels, mask, policy, key) -> dict:
        with torch.no_grad():
            return self._fn(images, labels, mask, policy, key)

    def fold_in(self, key, i, device):
        with record_function("tta.sampler"):
            return self.draw_source.fold_in(key, i, device)

    def num_graphs(self) -> int:
        """The CUDA graphs this step holds (``search/census.py``)."""
        with self._lock:
            return sum(len(g.graphs) for g in self._graphs.values())

    def _accumulate(self, sums: dict | None, out: dict, i) -> dict:
        """Add batch `i`'s fields to `sums` in place (a new zero buffer
        when None), in the order and precision that `accumulate` names."""
        with torch.no_grad():
            if sums is None:
                dtype = torch.float64 if self.accumulate == "float64" else torch.float32
                sums = {f: torch.zeros(v.shape, dtype=dtype, device=v.device)
                        for f, v in out.items()}
            for f, v in out.items():
                if self.accumulate == "float32_from_first":
                    sums[f].copy_(torch.where(i == 0, v, sums[f] + v) if torch.is_tensor(i)
                                  else (v if i == 0 else sums[f] + v))
                else:
                    sums[f].add_(v.to(sums[f].dtype))
        return sums

    def sums(self, batches, policy, key, trace=None) -> dict:
        """The fold's sums of every field over `batches` (a list, or any
        iterable of batches: a lazy fold's stream), batch i under key
        ``fold_in(key, i)`` (a ``[K]`` stack of keys folds each).  Each
        batch is one dispatch through the telemetry seam, and `trace(t0,
        t1)` (optional) receives each batch's window, which synchronizes
        after each batch (values never change).  On the card, graph capture
        or replay failures raise; the step's lock covers a fold's staging,
        replays and readback, so callers on other threads wait for it."""
        batches = iter(batches)
        first = next(batches, None)
        if first is None:
            return None
        batches = itertools.chain([first], batches)
        dev = first["x"].device
        if dev.type != "cuda":
            return _eager_sums(self, batches, policy, key, trace)
        policy = torch.as_tensor(policy, dtype=torch.float32, device=dev)
        key = self.draw_source.key(key, dev)
        with self._lock:
            graphed = self._graphs.setdefault((tuple(policy.shape), tuple(key.shape)),
                                              _GraphedSums())
            return graphed.run(self, first, batches, policy, key, trace)


def _eager_sums(step: _Step, batches, policy, key, trace=None) -> dict:
    """:meth:`_Step.sums` run eagerly: the step's call on each batch, its
    fields added in the step's order and precision.  It is the path on the
    CPU, and on the card the reference that the graphs are held against."""
    out_sums = None
    for i, batch in enumerate(batches):
        dev = batch["x"].device
        t0 = mono()
        with dispatch_enqueue_guard():
            out = step(batch["x"], batch["y"], batch["m"], policy, step.fold_in(key, i, dev))
            out_sums = step._accumulate(out_sums, out, i)
        if trace is not None and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        t1 = mono()
        if trace is not None:
            trace(t0, t1)
        telemetry.record_dispatch(step.label, t0, t1, blocking=trace is not None)
    return out_sums


def _batch_shape(batch) -> tuple:
    return tuple((f, tuple(batch[f].shape), batch[f].dtype) for f in ("x", "y", "m"))


class _GraphedSums:
    """A step over folds of one policy shape on the card: one CUDA graph
    per batch shape, each captured at its first use and replayed once a
    batch.

    The policy, the key, a device counter (the batch index) and the sums
    are static buffers shared by the graphs; each graph stages its batch
    into buffers of its own.  The key's ``fold_in`` reads the counter at
    replay time, so every batch draws the eager path's bits, and each
    replay advances it; the sums accumulate on the device in the eager
    path's order and precision.  A fold is one staging of the policy and
    key, then per batch a copy of the batch and one replay; the sums are
    read once.  A fold padded to one batch shape needs one graph; a ragged
    last batch adds a second, captured in the middle of the fold.

    A capture runs a warm-up step eagerly on a side stream (it reads the
    static buffers and writes none of them), then captures on it under
    deterministic cuDNN, whatever the caller's flags, in ``thread_local``
    mode, so other threads may launch, copy and synchronize their streams
    while it captures (the overlapped phases of the search pipeline);
    captures take ``core/watchdog.py capture_guard``, one at a time in the
    process.  The launches the capture records count once per replay
    (``ops/_kernels.py count_replays``)."""

    def __init__(self):
        self.graphs: dict[tuple, tuple] = {}  # batch shape -> (graph, buffers, tally)
        self.sums = None

    def _capture(self, step, batch, policy, key) -> tuple:
        dev = policy.device
        first = self.sums is None
        if first:
            self.policy, self.key = torch.empty_like(policy), torch.empty_like(key)
            self.counter = torch.zeros((), dtype=torch.int64, device=dev)
        bufs = {f: torch.empty_like(batch[f]) for f in ("x", "y", "m")}
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        cudnn = torch.backends.cudnn
        flags = cudnn.benchmark, cudnn.deterministic
        cudnn.benchmark, cudnn.deterministic = False, True
        try:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                if first:
                    self.policy.copy_(policy)
                    self.key.copy_(key)
                for f in bufs:
                    bufs[f].copy_(batch[f])
                # the warm-up: cuDNN's plans, the kernels' one-time set-up,
                # and (at the first capture) the sums' shapes
                out = step(bufs["x"], bufs["y"], bufs["m"], self.policy,
                           step.fold_in(self.key, self.counter, dev))
                if first:
                    self.sums = step._accumulate(None, out, 0)
            side.synchronize()
            graph = torch.cuda.CUDAGraph()
            with _kernels.counting_capture() as tally, \
                    torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                key_i = step.fold_in(self.key, self.counter, dev)
                out = step(bufs["x"], bufs["y"], bufs["m"], self.policy, key_i)
                step._accumulate(self.sums, out, self.counter)
                self.counter.add_(1)
        finally:
            cudnn.benchmark, cudnn.deterministic = flags
        main.wait_stream(side)
        return graph, bufs, tally

    def _graph(self, step, batch, policy, key) -> tuple:
        shape = _batch_shape(batch)
        if shape not in self.graphs:
            with compilecache.timed_first(step.label), dispatch_enqueue_guard(), \
                    capture_guard():
                self.graphs[shape] = self._capture(step, batch, policy, key)
        return self.graphs[shape]

    def run(self, step, first, batches, policy, key, trace) -> dict:
        self._graph(step, first, policy, key)
        with dispatch_enqueue_guard():
            self.policy.copy_(policy, non_blocking=True)
            self.key.copy_(key, non_blocking=True)
            self.counter.zero_()
            for v in self.sums.values():
                v.zero_()
        stream = torch.cuda.current_stream(policy.device)
        for batch in batches:
            graph, bufs, tally = self._graph(step, batch, policy, key)
            t0 = mono()
            with dispatch_enqueue_guard():
                for f in bufs:
                    bufs[f].copy_(batch[f], non_blocking=True)
                graph.replay()
            _kernels.count_replays(tally)
            if trace is not None:
                stream.synchronize()
            t1 = mono()
            if trace is not None:
                trace(t0, t1)
            telemetry.record_dispatch(step.label, t0, t1, blocking=trace is not None)
        return {f: v.clone() for f, v in self.sums.items()}


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

    `augment_fn(images [L, H, W, 3] float32, policy, draws) -> [L, 3, H, W]`
    is the train stack the lanes go through: :func:`cifar_augment_fn` (the
    default) over :class:`LaneDraws`, or one whose ``lane_draws`` names the
    draw source's method for its draws (:func:`imagenet_augment_fn`).
    ``aug_dispatch`` picks how a multi-sub policy is sampled (``exact``: per
    image; ``grouped``: per chunk of `aug_groups`).  Over a fold (:func:`eval_tta`) the step on
    the card replays one CUDA graph per batch, so an `augment_fn` that reads
    values on the host (the kernels' plain versions) runs there only eagerly,
    through ``_eager_sums``."""
    check_aug_dispatch(aug_dispatch)
    src = draw_source or PhiloxDraws()
    augment_fn = augment_fn or cifar_augment_fn(cutout_length)
    lane_draws = _lane_draws(src, augment_fn)
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
            d = lane_draws(draw_keys, batch=b, num_sub=num_sub, num_op=num_op, height=h,
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

    if num_candidates is None:
        return _Step(run, src, "tta", "float32")
    return _Step(run, src, "tta_batched", "float32_from_first")


def make_audit_step(model: torch.nn.Module, *, num_policy: int = 5, cutout_length: int = 16,
                    augment_fn: Callable | None = None, aug_dispatch: str = "exact",
                    aug_groups: int = 8, draw_source=None):
    """Batched sub-policy audit step: ``step(images_u8, labels, mask, subs
    [S, num_op, 3], key) -> {"correct_mean_sum": [S], "cnt": scalar}``, the
    mean-over-draws top-1 of every sub-policy alone in one pass over
    ``S * P * B`` lanes.  Draw ``(s, p)`` takes key ``split(key, S * P)[s * P
    + p]`` and applies sub-policy s alone; a single-sub policy is sampled
    the same way under either dispatch.  `augment_fn` is the TTA step's.
    Over a fold (:func:`eval_audit`) it replays one CUDA graph
    per batch on the card, as the TTA step does."""
    check_aug_dispatch(aug_dispatch)
    src = draw_source or PhiloxDraws()
    augment_fn = augment_fn or cifar_augment_fn(cutout_length)
    lane_draws = _lane_draws(src, augment_fn)
    p = int(num_policy)
    model.eval()

    def run(images, labels, mask, subs, key):
        dev = images.device
        b, h, w = int(images.shape[0]), int(images.shape[1]), int(images.shape[2])
        subs = torch.as_tensor(subs, dtype=torch.float32, device=dev)
        s, num_op = int(subs.shape[0]), int(subs.shape[1])
        with record_function("tta.sampler"):
            draw_keys = src.split(key, s * p, dev).reshape(-1, 2)
            d = lane_draws(draw_keys, batch=b, num_sub=1, num_op=num_op, height=h, width=w,
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

    return _Step(run, src, "audit", "float64")


def eval_tta(tta_step, batches, policy, key, trace=None) -> dict:
    """Run the TTA step over a fold's batches; returns ``{"minus_loss",
    "top1_valid", "top1_mean", "cnt"}`` normalized by the sample count
    (reference ``search.py:117-133``).

    `batches` is a list of ``{"x", "y", "m"}`` dicts on one device
    (:func:`~fast_autoaugment_tpu_torch.data.pipeline.device_batches`
    uploads a fold once for every trial).  Batch i's key is ``fold_in(key,
    i)``.  The sums stay on the device, in float32, until the end; on the
    card each batch is one CUDA-graph replay (``_Step.sums``).  `trace(t0,
    t1)` (optional) receives each batch's window."""
    sums = tta_step.sums(batches, policy, key, trace)
    if sums is None:
        return {"minus_loss": 0.0, "top1_valid": 0.0, "top1_mean": 0.0, "cnt": 0.0}
    vals = {f: float(v) for f, v in sums.items()}
    cnt = vals["cnt"]
    return {
        "minus_loss": vals["minus_loss_sum"] / cnt if cnt else 0.0,
        "top1_valid": vals["correct_sum"] / cnt if cnt else 0.0,
        "top1_mean": vals["correct_mean_sum"] / cnt if cnt else 0.0,
        "cnt": cnt,
    }


def eval_tta_batched(tta_step_k, batches, policies, keys, trace=None) -> list[dict]:
    """Batched counterpart of :func:`eval_tta`: K candidate policies
    (``[K, num_sub, num_op, 3]``) with a ``[K]`` stack of trial keys through
    a ``make_tta_step(num_candidates=K)`` step, one pass per batch.
    Candidate k's batch key is ``fold_in(keys[k], i)``, as a sequential
    :func:`eval_tta` with ``key=keys[k]`` derives it.  The fields are summed
    in float32 from the first batch's, as the JAX package sums them on the
    host, but on the device, and read once; `trace(t0, t1)` receives each
    batch's window."""
    sums = tta_step_k.sums(batches, policies, keys, trace)
    if sums is None:
        k_dim = int(np.shape(policies)[0])
        sums = {f: np.zeros(k_dim, np.float32) for f in
                ("minus_loss_sum", "correct_sum", "correct_mean_sum", "cnt")}
    else:
        sums = {f: v.cpu().numpy() for f, v in sums.items()}
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


def eval_audit(audit_step, batches, subs, key) -> tuple[np.ndarray, float]:
    """The audit step over a fold's batches, batch i under ``fold_in(key,
    i)``: the float64 sums of ``correct_mean_sum`` (``[S]``) and of
    ``cnt``, as the JAX driver adds them on the host."""
    sums = audit_step.sums(batches, subs, key)
    if sums is None:
        return np.zeros(int(np.shape(subs)[0])), 0.0
    return sums["correct_mean_sum"].cpu().numpy(), float(sums["cnt"])
