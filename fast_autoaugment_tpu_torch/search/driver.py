"""Three-phase policy search by density matching
(``fast_autoaugment_tpu/search/driver.py``), on its default path.

The reference's ``search.py:137-312``: (1) pretrain K models on CV
resamples without augmentation, (2) per fold run TPE over
{op, prob, level}^(num_policy x num_op) with a test-time-augmentation
reward against the held-out fold, keep each fold's top trials, decode and
de-duplicate them into ``final_policy_set``, (3) retrain with and without
the found policies (``launch/search_cli.py``).

Ported here, as the JAX package runs them with its defaults:

- phase 1 fold by fold through ``train_and_eval`` (each fold's model is a
  checkpoint in the JAX package's format; a complete one is not trained
  again), the fold-oracle quality gate with its fresh-seed retrains and the
  promotion of a better retrain with every file beside it;
- phase 2 with the sequential TPE loop (``trial_batch`` 1) or K candidates
  per round through ``eval_tta_batched`` (``trial_batch`` K > 1), the
  trial log ``search_trials.json`` persisted after every trial or round and
  resumed from, and a trial whose evaluation raises quarantined (told to
  the TPE as the worst reward so far, recorded, never ranked);
- the ranking with ``remove_duplicates``, the per-sub-policy audit
  (``audit_sub_policies``) and the random control arm; ``final_policy.json``
  (and ``random_final_policy.json``).

Keys follow the JAX package's tree: fold f's key has the words of
``PRNGKey(seed * 77 + f)``, trial t's is ``fold_in(key_fold, t)``, the
quality baseline's ``PRNGKey(17)``; they go through the draw source
(the port's Philox draws by default, ``search/tta.py PhiloxDraws``).
Wall times are reported as ``device_secs_*`` (and the legacy
``tpu_secs_*`` alias) = wall x 1 device, with ``backend`` saying which
device measured them.  Each phase runs in a ``torch.profiler.
record_function`` range (``search.phase1``, ``search.phase2``,
``search.audit``), so a profiler trace splits a run by phase.

Every fold model and gate retrain trains through ``train_and_eval`` with
the run's ``device_cache`` (the device-resident path for in-memory
datasets under the default ``"auto"``: CUDA-graph dispatches on the card, a
loop on the CPU) and ``steps_per_dispatch``, and the result stamps both, as
the JAX driver does (``:861-877``).

The runtime seams, as the JAX driver wires them (``:720-1260``,
``:1544-1687``):

- ``async_pipeline="on"`` runs phase 2 as the actor/learner pipeline
  (``search/pipeline.py``: ``pipeline_actors`` actor threads,
  ``pipeline_queue_depth`` rounds proposed ahead) and overlaps phase-1 fold
  training (a trainer thread) with it; the trial log and the policy are
  those of the serial run with the same window (bit for bit with one actor
  and depth 0; any number of actors gives the trial log of one);
- ``watchdog`` (``"off"``, ``"auto"``, seconds): one
  ``DispatchWatchdog`` shared by the evaluations and the trainer;
- ``divergence_retries`` for every training run;
- ``telemetry_spec`` arms the journal (``core/telemetry.py``) and
  ``compile_cache`` the kernels' cache (``core/compilecache.py``);
- ``search_result.json`` gains ``resilience.watchdog``, ``watchdog_fires``,
  ``compile_cache``, ``pipeline`` (the dispatch-gap summary and the overlap
  timeline), and the graph census ``tta_executables[_first]`` (and
  ``tta_batched_executables[_first]``) with their ``_expected`` counts: one
  CUDA graph per policy shape on the card, none on the CPU; a census above
  its expectation writes the result with a ``failure`` record and raises.

A fold's held-out split is uploaded once and replayed by every trial when
the dataset is in memory; a lazy (on-disk) dataset, ImageNet, streams
instead (JAX ``:398-434``): every evaluation decodes the fold anew through
the prefetch worker (``data/pipeline.py prefetch``), with ``random_crop_box``
boxes drawn from ``default_rng(0)`` (the same crops at every pass), full
batches (the last padded), into the same graphed TTA and audit steps.  On
ImageNet those steps augment with the ImageNet train stack
(``make_tta_step(augment_fn=imagenet_augment_fn(cutout))``), as the JAX driver wires
``imagenet_train_batch`` in (``:336-345``), at ``conf["imgsize"]`` or the
model's input size.

The fleet tier (JAX ``:779-1100``, ``:1229-1240``, ``:1452-1464``,
``:1688-1814``):

- ``work_queue`` (a ``launch/workqueue.py WorkQueue``) scatters whole folds
  across peer hosts: each claims ``p1-fold<k>`` and then ``p2-fold<k>``
  units off the lease queue (its start on the card, ``_FoldEval.warm_up``,
  paid before the first claim), renews the lease and beats at every trainer
  dispatch, between a first dispatch's warm-up step and its graph capture,
  and at every persisted trial (``_lease_heartbeat``), writes its
  trial log per fold (``search_trials.fold<k>.json``: one writer per
  lease), reclaims the stale leases of dead hosts and stamps the
  degraded-completion accounting (``degraded``, ``lost_hosts``,
  ``reclaimed_units``, ``resilience.fleet``).  The async pipeline and fold
  stacking are forced off: the queue already scatters folds;
- ``fleet_transport`` (a ``search/pipeline.py FleetTransport``) scatters
  ask ROUNDS across actor hosts: this host is the learner (the pipeline is
  forced on, its rounds go out through the transport's backend, each
  gate-cleared fold checkpoint is published for the actors, and
  ``search_done`` marks the end); :func:`search_actor` is the actor
  host's entry.  The two are mutually exclusive.

Refused, naming the ROADMAP item that ports it: fold stacking
(``fold_stack`` != 0 outside the work queue, item 10b).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from fast_autoaugment_tpu_torch.core import fsfault, telemetry
from fast_autoaugment_tpu_torch.core.checkpoint import load_checkpoint, read_metadata
from fast_autoaugment_tpu_torch.core.compilecache import (
    compile_cache_stats,
    configure_compile_cache,
)
from fast_autoaugment_tpu_torch.core.device import resolve_device
# the search's artifacts are written fsync-then-rename through the shared
# seam, whose temporary file is the writer's own: the hosts of a work queue
# may write one artifact at the same time
from fast_autoaugment_tpu_torch.core.fsfault import write_json_atomic
from fast_autoaugment_tpu_torch.core.resilience import (
    DispatchHungError,
    PreemptedError,
    install_signal_handlers,
)
from fast_autoaugment_tpu_torch.core.watchdog import arm_dispatch_serializer, resolve_watchdog
from fast_autoaugment_tpu_torch.data.datasets import cv_split, load_dataset
from fast_autoaugment_tpu_torch.data.pipeline import (
    BatchIterator,
    device_batches,
    eval_batches,
    prefetch,
    stage_batch,
)
from fast_autoaugment_tpu_torch.models import get_model, input_image_size, num_class
from fast_autoaugment_tpu_torch.ops.augment import SEARCH_OP_NAMES
from fast_autoaugment_tpu_torch.ops.preprocess_imagenet import random_crop_box
from fast_autoaugment_tpu_torch.policies.archive import (
    policy_decoder,
    policy_to_tensor,
    remove_duplicates,
)
from fast_autoaugment_tpu_torch.search.census import executable_census
from fast_autoaugment_tpu_torch.search.pipeline import (
    DispatchTrace,
    _failure_text,
    replay_trial_log,
    resolve_async_pipeline,
    run_fleet_actor,
    run_fold_pipeline,
    run_overlapped_phases,
)
from fast_autoaugment_tpu_torch.search.tpe import TPE, choice, uniform
from fast_autoaugment_tpu_torch.search.tta import (
    PhiloxDraws,
    check_aug_dispatch,
    eval_audit,
    eval_tta,
    eval_tta_batched,
    imagenet_augment_fn,
    make_audit_step,
    make_tta_step,
    prng_key,
)
from fast_autoaugment_tpu_torch.train.trainer import train_and_eval
from fast_autoaugment_tpu_torch.utils import faultinject
from fast_autoaugment_tpu_torch.utils.interop import flax_layout, flax_to_tensors
from fast_autoaugment_tpu_torch.utils.logging import get_logger
from fast_autoaugment_tpu_torch.utils.profiling import PhaseStopwatch

__all__ = ["search_policies", "search_actor", "make_search_space", "SearchResult",
           "resolve_quality_floor", "write_json_atomic", "draw_random_policy_set",
           "audit_sub_policies"]

logger = get_logger("faa_torch.search")


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def _stack_keys(keys: list):
    return torch.stack(keys) if torch.is_tensor(keys[0]) else np.stack(keys)


def resolve_quality_floor(floor, num_classes: int) -> float | None:
    """The fold-oracle quality floor: ``"auto"`` is ``chance + 0.35 * (1 -
    chance)`` (0.415 on a 10-class task); floats pass through;
    ``None``/``"off"``/``"none"`` or a non-positive value turns the gate off."""
    if floor is None:
        return None
    if isinstance(floor, str):
        if floor == "auto":
            chance = 1.0 / num_classes
            return chance + 0.35 * (1.0 - chance)
        if floor.lower() in ("off", "none"):
            return None
        floor = float(floor)
    return floor if floor > 0 else None


def make_search_space(num_policy: int, num_op: int):
    """The reference's search space (``search.py:214-220``): per (i, j) an op
    choice over the 15 searchable ops, prob ~ U(0,1), level ~ U(0,1)."""
    space = []
    for i in range(num_policy):
        for j in range(num_op):
            space.append(choice(f"policy_{i}_{j}", len(SEARCH_OP_NAMES)))
            space.append(uniform(f"prob_{i}_{j}", 0, 1))
            space.append(uniform(f"level_{i}_{j}", 0, 1))
    return space


class SearchResult(dict):
    @property
    def final_policy_set(self):
        return self["final_policy_set"]


def draw_random_policy_set(num_subs: int, num_policy: int, num_op: int, seed: int) -> list:
    """Uniform draws from the space of :func:`make_search_space`, decoded and
    de-duplicated as TPE proposals are: the phase-3 control arm."""
    rng = np.random.RandomState(seed)
    out: list = []
    stalled = 0
    while len(out) < num_subs:
        proposal = {}
        for i in range(num_policy):
            for j in range(num_op):
                proposal[f"policy_{i}_{j}"] = int(rng.randint(len(SEARCH_OP_NAMES)))
                proposal[f"prob_{i}_{j}"] = float(rng.rand())
                proposal[f"level_{i}_{j}"] = float(rng.rand())
        before = len(out)
        out = remove_duplicates(out + policy_decoder(proposal, num_policy, num_op))
        # dedup is by op-name sequence: asking for more subs than the
        # sequence space holds can never finish
        stalled = stalled + 1 if len(out) == before else 0
        if stalled >= 50:
            raise ValueError(
                f"cannot draw {num_subs} distinct sub-policies: the op-sequence space holds "
                f"only {len(SEARCH_OP_NAMES) ** num_op} and {len(out)} are already drawn")
    return out[:num_subs]


def _fold_ckpt_path(save_dir: str, conf, fold: int, cv_ratio: float) -> str:
    tag = f"{conf['model']['type']}_{conf['dataset']}_fold{fold}_ratio{cv_ratio:.2f}"
    return os.path.join(save_dir, f"{tag}.msgpack")


# every file train_and_eval writes for a checkpoint: the payload, its
# sidecar, the restore-chain link and its sidecar, and the scalar logs; a
# retry's promotion moves (or removes) all of them
_CKPT_SUFFIXES = ("", ".meta.json", ".prev", ".prev.meta.json",
                  "_train.jsonl", "_valid.jsonl", "_test.jsonl")


def _replace_ckpt(src: str, dst: str):
    """Promote a retrained fold checkpoint with every file beside it."""
    for suffix in _CKPT_SUFFIXES:
        if os.path.exists(dst + suffix):
            os.remove(dst + suffix)
        if os.path.exists(src + suffix):
            shutil.move(src + suffix, dst + suffix)


def _remove_ckpt(path: str):
    for suffix in _CKPT_SUFFIXES:
        if os.path.exists(path + suffix):
            os.remove(path + suffix)


def _call_train_fold_fn(fn: Callable, conf, fold: int, path: str, seed: int):
    """A phase-1 training override ``fn(conf, fold, save_path, seed=...)``;
    a three-argument one gets the seed as ``conf['seed']``."""
    import inspect

    try:
        params = inspect.signature(fn).parameters
        takes_seed = "seed" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
    except (TypeError, ValueError):
        takes_seed = False
    conf = conf.replace(**{"seed": seed})
    if takes_seed:
        return fn(conf, fold, path, seed=seed)
    return fn(conf, fold, path)


class _FoldEval:
    """The TTA machinery shared by the quality gate, phase 2 and the audit:
    one model whose weights are a fold checkpoint's, the TTA, batched TTA
    and audit steps on it, and each fold's held-out batches uploaded once.

    Evaluations come from several threads under the async pipeline (the
    actors, and the overlapped trainer's quality gate): one lock covers
    loading a fold's weights into the model and the evaluation on them, so
    an evaluation always runs on the weights it asked for.  Each
    evaluation is one window of the watchdog (labels ``tta``,
    ``tta_batched``, ``audit``) when it is on, and `trace` (a
    ``DispatchTrace``) receives its batches' windows."""

    def __init__(self, conf, dataroot, *, num_policy, num_op, cv_ratio, trial_batch: int = 1,
                 aug_dispatch: str = "exact", aug_groups: int = 8, device="cuda",
                 draw_source=None, watchdog=None, trace=None):
        self.conf, self.dataroot = conf, dataroot
        self.num_policy, self.num_op, self.cv_ratio = num_policy, num_op, cv_ratio
        self.trial_batch = max(1, int(trial_batch))
        self.aug_dispatch = check_aug_dispatch(aug_dispatch)
        self.aug_groups = max(1, int(aug_groups))
        self.dev = resolve_device(device)
        self.draw_source = draw_source or PhiloxDraws()
        self.watchdog = resolve_watchdog(watchdog)
        self.trace = trace
        self._built = False
        self._warm = False
        self._loaded = None  # (path, digest) of the weights in the model
        self._batches: dict[int, list] = {}
        self._lock = threading.RLock()
        # distinct leading policy shapes fed to the TTA step and candidate
        # counts fed to the batched one: the census expects one graph each
        self.policy_shapes: set[int] = set()
        self.batch_policy_shapes: set[int] = set()

    def _build(self):
        with self._lock:
            if self._built:
                return
            conf = self.conf
            dataset_name = conf["dataset"]
            self.num_classes = num_class(dataset_name)
            self.total_train, _test = load_dataset(dataset_name, self.dataroot)
            model_conf = dict(conf["model"], dataset=dataset_name)
            model_conf.setdefault("precision", conf.get("precision", "f32"))
            self.model = get_model(model_conf, self.num_classes, device=self.dev)
            self.layout = flax_layout(self.model)
            # conf['imgsize'] as train_and_eval reads it: phase 2 evaluates the
            # fold models at the resolution they trained at
            self.image = int(conf.get("imgsize", 0) or 0) or input_image_size(
                dataset_name, conf["model"]["type"])
            imagenet = dataset_name.endswith("imagenet")
            cutout = int(conf.get("cutout", 0) or 0)
            kw = dict(num_policy=self.num_policy, cutout_length=cutout,
                      aug_dispatch=self.aug_dispatch, aug_groups=self.aug_groups,
                      draw_source=self.draw_source,
                      augment_fn=imagenet_augment_fn(cutout) if imagenet else None)
            self.tta_step = make_tta_step(self.model, **kw)
            self.audit_step = make_audit_step(self.model, **kw)
            self.tta_step_batch = (make_tta_step(self.model, num_candidates=self.trial_batch,
                                                 **kw) if self.trial_batch > 1 else None)
            self._built = True

    def warm_up(self, batch: int) -> None:
        """Pay this process's one-time start on the card before its first
        claim of fleet work, so that no lease has to outlast it: the kernel
        libraries, the fold data and model, and the model's first forward and
        backward pass at `batch` (the cuDNN and cuBLAS kernels a process loads
        on first use, which made a fresh host's first train dispatch take
        10-13 s on an NVIDIA H100 80GB HBM3 shared by six search processes).
        No draw is taken and the model's weights and statistics are
        untouched.  A no-op on the CPU and after the first call."""
        if self.dev.type != "cuda" or self._warm:
            return
        from fast_autoaugment_tpu_torch.ops import _kernels

        _kernels.load_libraries()
        self._build()
        with self._lock:
            training = self.model.training
            self.model.eval()
            x = torch.zeros((batch, self.image, self.image, 3),
                            device=self.dev).permute(0, 3, 1, 2)
            out = self.model(x)
            torch.autograd.grad(out.float().sum(),
                                [p for p in self.model.parameters() if p.requires_grad])
            torch.cuda.synchronize(self.dev)
            self.model.train(training)
        self._warm = True

    def load_fold(self, path: str) -> None:
        """Put the weights and BatchNorm statistics of the checkpoint at
        `path` into the model (a no-op when they are there already)."""
        self._build()
        with self._lock:
            ident = (path, (read_metadata(path) or {}).get("digest"))
            if self._loaded == ident:
                return
            tree = load_checkpoint(path)
            live = self.model.state_dict()
            with torch.no_grad():
                for name, arr in flax_to_tensors(tree, self.layout).items():
                    live[name].copy_(torch.from_numpy(arr))
            self._loaded = ident

    def batches(self, fold: int):
        """The fold's held-out split in full batches (the last one padded,
        so every batch has one shape): uploaded on first use for an
        in-memory dataset, a :class:`_FoldStream` for a lazy one."""
        self._build()
        with self._lock:
            if fold not in self._batches:
                _train_idx, valid_idx = cv_split(self.total_train.labels, self.cv_ratio, fold)
                batch = int(self.conf["batch"])
                if self.total_train.lazy:
                    self._batches[fold] = _FoldStream(self.total_train, valid_idx, batch,
                                                      self.image, self.dev)
                else:
                    self._batches[fold] = device_batches(
                        eval_batches(self.total_train, valid_idx, batch, pad_multiple=batch),
                        self.dev)
            return self._batches[fold]

    def policy_tensor(self, policies) -> torch.Tensor:
        return torch.as_tensor(policy_to_tensor(policies), device=self.dev)

    def _guarded(self, label: str, path: str, fn, *args):
        """Load `path`'s weights and run ``fn(*args)`` on them, under the
        lock and (when on) the watchdog."""
        with self._lock:
            self.load_fold(path)
            if not self.watchdog.enabled:
                return fn(*args)
            return self.watchdog.run(label, fn, *args)

    def _trace_cb(self):
        return self.trace.record if self.trace is not None else None

    def evaluate(self, fold: int, path: str, policy_t, key) -> dict:
        self._build()
        self.policy_shapes.add(int(policy_t.shape[0]))
        return self._guarded("tta", path, eval_tta, self.tta_step, self.batches(fold), policy_t,
                             key, self._trace_cb())

    def evaluate_batch(self, fold: int, path: str, policies_t, keys) -> list[dict]:
        """K candidates (``[K, num_sub, num_op, 3]``, K = trial_batch) with the
        ``[K]`` stack of their trial keys, in one pass per batch."""
        self._build()
        if self.tta_step_batch is None:
            raise RuntimeError("evaluate_batch requires trial_batch > 1")
        if int(policies_t.shape[0]) != self.trial_batch:
            raise ValueError(f"candidate axis {int(policies_t.shape[0])} != trial_batch "
                             f"{self.trial_batch}")
        self.batch_policy_shapes.add(int(policies_t.shape[0]))
        return self._guarded("tta_batched", path, eval_tta_batched, self.tta_step_batch,
                             self.batches(fold), policies_t, keys, self._trace_cb())

    def audit_fold(self, fold: int, path: str, subs, key) -> tuple[np.ndarray, float]:
        """The audit step over the fold's batches, batch i under ``fold_in(key,
        i)``: the float64 sums (``[S]`` and the count)."""
        self._build()
        return self._guarded("audit", path, eval_audit, self.audit_step, self.batches(fold),
                             subs, key)

    def baseline(self, fold: int, path: str) -> float:
        """The fold's accuracy under the identity policy (one all-zero
        sub-policy: op 0 gated at prob 0) through the same TTA step."""
        ident = torch.zeros((1, self.num_op, 3), dtype=torch.float32, device=self.dev)
        out = self.evaluate(fold, path, ident, prng_key(17))
        return float(out["top1_mean"])


class _FoldStream:
    """A lazy fold's held-out split as a stream (JAX ``_batches_locked``,
    ``:398-434``): each iteration decodes the fold anew in the prefetch
    worker, ``random_crop_box`` boxes drawn from ``default_rng(0)`` (so every
    pass gives the same bytes), full batches with the last one padded, each
    staged in pinned memory and copied to `device` in the worker as a
    ``{"x", "y", "m"}`` dict.  The decoder is the native loader on the card
    and ``"auto"`` on the CPU."""

    def __init__(self, dataset, indices, batch: int, image: int, device):
        box = lambda rng, w, h: random_crop_box(rng, w, h, image)  # noqa: E731
        self.it = BatchIterator(dataset, indices, eval_box_fn=box, imgsize=image,
                                decoder="native" if device.type == "cuda" else "auto")
        self.batch, self.device = batch, device

    def __len__(self):
        return -(-len(self.it) // self.batch)

    def _to_device(self, item) -> dict:
        x, y, m = (t.to(self.device, non_blocking=True) for t in stage_batch(item, self.device))
        return {"x": x, "y": y.to(torch.int64), "m": m}

    def __iter__(self):
        return prefetch(self.it.eval_epoch(self.batch, pad_multiple=self.batch),
                        transform=self._to_device)


def search_policies(conf, dataroot: str, save_dir: str, *, cv_num: int = 5,
                    cv_ratio: float = 0.4, num_policy: int = 5, num_op: int = 2,
                    num_search: int = 200, num_top: int = 10, smoke_test: bool = False,
                    resume: bool = True, train_fold_fn: Callable | None = None, until: int = 2,
                    folds: list[int] | None = None, seed: int = 0,
                    fold_quality_floor=None, fold_retrain_tries: int = 2,
                    phase1_epochs: int | None = None, audit_floor: float | None = None,
                    random_control: bool = False, trial_batch: int = 1, fold_stack=0,
                    aug_dispatch: str = "exact", aug_groups: int = 8,
                    device_cache: str = "auto", steps_per_dispatch: int = 1,
                    divergence_retries: int = 0, ckpt_keep: int = 2, watchdog="off",
                    work_queue=None, compile_cache: str = "off", async_pipeline="off",
                    pipeline_actors: int = 1, pipeline_queue_depth: int = 1,
                    telemetry_spec: str = "off", fleet_transport=None, topup_trials: int = 0,
                    device="cuda", draw_source=None, host_step: str = "graph") -> SearchResult:
    """Run phases 1 and 2; returns the final policy set and the accounting.

    The arguments are the JAX ``search_policies``' (its docstring has them
    in full); `device` (``"cuda"``, or ``"cpu"`` for the plain versions of
    the kernels) and `draw_source` are the port's.  `train_fold_fn(conf,
    fold, save_path, seed=...)` overrides phase-1 training; `folds`
    restricts both phases to a subset of folds; `fold_quality_floor` turns
    on the gate (folds whose identity-policy accuracy stays below it after
    `fold_retrain_tries` fresh-seed retrains are excluded from ranking);
    `phase1_epochs` overrides ``conf['epoch']`` for phase 1; `audit_floor`
    (None: off) drops each selected sub-policy whose own mean-over-draws fold
    accuracy falls below ``audit_floor`` x the fold baseline; `trial_batch`
    K > 1 evaluates K constant-liar proposals per round; `topup_trials`
    extends a finished search's per-fold budget; `random_control` adds the
    random arm; `async_pipeline`, `pipeline_actors`, `pipeline_queue_depth`,
    `watchdog`, `divergence_retries`, `compile_cache` and `telemetry_spec`
    are the runtime seams of the module docstring; `host_step` is
    ``train_and_eval``'s, for phase 1's host-fed training; `work_queue` and
    `fleet_transport` are the fleet tier of the module docstring.  The
    unported options raise."""
    if work_queue is not None and fold_stack not in (None, 0, "0"):
        # lease units are per fold: a stacked group would advance folds
        # this host does not own
        logger.warning("workqueue: fold stacking forced off - work units are per fold")
        fold_stack = 0
    if fold_stack not in (None, 0, "0"):
        _refuse(f"fold stacking (fold_stack={fold_stack!r})", "10b")
    if fleet_transport is not None and work_queue is not None:
        raise ValueError(
            "fleet_transport and work_queue are mutually exclusive: the round transport "
            "scatters ask ROUNDS across actor hosts, the lease workqueue scatters whole FOLDS "
            "across peer searches")
    dev = resolve_device(device)
    # flag-setting SIGTERM/SIGUSR1 handlers (here, on the caller's thread:
    # the overlapped trainer thread cannot install them)
    install_signal_handlers()
    src = draw_source or PhiloxDraws()
    if smoke_test:  # reference --smoke-test (search.py:153, 235)
        num_search = 4
    topup_trials = max(0, int(topup_trials))
    base_num_search = num_search
    num_search += topup_trials
    # the kernels' cache and the journal ("off" still honours the
    # FAA_COMPILE_CACHE / FAA_TELEMETRY handoff)
    configure_compile_cache(compile_cache)
    telemetry.configure_telemetry(telemetry_spec)
    pipeline_on = resolve_async_pipeline(async_pipeline)
    pipeline_actors = max(1, int(pipeline_actors))
    pipeline_queue_depth = max(0, int(pipeline_queue_depth))
    if fleet_transport is not None and not pipeline_on:
        # the learner schedule IS the pipeline schedule (ask horizon,
        # reorder buffer, id-order tells): rounds just dispatch to actor
        # hosts instead of actor threads
        logger.info("fleet transport: async pipeline forced ON (the learner's round schedule "
                    "is the pipeline schedule)")
        pipeline_on = True
    if pipeline_on and work_queue is not None:
        logger.warning("workqueue: async pipeline forced off - the lease queue already "
                       "scatters folds across hosts")
        pipeline_on = False
    wd = resolve_watchdog(watchdog)
    fold_quality_floor = resolve_quality_floor(fold_quality_floor, num_class(conf["dataset"]))
    os.makedirs(save_dir, exist_ok=True)
    t_start = time.time()
    result = SearchResult()
    result["backend"] = dev.type
    result["device_kind"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result["device_count"] = 1
    result["guards"] = {"fold_quality_floor": fold_quality_floor,
                        "fold_retrain_tries": fold_retrain_tries, "audit_floor": audit_floor,
                        "phase1_epochs": phase1_epochs}
    fold_list = list(folds) if folds is not None else list(range(cv_num))
    bad = [f for f in fold_list if not 0 <= f < cv_num]
    if bad:
        raise ValueError(f"fold indices {bad} out of range [0, {cv_num})")

    trials_path = os.path.join(save_dir, "search_trials.json")
    trials_log: dict = {}
    if resume and os.path.exists(trials_path):
        trials_log = fsfault.load_json(trials_path)

    def _fold_trials_path(fold: int) -> str:
        """Per-fold trial log (work-queue mode): one writer per lease, so
        concurrent hosts can never clobber each other's folds."""
        return os.path.join(save_dir, f"search_trials.fold{fold}.json")

    def _load_fold_trials(fold: int) -> list:
        if work_queue is not None and os.path.exists(_fold_trials_path(fold)):
            return fsfault.load_json(_fold_trials_path(fold))
        return trials_log.get(str(fold), [])

    def _fold_searched(fold: int) -> bool:
        return len(_load_fold_trials(fold)) >= num_search

    trial_batch = max(1, int(trial_batch))
    result["trial_batch"] = trial_batch
    if topup_trials:
        result["warm_start"] = {
            "base_num_search": base_num_search, "topup_trials": topup_trials,
            "num_search": num_search,
            "resumed_trials_per_fold": {str(f): len(_load_fold_trials(f))
                                        for f in fold_list}}
    # the pipeline's threads dispatch under one lock (core/watchdog.py);
    # disarmed for serial runs, so one process can run both in turn
    arm_dispatch_serializer(pipeline_on)
    trace = DispatchTrace() if pipeline_on else None
    evaluator = _FoldEval(conf, dataroot, num_policy=num_policy, num_op=num_op,
                          cv_ratio=cv_ratio, trial_batch=trial_batch, aug_dispatch=aug_dispatch,
                          aug_groups=aug_groups, device=dev, draw_source=src, watchdog=wd,
                          trace=trace)
    result["aug_dispatch"] = evaluator.aug_dispatch
    result["aug_groups"] = evaluator.aug_groups
    # which data path trained the phase-1 oracles
    steps_per_dispatch = max(1, int(steps_per_dispatch))
    result["device_cache"] = device_cache
    result["steps_per_dispatch"] = steps_per_dispatch
    divergence_retries = max(0, int(divergence_retries))
    ckpt_keep = max(1, int(ckpt_keep))
    result["resilience"] = {"divergence_retries": divergence_retries, "ckpt_keep": ckpt_keep,
                            "watchdog": wd.stats()}
    result["fold_stack"] = 0
    # one watchdog for the trainer and the evaluations: fire counts add up
    train_kw = dict(ckpt_keep=ckpt_keep, device=dev, draw_source=draw_source,
                    device_cache=device_cache, steps_per_dispatch=steps_per_dispatch,
                    divergence_retries=divergence_retries, watchdog=wd, host_step=host_step)

    def _lease_heartbeat(unit: str):
        """Dispatch-boundary callback for the trainer and the trial loop:
        renew the unit's lease and this host's liveness beat."""
        if work_queue is None:
            return None

        def beat():
            work_queue.renew(unit)
            work_queue.beat_host()
        return beat

    fold_baselines: dict[int, float] = {}
    excluded_folds: list[int] = []
    # phase-1 training walls on one ledger, mirrored into the registry
    phase1_sw = PhaseStopwatch(device_count=1, registry=telemetry.registry())

    # ---------------- phase 1: pretrain without augmentation ----------
    t0 = time.time()
    no_aug_conf = conf.replace(aug="default")
    if phase1_epochs:
        no_aug_conf = no_aug_conf.replace(epoch=int(phase1_epochs))
    fold_paths = [_fold_ckpt_path(save_dir, conf, f, cv_ratio) for f in range(cv_num)]
    phase1_epochs_eff = int(no_aug_conf["epoch"])

    def _train(fold: int, path: str, train_seed: int, heartbeat=None) -> None:
        with phase1_sw.phase(f"phase1_fold{fold}"):
            if train_fold_fn is not None:
                _call_train_fold_fn(train_fold_fn, no_aug_conf, fold, path, train_seed)
            else:
                train_and_eval(no_aug_conf, dataroot, test_ratio=cv_ratio, cv_fold=fold,
                               save_path=path, metric="last", seed=train_seed,
                               heartbeat=heartbeat, **train_kw)

    def _phase1_fold(fold: int, heartbeat=None) -> None:
        """Train the fold if needed, then the quality gate (and its retrains).
        `heartbeat` (work-queue mode) renews the fold's lease at every
        trainer dispatch boundary."""
        path = fold_paths[fold]
        if _fold_searched(fold):
            # trials merged from another run: nothing left to train, but a
            # weak resumed oracle must still not rank policies
            logger.info("phase1: fold %d already searched (merged trials)", fold)
            if fold_quality_floor is not None:
                if os.path.exists(path):
                    acc = evaluator.baseline(fold, path)
                    fold_baselines[fold] = acc
                    if acc < fold_quality_floor:
                        logger.warning("phase1: resumed fold %d baseline %.3f below floor "
                                       "%.3f - EXCLUDED from ranking", fold, acc,
                                       fold_quality_floor)
                        excluded_folds.append(fold)
                else:
                    logger.warning("phase1: fold %d searched elsewhere and its checkpoint is "
                                   "not here - the quality gate cannot assess it", fold)
            return
        meta = read_metadata(path)
        if not (resume and meta and meta.get("epoch", 0) >= phase1_epochs_eff):
            logger.info("phase1: training fold %d -> %s", fold, path)
            _train(fold, path, seed, heartbeat)
        else:
            logger.info("phase1: fold %d already trained (epoch %d)", fold, meta["epoch"])
        if fold_quality_floor is None:
            return
        acc = evaluator.baseline(fold, path)
        tries = 0
        while acc < fold_quality_floor and tries < fold_retrain_tries:
            tries += 1
            alt = f"{path}.retry{tries}"
            logger.warning("phase1: fold %d baseline %.3f < floor %.3f - retraining with a "
                           "fresh seed (try %d/%d)", fold, acc, fold_quality_floor, tries,
                           fold_retrain_tries)
            _remove_ckpt(alt)
            _train(fold, alt, seed + 1009 * tries + fold, heartbeat)
            alt_acc = evaluator.baseline(fold, alt)
            if alt_acc > acc:
                _replace_ckpt(alt, path)
                acc = alt_acc
            else:
                _remove_ckpt(alt)
        fold_baselines[fold] = acc
        if acc < fold_quality_floor:
            logger.warning("phase1: fold %d baseline %.3f still below floor %.3f after %d "
                           "retrains - EXCLUDED from policy ranking", fold, acc,
                           fold_quality_floor, fold_retrain_tries)
            excluded_folds.append(fold)
        else:
            logger.info("phase1: fold %d baseline %.3f (floor %.3f) ok", fold, acc,
                        fold_quality_floor)

    def _workqueue_phase(units: dict[int, str], run) -> None:
        """Claim-and-run `units` ({fold: unit_id}) until EVERY unit is done
        (by this host or any other).  Passes that find nothing claimable
        wait out a fraction of the TTL — a stale lease (dead or wedged
        owner) is then reclaimed and the unit finished here, resuming from
        the shared checkpoint chain / trial log.  A LeaseLostError mid-work
        abandons the unit to its new owner (this host was presumed dead;
        its writes stay safe — same seeds, same atomic chain)."""
        from fast_autoaugment_tpu_torch.launch.workqueue import LeaseLostError

        pending = dict(units)
        # the process's start on the card, before its first claim
        evaluator.warm_up(int(conf["batch"]))
        while pending:
            progress = False
            for fold, unit in sorted(pending.items()):
                if work_queue.is_done(unit):
                    del pending[fold]
                    progress = True
                    continue
                if not work_queue.claim(unit):
                    continue
                work_queue.beat_host()
                try:
                    info = run(fold, unit)
                    # release() verifies the fencing token at post time —
                    # a robbed host raises here instead of clobbering the
                    # reclaimer's completion record
                    work_queue.release(unit, info=info)
                except LeaseLostError as e:
                    logger.warning("workqueue: lost the lease on %s mid-work (%s) - "
                                   "abandoning it to its new owner", unit, e)
                    continue
                del pending[fold]
                progress = True
            if pending and not progress:
                work_queue.beat_host()
                # TTL-bounded claim poll: the loop's exit is queue completion
                # by ANY host, and each wait is capped well under the lease
                # TTL so reclaims are never starved
                time.sleep(max(0.2, min(5.0, work_queue.lease_ttl / 4.0)))  # robust: allow
        work_queue.beat_host()

    # phase overlap (async pipeline): phase-1 training moves onto a trainer
    # thread inside phase 2 below; fold k's trials start when its gate
    # clears, while fold k+1 trains
    overlap_mode = pipeline_on and work_queue is None and until >= 2
    phase1_t0 = t0

    def _stamp_phase1(end_time: float | None = None) -> None:
        end = time.time() if end_time is None else end_time
        result["device_secs_phase1"] = result["tpu_secs_phase1"] = end - phase1_t0
        result["device_secs_phase1_per_fold"] = {
            str(f): phase1_sw.device_seconds(f"phase1_fold{f}") for f in sorted(fold_list)}
        result["fold_baselines"] = {str(k): v for k, v in fold_baselines.items()}
        result["excluded_folds"] = list(excluded_folds)

    if overlap_mode:
        logger.info("async pipeline: overlapping phase-1 fold training with phase-2 search "
                    "(each fold hands over when its gate clears)")
    elif work_queue is None:
        with record_function("search.phase1"):
            for fold in range(cv_num):
                if fold in fold_list:
                    _phase1_fold(fold)
        _stamp_phase1()
    else:
        work_queue.beat_host()

        def _run_p1(fold, unit):
            _phase1_fold(fold, heartbeat=_lease_heartbeat(unit))
            return {"baseline": fold_baselines.get(fold), "excluded": fold in excluded_folds}

        with record_function("search.phase1"):
            _workqueue_phase({f: f"p1-fold{f}" for f in fold_list}, _run_p1)
        # folds finished by other hosts: adopt their gate verdicts from the
        # done markers (the ranking below must honour every exclusion,
        # wherever the gate ran)
        for fold in fold_list:
            info = work_queue.done_info(f"p1-fold{fold}") or {}
            if info.get("baseline") is not None and fold not in fold_baselines:
                fold_baselines[fold] = float(info["baseline"])
            if info.get("excluded") and fold not in excluded_folds:
                excluded_folds.append(fold)
        _stamp_phase1()
    if until < 2:
        result["final_policy_set"] = []
        result["compile_cache"] = compile_cache_stats()
        result["elapsed_total"] = time.time() - t_start
        if fleet_transport is not None:
            # no rounds will ever be published: let actor hosts drain
            fleet_transport.mark_search_done({"until": until})
        return result

    # ---------------- phase 2: TPE search per fold --------------------
    t0 = time.time()
    space = make_search_space(num_policy, num_op)
    quarantined: list[dict] = []
    # the async pipeline's accounting and the cross-thread stop channel:
    # the overlapped trainer puts its failure here so the learner stops at
    # its next round boundary
    pipeline_fold_stats: list[dict] = []
    pipeline_stop_cell: list[BaseException] = []
    pipeline_overlap_timeline: dict = {}

    def _persist_trials(fold: int, fold_trials: list) -> None:
        trials_log[str(fold)] = fold_trials
        if work_queue is not None:
            # one writer per lease: the fold file, not the shared log
            write_json_atomic(_fold_trials_path(fold), fold_trials)
        else:
            write_json_atomic(trials_path, trials_log)

    def _quarantine(tpe, fold: int, lo: int, hi: int, exc: BaseException) -> float:
        """Log failed trial(s); the reward told to the TPE is the worst
        observed one, the constant-liar placeholder (``search/tpe.py ask``)."""
        worst = min(r for _, r in tpe.observations) if tpe.observations else 0.0
        logger.warning("phase2 fold %d trial(s) %d-%d: TTA evaluation FAILED (%s: %s) - "
                       "QUARANTINED with worst-observed reward %.4f; the search continues",
                       fold, lo, hi - 1, type(exc).__name__, exc, worst)
        return worst

    def _injected_trial_error(trial_idx: int) -> None:
        fi = faultinject.active_plan()
        if fi is not None:
            fi.maybe_kill_trial(trial_idx)
            if fi.trial_error_at(trial_idx):
                raise RuntimeError(f"injected trial_error at trial {trial_idx}")

    def _census_first(batched: bool) -> None:
        """The graph census after the first successful evaluation: the
        invariant is final == first."""
        key = "tta_batched_executables_first" if batched else "tta_executables_first"
        if key not in result:
            result[key] = executable_census(
                evaluator.tta_step_batch if batched else evaluator.tta_step)

    def _phase2_fold_async(fold: int, path: str, tpe, key_fold, fold_trials: list) -> None:
        """One fold's trial budget through the actor/learner pipeline; the
        trial log is appended in trial-id order.  Under the fleet transport
        the rounds go to actor hosts: the learner publishes them and polls
        the posted results, and runs no TTA itself (the graph census belongs
        to the actors)."""
        replay_trial_log(tpe, fold_trials, trial_batch, num_search,
                         max_inflight=pipeline_actors + pipeline_queue_depth)

        def _record_quarantine(lo, hi, exc, worst):
            logger.warning("phase2 fold %d trial(s) %d-%d: TTA evaluation FAILED (%s) - "
                           "QUARANTINED with worst-observed reward %.4f; the search continues",
                           fold, lo, hi - 1, _failure_text(exc), worst)

        backend = heartbeat = None
        on_first_ok = lambda: _census_first(trial_batch > 1)  # noqa: E731
        if fleet_transport is not None:
            # key_seed reproduces this fold's key on any host (key_fold is
            # the key of seed * 77 + fold)
            backend = fleet_transport.learner_backend(
                fold, key_seed=seed * 77 + fold, trial_batch=trial_batch,
                num_policy=num_policy, num_op=num_op)
            heartbeat = fleet_transport.beat
            on_first_ok = None
        trace.begin_segment(f"p2-fold{fold}")
        try:
            stats = run_fold_pipeline(
                evaluator, fold, path, tpe, key_fold, fold_trials, num_search=num_search,
                trial_batch=trial_batch, actors=pipeline_actors,
                queue_depth=pipeline_queue_depth, num_policy=num_policy, num_op=num_op,
                persist=lambda: _persist_trials(fold, fold_trials),
                record_quarantine=_record_quarantine, on_first_ok=on_first_ok,
                should_stop=lambda: pipeline_stop_cell[0] if pipeline_stop_cell else None,
                heartbeat=heartbeat, backend=backend)
        finally:
            trace.end_segment()
        pipeline_fold_stats.append(dict(stats, fold=fold))

    def _phase2_fold(fold: int, heartbeat=None) -> dict | None:
        """One fold's full TPE trial budget.  `heartbeat` (work-queue mode)
        renews the fold's lease after every persisted trial or round."""
        if fold in excluded_folds:
            logger.info("phase2: fold %d excluded by the quality gate", fold)
            return None
        if _fold_searched(fold):
            logger.info("phase2: fold %d trials already complete", fold)
            trials_log[str(fold)] = _load_fold_trials(fold)
            return None
        path = fold_paths[fold]
        evaluator.load_fold(path)  # a missing or corrupt checkpoint fails the search
        tpe = TPE(space, seed=seed * 1000 + fold, n_startup=min(20, max(5, num_search // 4)))
        key_fold = prng_key(seed * 77 + fold)
        fold_trials = list(_load_fold_trials(fold))
        if pipeline_on:
            # the resume replays the ask/tell interleaving through the ledger
            _phase2_fold_async(fold, path, tpe, key_fold, fold_trials)
            return {"num_trials": len(fold_trials)}
        for entry in fold_trials:  # resume (a third element marks a quarantined trial)
            tpe.tell(entry[0], entry[1])

        while trial_batch <= 1 and len(tpe.observations) < num_search:
            trial_idx = len(tpe.observations)
            proposal = tpe.suggest()
            policy_t = evaluator.policy_tensor(policy_decoder(proposal, num_policy, num_op))
            failure = None
            try:
                _injected_trial_error(trial_idx)
                metrics = evaluator.evaluate(fold, path, policy_t,
                                             src.fold_in(key_fold, trial_idx, dev))
                reward = metrics["top1_valid"]
            except (PreemptedError, DispatchHungError):
                raise  # a shutdown or a wedged device: the exit-77 path, not a trial failure
            except (ArithmeticError, RuntimeError, ValueError, OSError) as e:
                reward = _quarantine(tpe, fold, trial_idx, trial_idx + 1, e)
                failure = {"quarantined": True, "error": f"{type(e).__name__}: {e}"}
            if failure is None:
                _census_first(False)
            tpe.tell(proposal, reward)
            telemetry.emit("trial", f"fold{fold}", fold=fold, trial=trial_idx,
                           reward=float(reward), quarantined=failure is not None)
            fold_trials.append((proposal, reward) if failure is None
                               else (proposal, reward, failure))
            _persist_trials(fold, fold_trials)
            if heartbeat is not None:
                heartbeat()
            if trial_idx % 10 == 0 or trial_idx == num_search - 1:
                logger.info("phase2 fold %d trial %d/%d: top1_valid=%.4f best=%.4f", fold,
                            trial_idx, num_search, reward, tpe.best[1])

        while trial_batch > 1 and len(tpe.observations) < num_search:
            t_base = len(tpe.observations)
            k_eff = min(trial_batch, num_search - t_base)
            proposals = tpe.ask(k_eff)
            # a short last round repeats its last proposal up to K; the
            # repeats' results are dropped
            padded = proposals + [proposals[-1]] * (trial_batch - k_eff)
            policies_t = torch.as_tensor(np.stack([
                policy_to_tensor(policy_decoder(p, num_policy, num_op)) for p in padded]),
                device=dev)
            # candidate i's key is sequential trial (t_base + i)'s key
            keys = _stack_keys([src.fold_in(key_fold, t_base + i, dev)
                                for i in range(trial_batch)])
            failure = None
            try:
                for i in range(k_eff):
                    _injected_trial_error(t_base + i)
                metrics_list = evaluator.evaluate_batch(fold, path, policies_t, keys)[:k_eff]
                rewards = [m["top1_valid"] for m in metrics_list]
            except (PreemptedError, DispatchHungError):
                raise
            except (ArithmeticError, RuntimeError, ValueError, OSError) as e:
                # one pass evaluates the whole round: the round is quarantined
                rewards = [_quarantine(tpe, fold, t_base, t_base + k_eff, e)] * k_eff
                failure = {"quarantined": True, "error": f"{type(e).__name__}: {e}"}
            if failure is None:
                _census_first(True)
            tpe.tell_batch(proposals, rewards)
            for i, r in enumerate(rewards):
                telemetry.emit("trial", f"fold{fold}", fold=fold, trial=t_base + i,
                               reward=float(r), quarantined=failure is not None)
            fold_trials.extend((p, r) if failure is None else (p, r, failure)
                               for p, r in zip(proposals, rewards))
            _persist_trials(fold, fold_trials)
            if heartbeat is not None:
                heartbeat()
            logger.info("phase2 fold %d trials %d-%d/%d (batch of %d): best_in_batch=%.4f "
                        "best=%.4f", fold, t_base, t_base + k_eff - 1, num_search, k_eff,
                        max(rewards), tpe.best[1])
        return {"num_trials": len(fold_trials)}

    with record_function("search.phase2"):
        if overlap_mode:
            def _p1_overlap(fold: int) -> None:
                try:
                    _phase1_fold(fold, heartbeat=(fleet_transport.beat
                                                  if fleet_transport is not None else None))
                except BaseException as e:
                    # the in-flight learner stops at its next round boundary
                    pipeline_stop_cell.append(e)
                    raise
                if fleet_transport is not None and fold not in excluded_folds \
                        and os.path.exists(fold_paths[fold]):
                    # the gate-cleared checkpoint goes to the fleet at once
                    # (after its atomic rename): fold k's rounds go to actor
                    # hosts while fold k+1 still trains here
                    fleet_transport.publish_checkpoint(fold, fold_paths[fold])

            timeline = run_overlapped_phases(fold_list, _p1_overlap, _phase2_fold)
            pipeline_overlap_timeline.update(timeline)
            p1_ends = [v["end"] for v in timeline["phase1"].values()]
            _stamp_phase1(max(p1_ends) if p1_ends else None)
        elif work_queue is None:
            for fold in fold_list:
                _phase2_fold(fold)
        else:
            def _run_p2(fold, unit):
                return _phase2_fold(fold, heartbeat=_lease_heartbeat(unit)) or {}

            _workqueue_phase({f: f"p2-fold{f}" for f in fold_list if f not in excluded_folds},
                             _run_p2)
            # every fold's trials (finished here or by other hosts) merge
            # into the in-memory log so the ranking below sees all of them
            for fold in fold_list:
                ft = _load_fold_trials(fold)
                if ft:
                    trials_log[str(fold)] = ft

    # top-N per fold from the trial log (folds run here and folds resumed
    # from disk alike, search.py:253-259); only complete searches count
    final_policy_set: list = []
    for fold_key in sorted(trials_log, key=int):
        fold_trials = trials_log[fold_key]
        if not 0 <= int(fold_key) < cv_num:
            logger.warning("ignoring stale fold %s in trial log", fold_key)
            continue
        if int(fold_key) in excluded_folds:
            logger.warning("fold %s excluded by the quality gate - its trials do not rank",
                           fold_key)
            continue
        if len(fold_trials) < num_search:
            logger.warning("fold %s has %d/%d trials - incomplete, excluded from the final "
                           "policy set", fold_key, len(fold_trials), num_search)
            continue
        scored = [t for t in fold_trials if len(t) < 3 or not (t[2] or {}).get("quarantined")]
        for entry in sorted(scored, key=lambda o: -o[1])[:num_top]:
            final_policy_set.extend(policy_decoder(entry[0], num_policy, num_op))
    final_policy_set = remove_duplicates(final_policy_set)
    result["num_sub_policies_selected"] = len(final_policy_set)
    quarantined = [{"fold": int(fk), "trial": i, "error": (t[2] or {}).get("error", "unknown")}
                   for fk, trs in sorted(trials_log.items()) if fk.lstrip("-").isdigit()
                   for i, t in enumerate(trs) if len(t) >= 3 and (t[2] or {}).get("quarantined")]
    result["quarantined_trials"] = quarantined
    result["num_quarantined_trials"] = len(quarantined)
    if quarantined:
        logger.warning("phase2: %d trial(s) quarantined after failed TTA evaluations - see "
                       "search_result.json['quarantined_trials']", len(quarantined))
    result["device_secs_phase2"] = result["tpu_secs_phase2"] = time.time() - t0
    # the pipeline's accounting and dispatch-gap evidence; in overlap mode
    # phase 2 spans the overlapped region, and the timeline holds the
    # per-fold interleaving
    if pipeline_on:
        gaps = trace.summary()
        result["pipeline"] = {
            "mode": "on", "actors": pipeline_actors, "queue_depth": pipeline_queue_depth,
            "max_inflight": pipeline_actors + pipeline_queue_depth,
            "tell_reorders": sum(st["tell_reorders"] for st in pipeline_fold_stats),
            "rounds": sum(st["rounds"] for st in pipeline_fold_stats),
            "per_fold": pipeline_fold_stats,
            "device_busy_frac": (gaps or {}).get("device_busy_frac"),
            "dispatch_gaps": gaps,
            "overlap": pipeline_overlap_timeline or None,
        }
    # the graph census: one CUDA graph per policy shape the step was fed on
    # the card (the evaluator runs one evaluation at a time, whatever the
    # number of actors), none on the CPU; a fully resumed run built no step
    # and has nothing to count
    per_shape = 1 if dev.type == "cuda" else 0
    result["tta_executables"] = (executable_census(evaluator.tta_step)
                                 if evaluator._built else None)
    result["tta_executables_expected"] = len(evaluator.policy_shapes) * per_shape
    census_failures = []
    if (result["tta_executables"] is not None
            and result["tta_executables"] > result["tta_executables_expected"]):
        census_failures.append(
            f"{result['tta_executables']} TTA graphs for {result['tta_executables_expected']} "
            f"expected (policy shapes {sorted(evaluator.policy_shapes)})")
    if trial_batch > 1:
        result["tta_batched_executables"] = (executable_census(evaluator.tta_step_batch)
                                             if evaluator._built else None)
        result["tta_batched_executables_expected"] = (len(evaluator.batch_policy_shapes)
                                                      * per_shape)
        if (result["tta_batched_executables"] is not None
                and result["tta_batched_executables"]
                > result["tta_batched_executables_expected"]):
            census_failures.append(
                f"{result['tta_batched_executables']} batched-TTA graphs for "
                f"{result['tta_batched_executables_expected']} expected (candidate axes "
                f"{sorted(evaluator.batch_policy_shapes)})")
    if census_failures:
        msg = ("phase2: " + "; ".join(census_failures)
               + " - graphs are being captured inside the trial loop")
        # the partial result with a failure record, so the spent trials
        # leave a search_result.json to diagnose and resume from
        result["failure"] = {"stage": "tta_executable_census", "error": msg}
        result["resilience"]["watchdog"] = wd.stats()
        result["compile_cache"] = compile_cache_stats()
        result["final_policy_set_pre_audit_size"] = len(final_policy_set)
        result["elapsed_total"] = time.time() - t_start
        write_json_atomic(os.path.join(save_dir, "search_result.json"),
                          {k: v for k, v in result.items()
                           if k not in ("final_policy_set", "random_policy_set")})
        raise RuntimeError(msg)

    def _audited(policy_set, cache_name: str, secs_key: str):
        """One audit pipeline for both arms (the same folds, floors and
        cached-score reuse)."""
        t = time.time()
        apath = os.path.join(save_dir, cache_name)
        cached = None
        if resume and os.path.exists(apath):
            with open(apath) as fh:
                cached = json.load(fh)
        with record_function("search.audit"):
            kept, audit = audit_sub_policies(
                evaluator, policy_set, fold_paths, fold_baselines=fold_baselines,
                candidate_folds=[f for f in range(cv_num) if f not in excluded_folds],
                audit_floor=audit_floor, quality_floor=fold_quality_floor,
                cached_audit=cached)
        result[f"device_secs_{secs_key}"] = result[f"tpu_secs_{secs_key}"] = time.time() - t
        write_json_atomic(apath, audit)
        return kept, audit

    # ---------------- phase 2.5: per-sub-policy audit -----------------
    if audit_floor is not None and final_policy_set:
        final_policy_set, audit = _audited(final_policy_set, "audit.json", "audit")
        result["num_sub_policies_dropped"] = len(audit["dropped"])

    # ---------------- random control arm ------------------------------
    if random_control:
        rand_path = os.path.join(save_dir, "random_policy.json")
        n_rand = max(int(result.get("num_sub_policies_selected", 0)), 1)
        if resume and os.path.exists(rand_path):
            with open(rand_path) as fh:
                random_set = [[tuple(op) for op in sub] for sub in json.load(fh)]
            logger.info("random control: resumed %d drawn sub-policies", len(random_set))
        else:
            random_set = draw_random_policy_set(n_rand, num_policy, num_op, seed=seed * 31 + 7)
            write_json_atomic(rand_path, random_set)
            logger.info("random control: drew %d sub-policies (the searched arm's pre-audit "
                        "size)", len(random_set))
        result["num_sub_policies_random_drawn"] = len(random_set)
        if audit_floor is not None and random_set:
            random_set, audit_r = _audited(random_set, "audit_random.json", "audit_random")
            result["num_sub_policies_random_dropped"] = len(audit_r["dropped"])
        result["random_policy_set"] = random_set
        result["num_sub_policies_random"] = len(random_set)
        write_json_atomic(os.path.join(save_dir, "random_final_policy.json"), random_set)

    result["final_policy_set"] = final_policy_set
    result["num_sub_policies"] = len(final_policy_set)
    # the seams' accounting, after all device work
    result["resilience"]["watchdog"] = wd.stats()
    result["watchdog_fires"] = wd.fires
    result["compile_cache"] = compile_cache_stats()
    if work_queue is not None:
        # the degraded-completion evidence any surviving host can rebuild
        # from the shared queue
        work_queue.beat_host()  # the census must not see a stale self
        _stamp_fleet(result, work_queue.accounting(), "unit(s) reclaimed and finished by "
                                                      "survivors")
    if fleet_transport is not None:
        # any round finished at lease attempt > 1 was reclaimed from a dead
        # or preempted actor host; the trial log itself is the single-host
        # run's already — this stamp says how it got there
        fleet_transport.beat()
        _stamp_fleet(result, fleet_transport.accounting(), "round unit(s) reclaimed and "
                                                           "finished by surviving actors")
        result["fleet_transport"] = {"root": fleet_transport.root,
                                     "owner": fleet_transport.owner,
                                     "window": pipeline_actors + pipeline_queue_depth}
    write_json_atomic(os.path.join(save_dir, "final_policy.json"), final_policy_set)
    if fleet_transport is not None:
        # terminal marker AFTER the final artifacts land: actor hosts drain
        # their claim poll and exit 0
        fleet_transport.mark_search_done({"num_sub_policies": len(final_policy_set)})
    logger.info("search done: %d sub-policies; phase1 %.1f device-s, phase2 %.1f device-s on "
                "%s", len(final_policy_set), result["device_secs_phase1"],
                result["device_secs_phase2"], result["backend"])
    result["elapsed_total"] = time.time() - t_start
    return result


def _stamp_fleet(result: dict, acct: dict, what: str) -> None:
    """The work queue's or the round transport's accounting into `result`."""
    result["resilience"]["fleet"] = acct
    result["degraded"] = acct["degraded"]
    result["lost_hosts"] = acct["lost_hosts"]
    result["reclaimed_units"] = [r["unit"] for r in acct["reclaimed_units"]]
    if acct["degraded"]:
        logger.warning("search completed DEGRADED: lost_hosts=%s, %d %s", acct["lost_hosts"],
                       acct["num_reclaimed_units"], what)


def search_actor(conf, dataroot: str, save_dir: str, fleet_transport, *, cv_num: int = 5,
                 cv_ratio: float = 0.4, num_policy: int = 5, num_op: int = 2,
                 trial_batch: int = 1, seed: int = 0, aug_dispatch: str = "exact",
                 aug_groups: int = 8, watchdog="off", compile_cache: str = "off",
                 telemetry_spec: str = "off", poll_sec: float = 0.5,
                 ckpt_timeout: float = 900.0, device="cuda", draw_source=None) -> dict:
    """ACTOR-host entry of the fleet search (``search_cli --search-role
    actor``): no training and no TPE — the ``_FoldEval`` TTA machinery (its
    graphed TTA step on the card) in a claim/evaluate/post loop against the
    learner's published rounds (``search/pipeline.py run_fleet_actor``).

    The geometry arguments (`trial_batch`, `num_policy`, `num_op`,
    `aug_dispatch`, ...) must match the learner's: a payload mismatch raises
    instead of quarantining every round.  `save_dir` is the SHARED artifact
    directory the learner writes fold checkpoints into; the transport's
    published digests gate loading.  `seed` is accepted for the learner's
    flags; each round carries its own key seed.  Returns the actor's
    accounting (rounds evaluated and failed, leases lost, units reclaimed
    from dead peers) once the learner marks the search done."""
    dev = resolve_device(device)
    install_signal_handlers()
    configure_compile_cache(compile_cache)
    telemetry.configure_telemetry(telemetry_spec)
    wd = resolve_watchdog(watchdog)
    evaluator = _FoldEval(conf, dataroot, num_policy=num_policy, num_op=num_op,
                          cv_ratio=cv_ratio, trial_batch=trial_batch, aug_dispatch=aug_dispatch,
                          aug_groups=aug_groups, device=dev,
                          draw_source=draw_source or PhiloxDraws(), watchdog=wd)

    def _fold_path(fold: int) -> str:
        if not 0 <= int(fold) < cv_num:
            raise ValueError(f"published round names fold {fold} outside this actor's "
                             f"cv_num={cv_num} - launch actors with the learner's flags")
        return _fold_ckpt_path(save_dir, conf, int(fold), cv_ratio)

    # the process's start on the card before its first claim
    evaluator.warm_up(int(conf["batch"]))
    logger.info("fleet actor %s: serving rounds from %s (save_dir %s)",
                fleet_transport.owner, fleet_transport.root, save_dir)
    stats = run_fleet_actor(evaluator, fleet_transport, _fold_path,
                            trial_batch=max(1, int(trial_batch)), num_policy=num_policy,
                            num_op=num_op, poll_sec=poll_sec, ckpt_timeout=ckpt_timeout)
    stats["watchdog"] = wd.stats()
    stats["compile_cache"] = compile_cache_stats()
    stats["tta_executables"] = (executable_census(evaluator.tta_step_batch if trial_batch > 1
                                                  else evaluator.tta_step)
                                if evaluator._built else None)
    logger.info("fleet actor %s: done - %d round(s) evaluated, %d failed, %d lease(s) lost, "
                "%d reclaimed", fleet_transport.owner, stats["rounds_ok"], stats["rounds_err"],
                stats["lease_lost"], len(stats["reclaimed_units"]))
    return stats


def audit_sub_policies(evaluator: _FoldEval, policy_set: list, fold_paths: list[str], *,
                       fold_baselines: dict[int, float], candidate_folds: list[int],
                       audit_floor: float, quality_floor: float | None = None,
                       num_draws_key: int = 23, cached_audit: dict | None = None,
                       audit_chunk: int | None = None) -> tuple[list, dict]:
    """Drop sub-policies that on their own degrade fold accuracy.

    Each sub-policy is scored ``mean_f[acc_f(sp) / base_f]`` over the audit
    folds, ``acc_f(sp)`` with the mean-over-draws reduction and ``base_f``
    the fold's identity-policy baseline; a score below `audit_floor` drops
    it.  A fold is audited when its checkpoint exists and its baseline
    clears ``max(quality_floor, 2 x chance)``.  Four sub-policies or fewer
    go through the TTA step with key ``PRNGKey(num_draws_key * 1000 + i)``;
    more go through the audit step in chunks with the chained
    ``fold_in(PRNGKey(num_draws_key), fold, start, batch)`` keys.  Returns
    the kept set and the record of ``audit.json``."""
    evaluator._build()
    src, dev = evaluator.draw_source, evaluator.dev
    floor = max(quality_floor or 0.0, 2.0 / evaluator.num_classes)
    audit_folds = []
    for fold in candidate_folds:
        path = fold_paths[fold]
        if not os.path.exists(path):
            continue
        if fold not in fold_baselines:
            fold_baselines[fold] = evaluator.baseline(fold, path)
        if fold_baselines[fold] >= floor:
            audit_folds.append(fold)
    record: dict = {"audit_floor": audit_floor, "audit_folds": audit_folds,
                    "fold_baselines": {str(k): v for k, v in fold_baselines.items()},
                    "scores": [], "dropped": []}
    if not audit_folds:
        logger.warning("audit: no fold passes the baseline floor %.3f - audit SKIPPED, policy "
                       "set unchanged", floor)
        return policy_set, record

    # cached scores hold only for the same audit folds with the same baselines
    cached_scores: dict = {}
    if cached_audit:
        try:
            same_folds = list(cached_audit.get("audit_folds", [])) == audit_folds
            same_base = same_folds and all(
                abs(cached_audit["fold_baselines"].get(str(f), -1.0) - fold_baselines[f]) < 1e-6
                for f in audit_folds)
            if same_base and cached_audit.get("scores"):
                cached_scores = {json.dumps(s["sub_policy"]): s["score"]
                                 for s in cached_audit["scores"]}
                logger.info("audit: reusing %d cached scores", len(cached_scores))
            else:
                logger.info("audit: cached scores stale (fold set or baselines changed) - "
                            "recomputing")
        except (KeyError, TypeError, ValueError):
            cached_scores = {}

    idx_to_eval = [i for i, sub in enumerate(policy_set) if json.dumps(sub) not in cached_scores]
    computed: dict[int, float] = {}
    if idx_to_eval and len(idx_to_eval) <= 4:
        for i in idx_to_eval:
            sp_t = evaluator.policy_tensor([list(map(tuple, policy_set[i]))])
            ratios = [evaluator.evaluate(fold, fold_paths[fold], sp_t,
                                         prng_key(num_draws_key * 1000 + i))["top1_mean"]
                      / max(fold_baselines[fold], 1e-6) for fold in audit_folds]
            computed[i] = float(np.mean(ratios))
    elif idx_to_eval:
        if audit_chunk is None:  # 8 sub-policies per call at 32x32, 1 at 224x224
            audit_chunk = max(1, (8 * 32 * 32) // (evaluator.image ** 2))
        chunk = max(1, int(audit_chunk))
        n = len(idx_to_eval)
        subs_np = np.stack([policy_to_tensor([list(map(tuple, policy_set[i]))])[0]
                            for i in idx_to_eval])  # [n, num_op, 3]
        ratio_sums = np.zeros(n)
        for fold in audit_folds:
            sums = np.zeros(n)
            cnt = 0.0
            for start in range(0, n, chunk):
                block = subs_np[start:start + chunk]
                real = len(block)
                if real < chunk:
                    block = np.concatenate(
                        [block, np.zeros((chunk - real,) + block.shape[1:], np.float32)])
                # batch bi's key is fold_in(PRNGKey(num_draws_key), fold, start, bi)
                k = prng_key(num_draws_key)
                for part in (fold, start):
                    k = src.fold_in(k, part, dev)
                bsum, bcnt = evaluator.audit_fold(fold, fold_paths[fold],
                                                  torch.as_tensor(block, device=dev), k)
                sums[start:start + real] = bsum[:real]
                cnt = bcnt
            ratio_sums += (sums / max(cnt, 1e-6)) / max(fold_baselines[fold], 1e-6)
        for j, i in enumerate(idx_to_eval):
            computed[i] = float(ratio_sums[j] / len(audit_folds))

    kept = []
    for i, sub in enumerate(policy_set):
        cache_key = json.dumps(sub)
        score = float(cached_scores[cache_key]) if cache_key in cached_scores else computed[i]
        record["scores"].append({"sub_policy": sub, "score": score})
        if score >= audit_floor:
            kept.append(sub)
        else:
            record["dropped"].append({"sub_policy": sub, "score": score})
    logger.info("audit: %d/%d sub-policies kept (floor %.2f x baseline over folds %s)",
                len(kept), len(policy_set), audit_floor, audit_folds)
    return kept, record
