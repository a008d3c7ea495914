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

Refused, naming the ROADMAP item that ports them: fold stacking
(``fold_stack`` != 0), the device cache and multistep dispatch (item 10);
the async pipeline, the watchdog, the compile cache, telemetry and
divergence retries (item 12); the work queue and the fleet transport
(item 13).  The async pipeline's knobs (``pipeline_actors``,
``pipeline_queue_depth``) are not taken at all.  The JAX driver's executable census (``search/census.py``) is
dropped: a compile census has no meaning in eager PyTorch.  ImageNet data
is not ported (``load_dataset`` raises, item 11).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from fast_autoaugment_tpu_torch.core.checkpoint import load_checkpoint, read_metadata
from fast_autoaugment_tpu_torch.core.device import resolve_device
from fast_autoaugment_tpu_torch.data.datasets import cv_split, load_dataset
from fast_autoaugment_tpu_torch.data.pipeline import device_batches, eval_batches
from fast_autoaugment_tpu_torch.models import get_model, input_image_size, num_class
from fast_autoaugment_tpu_torch.ops.augment import SEARCH_OP_NAMES
from fast_autoaugment_tpu_torch.policies.archive import (
    policy_decoder,
    policy_to_tensor,
    remove_duplicates,
)
from fast_autoaugment_tpu_torch.search.tpe import TPE, choice, uniform
from fast_autoaugment_tpu_torch.search.tta import (
    PhiloxDraws,
    check_aug_dispatch,
    eval_tta,
    eval_tta_batched,
    make_audit_step,
    make_tta_step,
    prng_key,
)
from fast_autoaugment_tpu_torch.train.trainer import train_and_eval
from fast_autoaugment_tpu_torch.utils.interop import flax_layout, flax_to_tensors
from fast_autoaugment_tpu_torch.utils.logging import get_logger

__all__ = ["search_policies", "make_search_space", "SearchResult", "resolve_quality_floor",
           "write_json_atomic", "draw_random_policy_set", "audit_sub_policies"]

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


def write_json_atomic(path: str, obj) -> None:
    """fsync-then-rename write: a crash mid-write never tears the file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


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
    and audit steps on it, and each fold's held-out batches uploaded once."""

    def __init__(self, conf, dataroot, *, num_policy, num_op, cv_ratio, trial_batch: int = 1,
                 aug_dispatch: str = "exact", aug_groups: int = 8, device="cuda",
                 draw_source=None):
        self.conf, self.dataroot = conf, dataroot
        self.num_policy, self.num_op, self.cv_ratio = num_policy, num_op, cv_ratio
        self.trial_batch = max(1, int(trial_batch))
        self.aug_dispatch = check_aug_dispatch(aug_dispatch)
        self.aug_groups = max(1, int(aug_groups))
        self.dev = resolve_device(device)
        self.draw_source = draw_source or PhiloxDraws()
        self._built = False
        self._loaded = None  # (path, digest) of the weights in the model
        self._batches: dict[int, list] = {}

    def _build(self):
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
        self.image = input_image_size(dataset_name, conf["model"]["type"])
        kw = dict(num_policy=self.num_policy, cutout_length=int(conf.get("cutout", 0) or 0),
                  aug_dispatch=self.aug_dispatch, aug_groups=self.aug_groups,
                  draw_source=self.draw_source)
        self.tta_step = make_tta_step(self.model, **kw)
        self.audit_step = make_audit_step(self.model, **kw)
        self.tta_step_batch = (make_tta_step(self.model, num_candidates=self.trial_batch, **kw)
                               if self.trial_batch > 1 else None)
        self._built = True

    def load_fold(self, path: str) -> None:
        """Put the weights and BatchNorm statistics of the checkpoint at
        `path` into the model (a no-op when they are there already)."""
        self._build()
        ident = (path, (read_metadata(path) or {}).get("digest"))
        if self._loaded == ident:
            return
        tree = load_checkpoint(path)
        live = self.model.state_dict()
        with torch.no_grad():
            for name, arr in flax_to_tensors(tree, self.layout).items():
                live[name].copy_(torch.from_numpy(arr))
        self._loaded = ident

    def batches(self, fold: int) -> list:
        """The fold's held-out split in full batches (the last one padded,
        so every batch has one shape), uploaded on first use."""
        self._build()
        if fold not in self._batches:
            _train_idx, valid_idx = cv_split(self.total_train.labels, self.cv_ratio, fold)
            batch = int(self.conf["batch"])
            self._batches[fold] = device_batches(
                eval_batches(self.total_train, valid_idx, batch, pad_multiple=batch), self.dev)
        return self._batches[fold]

    def policy_tensor(self, policies) -> torch.Tensor:
        return torch.as_tensor(policy_to_tensor(policies), device=self.dev)

    def evaluate(self, fold: int, path: str, policy_t, key) -> dict:
        self.load_fold(path)
        return eval_tta(self.tta_step, self.batches(fold), policy_t, key)

    def evaluate_batch(self, fold: int, path: str, policies_t, keys) -> list[dict]:
        """K candidates (``[K, num_sub, num_op, 3]``, K = trial_batch) with the
        ``[K]`` stack of their trial keys, in one pass per batch."""
        self._build()
        if self.tta_step_batch is None:
            raise RuntimeError("evaluate_batch requires trial_batch > 1")
        if int(policies_t.shape[0]) != self.trial_batch:
            raise ValueError(f"candidate axis {int(policies_t.shape[0])} != trial_batch "
                             f"{self.trial_batch}")
        self.load_fold(path)
        return eval_tta_batched(self.tta_step_batch, self.batches(fold), policies_t, keys)

    def audit_eval(self, batch: dict, subs, key) -> dict:
        self._build()
        return self.audit_step(batch["x"], batch["y"], batch["m"], subs, key)

    def baseline(self, fold: int, path: str) -> float:
        """The fold's accuracy under the identity policy (one all-zero
        sub-policy: op 0 gated at prob 0) through the same TTA step."""
        ident = torch.zeros((1, self.num_op, 3), dtype=torch.float32, device=self.dev)
        out = self.evaluate(fold, path, ident, prng_key(17))
        return float(out["top1_mean"])


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
                    telemetry_spec: str = "off", fleet_transport=None, topup_trials: int = 0,
                    device="cuda", draw_source=None) -> SearchResult:
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
    random arm.  The unported options raise (module docstring)."""
    if fold_stack not in (None, 0, "0"):
        _refuse(f"fold stacking (fold_stack={fold_stack!r})", "10")
    if device_cache in (True, 1, "on"):
        _refuse("the device-resident dataset cache (device_cache='on')", "10")
    if int(steps_per_dispatch) != 1:
        _refuse(f"multistep dispatch (steps_per_dispatch={steps_per_dispatch})", "10")
    if async_pipeline not in ("off", False, None, 0):
        _refuse("the async actor/learner pipeline", "12")
    if watchdog not in ("off", None, False, 0):
        _refuse("the dispatch watchdog", "12")
    if compile_cache not in ("off", None, ""):
        _refuse("the compile cache", "12")
    if telemetry_spec not in ("off", None, ""):
        _refuse("the telemetry journal", "12")
    if int(divergence_retries) > 0:
        _refuse("divergence retries", "12")
    if work_queue is not None:
        _refuse("the elastic work queue", "13")
    if fleet_transport is not None:
        _refuse("the fleet transport", "13")
    dev = resolve_device(device)
    src = draw_source or PhiloxDraws()
    if smoke_test:  # reference --smoke-test (search.py:153, 235)
        num_search = 4
    topup_trials = max(0, int(topup_trials))
    base_num_search = num_search
    num_search += topup_trials
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
        with open(trials_path) as fh:
            trials_log = json.load(fh)

    def _fold_searched(fold: int) -> bool:
        return len(trials_log.get(str(fold), [])) >= num_search

    trial_batch = max(1, int(trial_batch))
    result["trial_batch"] = trial_batch
    if topup_trials:
        result["warm_start"] = {
            "base_num_search": base_num_search, "topup_trials": topup_trials,
            "num_search": num_search,
            "resumed_trials_per_fold": {str(f): len(trials_log.get(str(f), []))
                                        for f in fold_list}}
    evaluator = _FoldEval(conf, dataroot, num_policy=num_policy, num_op=num_op,
                          cv_ratio=cv_ratio, trial_batch=trial_batch, aug_dispatch=aug_dispatch,
                          aug_groups=aug_groups, device=dev, draw_source=src)
    result["aug_dispatch"] = evaluator.aug_dispatch
    result["aug_groups"] = evaluator.aug_groups
    result["device_cache"] = device_cache
    result["steps_per_dispatch"] = 1
    ckpt_keep = max(1, int(ckpt_keep))
    result["resilience"] = {"divergence_retries": 0, "ckpt_keep": ckpt_keep}
    result["fold_stack"] = 0
    train_kw = dict(ckpt_keep=ckpt_keep, device=dev, draw_source=draw_source)
    fold_baselines: dict[int, float] = {}
    excluded_folds: list[int] = []
    phase1_secs: dict[int, float] = {}

    # ---------------- phase 1: pretrain without augmentation ----------
    t0 = time.time()
    no_aug_conf = conf.replace(aug="default")
    if phase1_epochs:
        no_aug_conf = no_aug_conf.replace(epoch=int(phase1_epochs))
    fold_paths = [_fold_ckpt_path(save_dir, conf, f, cv_ratio) for f in range(cv_num)]
    phase1_epochs_eff = int(no_aug_conf["epoch"])

    def _train(fold: int, path: str, train_seed: int) -> None:
        t = time.time()
        if train_fold_fn is not None:
            _call_train_fold_fn(train_fold_fn, no_aug_conf, fold, path, train_seed)
        else:
            train_and_eval(no_aug_conf, dataroot, test_ratio=cv_ratio, cv_fold=fold,
                           save_path=path, metric="last", seed=train_seed, **train_kw)
        phase1_secs[fold] = phase1_secs.get(fold, 0.0) + time.time() - t

    def _phase1_fold(fold: int) -> None:
        """Train the fold if needed, then the quality gate (and its retrains)."""
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
            _train(fold, path, seed)
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
            _train(fold, alt, seed + 1009 * tries + fold)
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

    with record_function("search.phase1"):
        for fold in range(cv_num):
            if fold in fold_list:
                _phase1_fold(fold)
    result["device_secs_phase1"] = result["tpu_secs_phase1"] = time.time() - t0
    result["device_secs_phase1_per_fold"] = {str(f): phase1_secs.get(f, 0.0)
                                             for f in sorted(fold_list)}
    result["fold_baselines"] = {str(k): v for k, v in fold_baselines.items()}
    result["excluded_folds"] = list(excluded_folds)
    if until < 2:
        result["final_policy_set"] = []
        result["elapsed_total"] = time.time() - t_start
        return result

    # ---------------- phase 2: TPE search per fold --------------------
    t0 = time.time()
    space = make_search_space(num_policy, num_op)

    def _persist_trials(fold: int, fold_trials: list) -> None:
        trials_log[str(fold)] = fold_trials
        write_json_atomic(trials_path, trials_log)

    def _quarantine(tpe, fold: int, lo: int, hi: int, exc: BaseException) -> float:
        """Log failed trial(s); the reward told to the TPE is the worst
        observed one, the constant-liar placeholder (``search/tpe.py ask``)."""
        worst = min(r for _, r in tpe.observations) if tpe.observations else 0.0
        logger.warning("phase2 fold %d trial(s) %d-%d: TTA evaluation FAILED (%s: %s) - "
                       "QUARANTINED with worst-observed reward %.4f; the search continues",
                       fold, lo, hi - 1, type(exc).__name__, exc, worst)
        return worst

    def _phase2_fold(fold: int) -> None:
        if fold in excluded_folds:
            logger.info("phase2: fold %d excluded by the quality gate", fold)
            return
        if _fold_searched(fold):
            logger.info("phase2: fold %d trials already complete", fold)
            return
        path = fold_paths[fold]
        evaluator.load_fold(path)  # a missing or corrupt checkpoint fails the search
        tpe = TPE(space, seed=seed * 1000 + fold, n_startup=min(20, max(5, num_search // 4)))
        key_fold = prng_key(seed * 77 + fold)
        fold_trials = list(trials_log.get(str(fold), []))
        for entry in fold_trials:  # resume (a third element marks a quarantined trial)
            tpe.tell(entry[0], entry[1])

        while trial_batch <= 1 and len(tpe.observations) < num_search:
            trial_idx = len(tpe.observations)
            proposal = tpe.suggest()
            policy_t = evaluator.policy_tensor(policy_decoder(proposal, num_policy, num_op))
            failure = None
            try:
                metrics = evaluator.evaluate(fold, path, policy_t,
                                             src.fold_in(key_fold, trial_idx, dev))
                reward = metrics["top1_valid"]
            except (ArithmeticError, RuntimeError, ValueError, OSError) as e:
                reward = _quarantine(tpe, fold, trial_idx, trial_idx + 1, e)
                failure = {"quarantined": True, "error": f"{type(e).__name__}: {e}"}
            tpe.tell(proposal, reward)
            fold_trials.append((proposal, reward) if failure is None
                               else (proposal, reward, failure))
            _persist_trials(fold, fold_trials)
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
                metrics_list = evaluator.evaluate_batch(fold, path, policies_t, keys)[:k_eff]
                rewards = [m["top1_valid"] for m in metrics_list]
            except (ArithmeticError, RuntimeError, ValueError, OSError) as e:
                # one pass evaluates the whole round: the round is quarantined
                rewards = [_quarantine(tpe, fold, t_base, t_base + k_eff, e)] * k_eff
                failure = {"quarantined": True, "error": f"{type(e).__name__}: {e}"}
            tpe.tell_batch(proposals, rewards)
            fold_trials.extend((p, r) if failure is None else (p, r, failure)
                               for p, r in zip(proposals, rewards))
            _persist_trials(fold, fold_trials)
            logger.info("phase2 fold %d trials %d-%d/%d (batch of %d): best_in_batch=%.4f "
                        "best=%.4f", fold, t_base, t_base + k_eff - 1, num_search, k_eff,
                        max(rewards), tpe.best[1])

    with record_function("search.phase2"):
        for fold in fold_list:
            _phase2_fold(fold)

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
    write_json_atomic(os.path.join(save_dir, "final_policy.json"), final_policy_set)
    logger.info("search done: %d sub-policies; phase1 %.1f device-s, phase2 %.1f device-s on "
                "%s", len(final_policy_set), result["device_secs_phase1"],
                result["device_secs_phase2"], result["backend"])
    result["elapsed_total"] = time.time() - t_start
    return result


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
            evaluator.load_fold(fold_paths[fold])
            sums = np.zeros(n)
            cnt = 0.0
            for start in range(0, n, chunk):
                block = subs_np[start:start + chunk]
                real = len(block)
                if real < chunk:
                    block = np.concatenate(
                        [block, np.zeros((chunk - real,) + block.shape[1:], np.float32)])
                bsum = np.zeros(chunk)
                bcnt = 0.0
                block_dev = torch.as_tensor(block, device=dev)
                for bi, batch in enumerate(evaluator.batches(fold)):
                    k = prng_key(num_draws_key)
                    for part in (fold, start, bi):
                        k = src.fold_in(k, part, dev)
                    out = evaluator.audit_eval(batch, block_dev, k)
                    bsum += out["correct_mean_sum"].cpu().numpy()
                    bcnt += float(out["cnt"])
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
