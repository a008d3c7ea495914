#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --pair-with OTHER_CHECKOUT

Run from the root of a checkout; it needs one CUDA card and ``nvcc``.  With
``--pair-with`` it only times K1, K5 and K6 of the other checkout's port
against this one's (:func:`paired_kernel_times`).  Without arguments, the phases,
each printing one JSON line:

1. environment: the card (``nvidia-smi``), torch and CUDA versions, and the
   seconds it took to build the kernels (``fast_autoaugment_tpu_torch/csrc/
   augment.cu``, ``preprocess.cu`` and ``imagenet.cu``, one ``nvcc`` each,
   in parallel);
2. kernel vs plain version on the card, bitwise with the count of
   differing elements: the augmentation kernel (all 19 ops forced on with
   both mirror signs over a sweep of levels, then random draws under all
   six policy archives, at 128x32x32, 4x17x23, 128x224x224, 3x225x223 (bands
   of unequal height), 2x496x300 (clusters of 16 at one block per SM) and
   2x520x300 (too large for a cluster: one launch per slot); at 224x224
   with clusters of 8 and of 16 blocks; one launch per call on the cluster
   path; every cluster size resident at its largest band) and the CIFAR
   stack kernel (``k5_vs_plain``: every crop offset and flip bit, cutout
   lengths 0 and 16 centred at corners, edges and random places, at
   640x32x32, 4x17x23 and 2x100x90 (read from global memory), and the eval
   stack) and the ImageNet stack kernel
   (``k6_vs_plain``: the six ColorJitter orders x both flip bits x cutout 0
   and 16, uint8, float32 and non-integral float32 inputs, at 128x224x224
   (also at every cluster size that fits), 4x17x23, 3x225x223 (bands of
   unequal height) and the two-pass path (2x1100x300 float32, 2x4200x300
   uint8), launches per call against ``ops/_kernels.py imagenet_plan``);
   and every sampler's draws on the card against the CPU from the same keys,
   the ImageNet draws (lighting normals included) over 2^20 keys
   (``lighting_cpu_vs_card``);
3. the serving path: two ``serve_cli`` processes on the card (the shipped
   ``fa_reduced_cifar10`` archive at 32x32, grouped dispatch; one ImageNet
   sub-policy at 224x224, shapes 1,8, exact dispatch) answer npz, raw and
   concurrent requests; every answer is checked against the plain version
   applied on the card to the same draws; the kernel's launch count in
   ``/stats`` must equal dispatches x launches per call (1 on the cluster
   path); SIGTERM must drain to exit 0;
4. the TTA policy-scoring path (``tta_main_path``): WRN-40-2 from the
   flagship config (:data:`FLAGSHIP`) with seeded weights, a seeded 20,000
   image uint8 fold uploaded once (157 batches of 128, the last with 32
   real images), then ``eval_tta`` of a 5-sub-policy candidate, the
   identity baseline, ``eval_tta_batched`` of 4 candidates, one audit step
   and ``eval_tta`` under grouped dispatch; the launch counts must be
   1 augmentation launch and 1 CIFAR stack launch per step call; then
   the same steps with the plain versions of both kernels on the card
   (augmented lanes bitwise, fields equal under
   ``cudnn.deterministic``) and each batched candidate against ``eval_tta``
   of that candidate alone;
5. times beside the card's name and power limit: requests/s and p50/p99
   latency of a closed-loop burst (inside phase 3, before the drain); the
   augmentation kernel per dispatch at each serving shape; a
   ``torch.profiler`` trace of the applier at the largest serving shape;
   seconds per TTA trial and images/s; both kernels at the TTA shape
   (640x32x32) against their bounds and plain versions; a
   ``torch.profiler`` trace of one ``eval_tta`` over the fold's first 16
   batches (device time by stage and the device's idle share).

6. the training path: ``train_main_path`` drives ResNet-50 from
   ``confs/resnet50.yaml`` (:data:`RESNET50`: 1000 classes, batch 128 at
   224x224, lr 0.05 with the ``resnet`` schedule over 270 epochs of the real
   run's 10,009 steps, warmup 5, nesterov, decay 1e-4, clip 0, the
   498-sub-policy ``fa_resnet50_rimagenet`` archive) through
   ``make_train_step`` with the ImageNet stack (K1, then K6) as its augment
   function, on seeded uint8 batches: 10 exact steps, one grouped step and
   one step without a policy (the uint8 batch straight into K6, as phase 1
   trains) with finite losses and 1 K1 and 1 K6 launch per step (as
   ``augment_plan`` and ``imagenet_plan`` say); then a step with the
   kernels against one with the plain versions from the same state under
   deterministic cuDNN, with and without the policy (augmented batch, loss
   and every tensor of the model bitwise).  ``train_flagship`` runs ``train_and_eval``
   with the flagship WRN-40-2 config on ``synthetic`` (2 epochs of 4 steps,
   evaluation every epoch) and checks its result dict and launch counts;
7. the search (``search_main_path``): ``launch/search_cli.py main`` with
   ``confs/wresnet40x2_cifar.yaml`` at full width (WRN-40-2) on the offline
   ``synthetic_shapes`` data, cut in depth (:data:`SEARCH_FLAGS`,
   :data:`SEARCH_EPOCHS`): phase 1 trains 2 fold models, phase 2 runs 4 TPE
   trials per fold and the audit, phase 3 retrains the default and the
   augmented arm; the fold checkpoints load back with their digests; two
   trials re-scored with the plain versions of K1 and K5 equal the kernels'
   bitwise; the same command again trains and dispatches nothing; seconds
   per fold, per trial and per run and the device's idle share over phase 2;
8. ``train_times``: the ResNet-50 step's median time and images/s, a
   profiler trace split by stage (sampler, K1, K6, model forward and
   backward with the convolutions' TFLOP/s, optimizer) with the device's
   idle share, K1 and K6 at 128x224x224 against their bounds and plain
   versions, also by CUDA-graph replay (K1 also with clusters of 8 and of
   16 blocks, K6 at every cluster size that fits, on float32 and uint8
   input, and how many such clusters the card holds at once), and the peak
   device memory.

The last two lines are the ``kernels`` summary and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero with
no result line.  Without a CUDA device, or run from a directory that does
not hold the repository, it exits non-zero at once.
"""

from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
#: K1's check shapes: serving and TTA (one block per image), odd sizes, the
#: train shape (a cluster per image), bands of unequal height, the tallest
#: image that fits clusters of 16, and an image too large for a cluster (one
#: launch per slot)
SHAPES = ((128, 32, 32), (4, 17, 23), (128, 224, 224), (3, 225, 223), (2, 496, 300),
          (2, 520, 300))
#: K1's two kernels (csrc/augment.cu): the cluster path and the per-slot path
K1_KERNELS = ("augment_kernel", "augment_slot_kernel")
#: the flagship search config: confs/wresnet40x2_cifar.yaml (model, dataset,
#: batch, cutout; precision f32 by default) and the search CLI's defaults
#: (fast_autoaugment_tpu/launch/search_cli.py: --num-policy 5, --num-op 2,
#: --cv-ratio 0.4, --aug-groups 8).  The card's machine has no YAML reader,
#: so they are constants here; tests/test_torch_tta.py holds them against the
#: JAX package's reading.  A CIFAR-10 held-out fold at cv_ratio 0.4 has
#: 0.4 x 50,000 = 20,000 images.
FLAGSHIP = {"model": "wresnet40_2", "dataset": "cifar10", "batch": 128, "cutout": 16,
            "precision": "f32", "num_policy": 5, "num_op": 2, "cv_ratio": 0.4,
            "aug_groups": 8, "fold_images": 20_000, "aug": "fa_reduced_cifar10",
            "epoch": 200, "lr": 0.1,
            "lr_schedule": {"type": "cosine", "warmup": {"multiplier": 1, "epoch": 5}},
            "optimizer": {"type": "sgd", "nesterov": True, "decay": 0.0002, "ema": 0}}
#: confs/resnet50.yaml (the ImageNet flagship of the reference) as constants,
#: held against the YAML by tests/test_torch_train.py; the smoke trains it for
#: a few steps with the real run's steps per epoch (ImageNet-1k's train set)
RESNET50 = {"model": {"type": "resnet50"}, "dataset": "imagenet", "aug": "fa_reduced_imagenet",
            "cutout": 0, "batch": 128, "epoch": 270, "lr": 0.05,
            "lr_schedule": {"type": "resnet", "warmup": {"multiplier": 1, "epoch": 5}},
            "optimizer": {"type": "sgd", "nesterov": True, "decay": 0.0001, "clip": 0,
                          "ema": 0}}
IMAGENET_TRAIN_IMAGES = 1_281_167


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def device_us_of(event) -> float:
    """An averaged profiler event's self device time in µs."""
    us = getattr(event, "self_device_time_total", None)
    return us if us is not None else getattr(event, "self_cuda_time_total", 0.0)


def kernel_device_us(prof) -> dict[str, float]:
    """Device time (µs) of each kernel name in a profile.  Only the device
    rows count: an operator's row repeats the time of the kernels it
    launched, so summing every row would count each kernel twice."""
    from torch.autograd import DeviceType

    out: dict[str, float] = {}
    for e in prof.key_averages():
        us = device_us_of(e)
        if us > 0 and getattr(e, "device_type", None) == DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + us
    return out


def device_us(prof, name_part) -> float:
    """Summed device (CUPTI) time in µs of the profiled kernels whose name
    contains `name_part` (a string, or a tuple of them)."""
    parts = (name_part,) if isinstance(name_part, str) else tuple(name_part)
    return sum(device_us_of(e) for e in prof.key_averages() if any(p in e.key for p in parts))


def kernel_counts(prof, parts) -> dict[str, int]:
    """Kernel executions in a profile for each name part."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    return {p: sum(e.count for e in rows if p in e.key) for p in parts}


def kernel_device_ms(fn, iters: int = 20, kernel="augment_kernel",
                     per_call: int = 1) -> float | None:
    """Device time of the kernels named `kernel` (a name part, or a tuple of
    them) per call of `fn`, from the profiler: the kernels' own execution,
    without the host's launch gaps.  The profiler traces a warm-up window
    of `iters` calls that it discards, then the measured one.  Each named
    kernel must appear there `per_call` times for each call; where one does
    not (the profiler can drop a row), None, and the caller reports the
    CUDA-event time of the launches instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    parts = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    for p, seen in kernel_counts(prof, parts).items():
        if seen != iters * per_call:
            print(f"chip_smoke: profiler shows {seen} launches of {p}, expected "
                  f"{iters * per_call}; reporting CUDA-event times", file=sys.stderr, flush=True)
            return None
    us = device_us(prof, kernel)
    return us / 1e3 / iters if us else None


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of `fn`: `iters` calls captured in one CUDA
    graph, replayed `replays` times between two CUDA events, so the kernels
    run back to back without the host's launch gaps and without the
    profiler (which drops kernel records)."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 2


def _rand_images(g, b, h, w, dev):
    import torch

    return torch.from_numpy(g.integers(0, 256, (b, h, w, 3)).astype(np.float32)).to(dev)


#: cluster sizes forced at 224x224 beside the plan's own (both fit there)
FORCED_CLUSTERS = (8, 16)


def _compare(aug, imgs, pol, sub, draws, clusters=(None,)) -> tuple[int, float]:
    """(differing elements, max |diff|) of kernel vs plain version, summed
    over the plan's cluster size (None) and any forced ones; each call must
    launch the kernel as often as its plan says."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels

    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    want = aug.apply_subpolicy_draws_plain(imgs, pol, sub, draws)
    n_diff, err = 0, 0.0
    for c in clusters:
        before = _kernels.launch_counts()["augment"]
        if c is None:
            got = aug.apply_subpolicy_draws(imgs, pol, sub, draws)
        else:
            got = _kernels.augment(imgs, aug.slot_records(pol, sub, draws, h, w), cluster=c)
        launches = _kernels.launch_counts()["augment"] - before
        torch.cuda.synchronize()
        if launches != _kernels.augment_plan(h, w, int(pol.shape[1]), c).launches:
            fail(f"K1 at {h}x{w} (cluster {c}) launched {launches} times in one call")
        if not bool(torch.isfinite(got).all()) or got.shape != imgs.shape:
            fail("kernel output is not finite or has the wrong shape")
        if not bool(((got >= 0) & (got <= 255) & (got == torch.trunc(got))).all()):
            fail("kernel output is not integral in [0, 255]")
        diff = (got - want).abs()
        n_diff, err = n_diff + int((diff > 0).sum()), max(err, float(diff.max()))
    return n_diff, err


def phase_kernel_vs_plain(dev) -> dict:
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.policies.archive import ARCHIVES, load_policy, policy_to_tensor

    g = np.random.default_rng(0)
    report = {"phase": "kernel_vs_plain", "tolerance": "bitwise: 0 differing elements",
              "shapes": {}, "differing_elements": 0, "max_abs_err": 0.0}
    for b, h, w in SHAPES:
        imgs = _rand_images(g, b, h, w, dev)
        imgs[: max(1, b // 4)] = torch.floor(imgs[: max(1, b // 4)] / 4 + 64)  # low range
        clusters = (None,) + FORCED_CLUSTERS if (h, w) == (224, 224) else (None,)
        per_op = {}
        for op in range(aug.NUM_OPS):
            levels = np.linspace(0.0, 1.0, 5)
            pol = torch.tensor([[[op, 1.0, lv]] for lv in levels], dtype=torch.float32, device=dev)
            sub = torch.arange(b, device=dev, dtype=torch.int32) % 5
            mirror = np.where(np.arange(b) % 2 == 0, 0.25, 0.75)  # both signs
            draws = np.stack([np.zeros(b), mirror, g.uniform(0, w, b), g.uniform(0, h, b)], -1)
            draws = torch.from_numpy(draws.astype(np.float32)[:, None, :]).to(dev)
            per_op[aug.OP_NAMES[op]] = _compare(aug, imgs, pol, sub, draws, clusters)
        per_archive = {}
        for name in ARCHIVES:
            pol = torch.from_numpy(policy_to_tensor(load_policy(name))).to(dev)
            keys = torch.from_numpy(g.integers(0, 2**32, (b, 2), dtype=np.int64)).to(dev)
            sub, draws = aug.sample_exact(keys, pol.shape[0], pol.shape[1], h, w)
            per_archive[name] = _compare(aug, imgs, pol, sub, draws, clusters)
        results = list(per_op.values()) + list(per_archive.values())
        n_diff = sum(r[0] for r in results)
        plan = _kernels.augment_plan(h, w, 2)
        report["shapes"][f"{b}x{h}x{w}"] = {
            "path": plan.path, "cluster": plan.cluster, "launches_per_call_2_slots": plan.launches,
            "forced_clusters": [c for c in clusters if c is not None],
            "ops_differing": {k: v[0] for k, v in per_op.items() if v[0]},
            "archives_differing": {k: v[0] for k, v in per_archive.items() if v[0]},
            "differing_elements": n_diff, "comparisons": len(results) * len(clusters)}
        report["differing_elements"] += n_diff
        report["max_abs_err"] = max(report["max_abs_err"], max(r[1] for r in results))
    # every cluster size the planner may take, at the most shared memory it
    # takes it with (the tallest band that fits), must be resident
    resident = {}
    for c in _kernels.AUGMENT_CLUSTERS:
        h = max(h for h in range(1, 2048)
                if _kernels.augment_smem_bytes(h, 300, c) <= _kernels.MAX_SMEM_BYTES)
        resident[str(c)] = _kernels.augment_max_active_clusters(h, 300, cluster=c,
                                                                device=dev.index or 0)
    report["max_active_clusters_at_largest_band"] = resident
    if min(resident.values()) < 1:
        fail(f"a planned cluster size cannot be resident: {resident}")
    # the samplers: bit-identical on the card and the CPU
    keys = torch.from_numpy(g.integers(0, 2**32, (512, 2), dtype=np.int64))
    a = aug.sample_exact(keys.to(dev), 493, 2, 224, 224)
    c = aug.sample_exact(keys, 493, 2, 224, 224)
    ga = aug.sample_grouped(keys[0].to(dev), 128, 8, 493, 2, 32, 32)
    gc = aug.sample_grouped(keys[0], 128, 8, 493, 2, 32, 32)
    report["sampler_bitwise_cuda_vs_cpu"] = all(
        torch.equal(x.cpu(), y) for x, y in zip(a + ga, c + gc))
    emit(report)
    if report["differing_elements"] or not report["sampler_bitwise_cuda_vs_cpu"]:
        fail("kernel and plain version disagree on the card")
    return report


def _stack_draws(g, b, h, w):
    """``[b, 5]`` draws: every crop offset and flip bit in turn (all 162 when
    b >= 162), cutout centres at the corners and edges, then at random."""
    import torch

    edges = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (h // 2, 0), (0, w // 2)]
    rows = []
    for i in range(b):
        j = i % 162
        cy, cx = edges[i % 6] if i % 12 < 6 else (int(g.integers(0, h)), int(g.integers(0, w)))
        rows.append((j // 18, (j // 2) % 9, j % 2, cy, cx))
    return torch.tensor(rows, dtype=torch.int32)


def phase_k5_vs_plain(dev) -> dict:
    """The CIFAR stack kernel against its plain version on the card, and
    the new draws on the card against the CPU."""
    import torch

    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess as pre
    from fast_autoaugment_tpu_torch.ops import rng
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    g = np.random.default_rng(5)
    report = {"phase": "k5_vs_plain", "tolerance": "bitwise: 0 differing elements",
              "cases": {}, "differing_elements": 0, "max_abs_err": 0.0}

    def compare(tag, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not got.is_contiguous(memory_format=torch.channels_last):
            fail(f"k5 {tag}: shape {tuple(got.shape)} or layout is wrong")
        if not bool(torch.isfinite(got).all()):
            fail(f"k5 {tag}: output is not finite")
        diff = (got - want).abs()
        n_diff, err = int((diff > 0).sum()), float(diff.max())
        report["cases"][tag] = n_diff
        report["differing_elements"] += n_diff
        report["max_abs_err"] = max(report["max_abs_err"], err)

    # staged in shared memory up to 40x24; 100x90 is read from global memory
    for b, h, w in ((640, 32, 32), (4, 17, 23), (6, 40, 24), (2, 100, 90)):
        imgs = _rand_images(g, b, h, w, dev)
        draws = _stack_draws(g, b, h, w).to(dev)
        for length in (0, 16):
            compare(f"{b}x{h}x{w}_cutout{length}",
                    pre.cifar_stack(imgs, draws, cutout_length=length),
                    pre.cifar_stack_plain(imgs, draws, cutout_length=length))
        compare(f"{b}x{h}x{w}_eval", pre.cifar_eval_batch(imgs),
                pre.cifar_stack_plain(imgs, pre.eval_draws(b, dev), cutout_length=0))
    # the new draws: crop draws and the TTA key tree, card against CPU
    keys = rng.split(torch.tensor([4, 2]), 4096)
    same = [torch.equal(aug.sample_crop(keys.to(dev), 32, 32).cpu(), aug.sample_crop(keys, 32, 32))]
    src, key = PhiloxDraws(), torch.tensor([7, 9])
    for dispatch in ("exact", "grouped"):
        on = {"card": dev, "cpu": torch.device("cpu")}
        d = {}
        for where, device in on.items():
            k = src.fold_in(key, 3, device)
            d[where] = src.draws(src.split(k, 5, device), batch=128, num_sub=5, num_op=2,
                                 height=32, width=32, dispatch=dispatch, groups=8,
                                 device=device)
        same += [torch.equal(getattr(d["card"], f).cpu(), getattr(d["cpu"], f))
                 for f in ("sub_idx", "policy", "crop")]
    report["draws_bitwise_cuda_vs_cpu"] = all(same)
    emit(report)
    if report["differing_elements"] or not report["draws_bitwise_cuda_vs_cpu"]:
        fail("the CIFAR stack kernel and its plain version, or the draws, disagree on the card")
    return report


# --------------------------------------------------------------- phase 3


class Replica:
    """One ``serve_cli`` process on the card."""

    def __init__(self, args: list[str], workdir: str, tag: str):
        self.port_file = os.path.join(workdir, f"{tag}.port")
        self.log_path = os.path.join(workdir, f"{tag}.log")
        self.log = open(self.log_path, "w")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "fast_autoaugment_tpu_torch.serve.serve_cli", *args,
             "--port", "0", "--port-file", self.port_file],
            cwd=REPO, env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self.port = None

    def wait_ready(self, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                fail(f"serve_cli exited with {self.proc.returncode}: {self.tail()}")
            if os.path.exists(self.port_file):
                self.port = int(open(self.port_file).read())
                return
            time.sleep(0.1)
        fail(f"serve_cli did not come up within {timeout}s: {self.tail()}")

    def tail(self) -> str:
        self.log.flush()
        with open(self.log_path) as fh:
            return fh.read()[-3000:]

    def get(self, path: str) -> dict:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}", timeout=60) as r:
            return json.loads(r.read())

    def post(self, body: bytes, ctype: str) -> bytes:
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}/augment", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as r:
            if r.status != 200:
                fail(f"/augment answered {r.status}")
            return r.read()

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                return self.proc.wait(timeout=60)
            finally:
                self.log.close()
        self.log.close()
        return self.proc.returncode

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _npz(images, seeds=None) -> bytes:
    buf = io.BytesIO()
    if seeds is None:
        np.savez(buf, images=images)
    else:
        np.savez(buf, images=images, seeds=seeds)
    return buf.getvalue()


def _plain_on_card(aug, images, policy, sub, draws):
    import torch

    out = aug.apply_subpolicy_draws_plain(images, policy, sub, draws)
    return torch.clamp(out, 0, 255).to(torch.uint8).cpu().numpy()


def phase_main_path(dev, workdir: str) -> dict:
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
    from fast_autoaugment_tpu_torch.serve import wire
    from fast_autoaugment_tpu_torch.serve.policy_server import pick_shape
    from fast_autoaugment_tpu_torch.serve.serve_cli import seed_keys

    g = np.random.default_rng(1)
    cifar = torch.from_numpy(policy_to_tensor(load_policy("fa_reduced_cifar10"))).to(dev)
    imagenet_sub = [list(load_policy("fa_resnet50_rimagenet")[0])]
    single_path = os.path.join(workdir, "final_policy.json")
    with open(single_path, "w") as fh:
        json.dump(imagenet_sub, fh)
    single = torch.from_numpy(policy_to_tensor(imagenet_sub)).to(dev)

    _kernels.reset_launch_counts()  # the main path runs in the replicas below
    grouped = Replica(["--policy", "fa_reduced_cifar10", "--image", "32"], workdir, "grouped")
    exact = Replica(["--policy", single_path, "--image", "224", "--shapes", "1,8"], workdir, "exact")
    replicas = [grouped, exact]
    try:
        for r in replicas:
            r.wait_ready()
        before = {id(r): r.get("/stats") for r in replicas}
        for r in replicas:
            if before[id(r)]["kernel_launches"]["augment"] != 0 or before[id(r)]["dispatches"]:
                fail("a replica launched the kernel before serving any request")
            if not r.get("/readyz")["ready"]:
                fail("a replica is not ready")
        requests = 0

        # grouped, 32x32: sequential requests, each its own dispatch with the
        # server's key (0, d) over the padded batch -> checkable on the card
        shapes = tuple(before[id(grouped)]["shapes"])
        for i, n in enumerate((1, 3, 8, 20, 32, 100, 128, 5)):
            imgs = g.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)
            d = grouped.get("/stats")["dispatches"]
            if i % 2 == 0:
                got = np.load(io.BytesIO(grouped.post(_npz(imgs), "application/octet-stream")))["images"]
            else:
                got, _ = wire.decode_raw(grouped.post(wire.encode_raw(imgs), wire.RAW_CONTENT_TYPE))
            requests += 1
            s = pick_shape(shapes, n)
            x = torch.zeros((s, 32, 32, 3), device=dev)
            x[:n] = torch.from_numpy(imgs.astype(np.float32)).to(dev)
            sub, draws = aug.sample_grouped(torch.tensor([0, d], device=dev), s, 8,
                                            cifar.shape[0], cifar.shape[1], 32, 32)
            want = _plain_on_card(aug, x, cifar, sub, draws)[:n]
            if got.dtype != np.uint8 or got.shape != imgs.shape or not np.array_equal(got, want):
                fail(f"grouped answer {i} ({n} images) differs from the plain version")

        # grouped: a concurrent burst that coalesces
        burst_n = 24
        burst = [g.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8) for _ in range(burst_n)]
        answers: list = [None] * burst_n
        d0 = grouped.get("/stats")["dispatches"]

        def send(j):
            answers[j] = wire.decode_raw(grouped.post(wire.encode_raw(burst[j]), wire.RAW_CONTENT_TYPE))[0]

        threads = [threading.Thread(target=send, args=(j,)) for j in range(burst_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        requests += burst_n
        burst_dispatches = grouped.get("/stats")["dispatches"] - d0
        if any(a is None or a.shape != (2, 32, 32, 3) or a.dtype != np.uint8 for a in answers):
            fail("a burst answer is missing or malformed")
        if burst_dispatches >= burst_n:
            fail("the burst did not coalesce")

        # exact, 224x224: each lane depends on its own seed only
        seeds = g.integers(0, 2**31, 8)
        imgs = g.integers(0, 256, (8, 224, 224, 3)).astype(np.uint8)
        keys = seed_keys(seeds)
        x = torch.from_numpy(imgs.astype(np.float32)).to(dev)
        sub, draws = aug.sample_exact(torch.from_numpy(keys.astype(np.int64)).to(dev), 1,
                                      single.shape[1], 224, 224)
        want = _plain_on_card(aug, x, single, sub, draws)
        alone = []
        for j in range(3):
            got = np.load(io.BytesIO(exact.post(_npz(imgs[j:j + 1], seeds[j:j + 1]),
                                                "application/octet-stream")))["images"]
            alone.append(got)
            requests += 1
        got, _ = wire.decode_raw(exact.post(wire.encode_raw(imgs, seeds=keys), wire.RAW_CONTENT_TYPE))
        requests += 1
        if not np.array_equal(got, want):
            fail("exact 224 answer differs from the plain version")
        together: list = [None] * 8

        def send_exact(j):
            together[j] = np.load(io.BytesIO(exact.post(
                _npz(imgs[j:j + 1], seeds[j:j + 1]), "application/octet-stream")))["images"]

        threads = [threading.Thread(target=send_exact, args=(j,)) for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        requests += 8
        if any(not np.array_equal(together[j], want[j:j + 1]) for j in range(8)) or \
                any(not np.array_equal(alone[j], want[j:j + 1]) for j in range(3)):
            fail("an exact lane's bytes depend on its batch")

        after = {id(r): r.get("/stats") for r in replicas}
        launches, dispatches = 0, 0
        per_call = {id(grouped): _kernels.augment_plan(32, 32, int(cifar.shape[1])).launches,
                    id(exact): _kernels.augment_plan(224, 224, int(single.shape[1])).launches}
        for r in replicas:
            st = after[id(r)]
            n_launch = st["kernel_launches"]["augment"]
            if n_launch <= 0 or n_launch != st["dispatches"] * per_call[id(r)]:
                fail(f"launch count {n_launch} != dispatches {st['dispatches']} x "
                     f"{per_call[id(r)]} launches per call")
            launches += n_launch
            dispatches += st["dispatches"]
        if _kernels.launch_counts()["augment"] != 0:
            fail("the smoke process itself launched the kernel during the main path")
        served = sum(after[id(r)]["requests"] for r in replicas)
        if served != requests or requests < 16:
            fail(f"replicas served {served} requests, sent {requests}")
        emit({"phase": "main_path", "requests": requests, "dispatches": dispatches,
              "kernel_launches": launches, "launches_per_dispatch": list(per_call.values()),
              "burst_requests": burst_n,
              "burst_dispatches": burst_dispatches,
              "grouped_stats": {k: after[id(grouped)][k] for k in
                                ("dispatches", "requests", "images_served", "mean_batch")},
              "exact_stats": {k: after[id(exact)][k] for k in
                              ("dispatches", "requests", "images_served", "mean_batch")}})
        serve = phase_serve_burst(grouped)
        final = grouped.get("/stats")
        if final["kernel_launches"]["augment"] != final["dispatches"] * per_call[id(grouped)]:
            fail("launch count drifted from dispatches x launches per call during the burst")
        rcs = [r.stop() for r in replicas]
        if rcs != [0, 0]:
            fail(f"SIGTERM drain exit codes {rcs} (want 0): {grouped.tail()} {exact.tail()}")
        emit({"phase": "drain", "exit_codes": rcs})
        return {"launches": launches, "serve": serve}
    finally:
        for r in replicas:
            r.kill()


def phase_serve_burst(replica, clients: int = 16, per_client: int = 25, n: int = 8) -> dict:
    """Closed loop: `clients` threads each send `per_client` raw requests of
    `n` 32x32 images back to back."""
    from fast_autoaugment_tpu_torch.serve import wire

    g = np.random.default_rng(2)
    body = wire.encode_raw(g.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8))
    lat: list[float] = []
    lock = threading.Lock()
    errors: list[str] = []

    def client():
        for _ in range(per_client):
            t0 = time.perf_counter()
            try:
                replica.post(body, wire.RAW_CONTENT_TYPE)
            except Exception as e:  # noqa: BLE001 -- counted, fails the phase below
                errors.append(repr(e))
                return
            with lock:
                lat.append(time.perf_counter() - t0)

    d0 = replica.get("/stats")["dispatches"]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or len(lat) != clients * per_client:
        fail(f"closed-loop burst lost requests: {errors[:3]}")
    ms = np.array(lat) * 1e3
    out = {"phase": "serve_burst", "card": nvidia_smi(), "clients": clients,
           "requests": len(lat), "images_per_request": n, "image": 32,
           "policy": "fa_reduced_cifar10", "dispatch": "grouped",
           "requests_per_s": len(lat) / wall, "images_per_s": len(lat) * n / wall,
           "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
           "dispatches": replica.get("/stats")["dispatches"] - d0}
    emit(out)
    return out


# --------------------------------------------------------------- phase 4

#: float operations per pixel and channel that each op needs (a floor
#: for the operations bound; memory bounds the kernel either way)
_FLOPS = {"ShearX": 4, "ShearY": 4, "TranslateX": 4, "TranslateY": 4, "Rotate": 4,
          "AutoContrast": 2, "Invert": 2, "Equalize": 2, "Solarize": 2, "Posterize": 1,
          "Contrast": 6, "Color": 6, "Brightness": 4, "Sharpness": 24, "Cutout": 4,
          "CutoutAbs": 4, "Posterize2": 1, "TranslateXAbs": 4, "TranslateYAbs": 4}


def phase_times(dev, card: str) -> list[dict]:
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor

    g = np.random.default_rng(3)
    cifar = torch.from_numpy(policy_to_tensor(load_policy("fa_reduced_cifar10"))).to(dev)
    single = torch.from_numpy(policy_to_tensor([load_policy("fa_resnet50_rimagenet")[0]])).to(dev)
    rows = []
    for (b, img, policy, dispatch) in [(1, 32, cifar, "grouped"), (8, 32, cifar, "grouped"),
                                       (32, 32, cifar, "grouped"), (128, 32, cifar, "grouped"),
                                       (1, 224, single, "exact"), (8, 224, single, "exact")]:
        x = _rand_images(g, b, img, img, dev)
        if dispatch == "grouped":
            sub, draws = aug.sample_grouped(torch.tensor([0, 7], device=dev), b, 8,
                                            policy.shape[0], policy.shape[1], img, img)
        else:
            sub, draws = aug.sample_exact(torch.arange(2 * b, device=dev).reshape(b, 2), 1,
                                          policy.shape[1], img, img)
        rec = aug.slot_records(policy, sub, draws, img, img)
        plan = _kernels.augment_plan(img, img, int(policy.shape[1]))
        kernel_event_ms = cuda_ms(lambda: _kernels.augment(x, rec))
        kernel_graph_ms = graph_ms(lambda: _kernels.augment(x, rec))
        kernel_ms = kernel_device_ms(lambda: _kernels.augment(x, rec), kernel=plan.kernel,
                                     per_call=plan.launches)
        wrapper_ms = cuda_ms(lambda: aug.apply_subpolicy_draws(x, policy, sub, draws))
        plain_ms = cuda_ms(lambda: aug.apply_subpolicy_draws_plain(x, policy, sub, draws),
                           iters=5, warmup=1)
        elems = b * img * img * 3
        nbytes = 2 * elems * 4 + rec.numel() * 4  # images in + out once, records in
        on = rec[..., 1] > 0
        ops = sum(_FLOPS[aug.OP_NAMES[int(k)]] * img * img * 3
                  for k in rec[..., 0][on].to(torch.int64).tolist())
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        rows.append({"batch": b, "image": img, "dispatch": dispatch,
                     "num_op": int(policy.shape[1]), "launches_per_call": plan.launches,
                     "cluster": plan.cluster, "kernel_ms": kernel_ms,
                     "kernel_event_ms": kernel_event_ms, "kernel_graph_ms": kernel_graph_ms,
                     "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "bytes": nbytes, "ops": ops, "library_ms": None})
    emit({"phase": "times", "card": card, "rows": rows,
          "timing": "kernel_ms: the kernel's device time per dispatch (all op slots) from "
                    "torch.profiler over 20 calls; kernel_graph_ms: 20 calls in a CUDA graph "
                    "replayed 5 times; *_event_ms, wrapper_ms, plain_ms: CUDA "
                    "events around 20 back-to-back calls after 3 warm-up calls (plain: 5 "
                    "after 1), host launch gaps included; inputs stay in L2 between calls"})
    return rows


def phase_trace(dev, card: str) -> dict:
    """``torch.profiler`` over 20 ``PolicyApplier.apply`` calls at the
    largest serving shape (128 x 32 x 32, grouped): device time by kernel
    and the device's idle share of the wall (the HTTP layer excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
    from fast_autoaugment_tpu_torch.serve.policy_server import PolicyApplier

    applier = PolicyApplier(policy_to_tensor(load_policy("fa_reduced_cifar10")), image=32,
                            device=dev)
    imgs = np.random.default_rng(4).integers(0, 256, (128, 32, 32, 3)).astype(np.uint8)
    for i in range(3):
        applier.apply(imgs, np.uint32([9, i]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(20):
            applier.apply(imgs, np.uint32([9, 100 + i]))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = kernel_device_us(prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"phase": "trace", "card": card, "calls": 20, "batch": 128, "image": 32,
           "wall_ms_per_call": wall_s * 1e3 / 20,
           "device_busy_ms_per_call": busy_us / 1e3 / 20 if busy_us else None,
           "device_idle_share": (1 - busy_us / 1e6 / wall_s) if busy_us else None,
           "device_kernels": len(by_name),
           "augment_kernel_us_per_call": device_us(prof, K1_KERNELS) / 20,
           "top_device_us_per_call": {k[:80]: v / 20 for k, v in top}}
    emit(out)
    return out


# ------------------------------------------------------------ TTA path

TTA_FIELDS = ("minus_loss", "top1_valid", "top1_mean", "cnt")
#: stages of the TTA step (its torch.profiler ranges, search/tta.py)
TTA_STAGES = ("tta.sampler", "tta.augment", "tta.model", "tta.reductions")
TRACE_BATCHES = 16


def _tta_policy(g, num_sub: int, num_op: int) -> np.ndarray:
    """A random candidate: ops from the 15 search ops, prob and level uniform."""
    pol = np.zeros((num_sub, num_op, 3), np.float32)
    pol[..., 0] = g.integers(0, 15, (num_sub, num_op))
    pol[..., 1:] = g.uniform(0.0, 1.0, (num_sub, num_op, 2))
    return pol


class _Capture:
    """An augment_fn that keeps its output for the step calls in `keep`."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls, self.out = fn, set(keep), 0, {}

    def __call__(self, images, policy, draws):
        x = self.fn(images, policy, draws)
        if self.calls in self.keep:
            self.out[self.calls] = x.clone()
        self.calls += 1
        return x


def _plain_augment(cutout):
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess as pre

    def fn(images, policy, d):
        x = aug.apply_subpolicy_draws_plain(images.contiguous(), policy, d.sub_idx, d.policy)
        return pre.cifar_stack_plain(x, d.crop, cutout_length=cutout)
    return fn


def _check_fields(tag: str, r: dict, cnt: float) -> None:
    vals = [r[f] for f in TTA_FIELDS]
    if not all(np.isfinite(vals)) or r["cnt"] != cnt:
        fail(f"{tag}: fields not finite or count {r['cnt']} != {cnt}: {r}")
    if not (r["minus_loss"] <= 0 and 0 <= r["top1_mean"] <= r["top1_valid"] <= 1):
        fail(f"{tag}: fields out of range: {r}")


def tta_setup(dev) -> dict:
    """WRN-40-2 with seeded weights and the seeded fold, uploaded once."""
    import torch

    from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset
    from fast_autoaugment_tpu_torch.data.pipeline import device_batches, eval_batches
    from fast_autoaugment_tpu_torch.models import get_model, num_class

    c = FLAGSHIP
    classes = num_class(c["dataset"])
    model = get_model({"type": c["model"], "precision": c["precision"]}, classes,
                      device=dev, seed=0)
    g = np.random.default_rng(7)
    n = c["fold_images"]
    fold = ArrayDataset(g.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
                        g.integers(0, classes, (n,), dtype=np.int32), classes)
    t0 = time.perf_counter()
    batches = device_batches(eval_batches(fold, None, c["batch"], pad_multiple=c["batch"]),
                             device=dev)
    torch.cuda.synchronize()
    return {"model": model, "batches": batches, "upload_s": time.perf_counter() - t0,
            "policy": _tta_policy(g, c["num_policy"], c["num_op"]),
            "candidates": np.stack([_tta_policy(g, c["num_policy"], c["num_op"])
                                    for _ in range(4)]),
            "key": torch.tensor([0, 42], device=dev),
            "keys": torch.tensor([[0, 100 + i] for i in range(4)], device=dev)}


def phase_tta_main_path(dev, st: dict) -> dict:
    """The TTA scoring path through its entry points, with the launch
    counts set to 0 just before and read just after; then the checks."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.search import tta

    c = FLAGSHIP
    model, batches = st["model"], st["batches"]
    n_batches, last_real = len(batches), int(batches[-1]["m"].sum())
    if n_batches != -(-c["fold_images"] // c["batch"]) or batches[-1]["x"].shape[0] != c["batch"]:
        fail(f"fold of {n_batches} batches is not padded to full batches")
    opts = dict(num_policy=c["num_policy"], cutout_length=c["cutout"])
    step = tta.make_tta_step(model, **opts)
    step_k = tta.make_tta_step(model, num_candidates=4, **opts)
    audit = tta.make_audit_step(model, **opts)
    step_g = tta.make_tta_step(model, aug_dispatch="grouped", aug_groups=c["aug_groups"], **opts)
    identity = np.zeros((1, c["num_op"], 3), np.float32)  # search/driver.py:491
    b0 = batches[0]

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    exact = tta.eval_tta(step, batches, st["policy"], st["key"])
    baseline = tta.eval_tta(step, batches, identity, torch.tensor([0, 17], device=dev))
    batched = tta.eval_tta_batched(step_k, batches, st["candidates"], st["keys"])
    audit_out = {f: v.cpu().numpy().tolist()
                 for f, v in audit(b0["x"], b0["y"], b0["m"], st["policy"], st["key"]).items()}
    grouped = tta.eval_tta(step_g, batches, st["policy"], st["key"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernels.launch_counts()

    calls = 4 * n_batches + 1
    per_call = _kernels.augment_plan(32, 32, c["num_op"]).launches
    want = {"augment": per_call * calls, "cifar_stack": calls, "imagenet_stack": 0}
    if counts != want:
        fail(f"TTA launch counts {counts} != {want} ({calls} step calls)")
    for tag, r in [("exact", exact), ("baseline", baseline), ("grouped", grouped)] + \
            [(f"batched[{k}]", r) for k, r in enumerate(batched)]:
        _check_fields(tag, r, float(c["fold_images"]))
    if audit_out["cnt"] != c["batch"] or len(audit_out["correct_mean_sum"]) != c["num_policy"]:
        fail(f"audit step output is malformed: {audit_out}")

    # kernels against their plain versions on the card: the same step, the
    # same draws and weights; lanes bitwise, fields equal under deterministic cuDNN
    keep = (0, n_batches - 1)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        fns = {"kernel": _Capture(tta.cifar_augment_fn(c["cutout"]), keep),
               "plain": _Capture(_plain_augment(c["cutout"]), keep)}
        res = {k: tta.eval_tta(tta.make_tta_step(model, augment_fn=fn, **opts), batches,
                               st["policy"], st["key"]) for k, fn in fns.items()}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    lanes_diff = sum(int((fns["kernel"].out[i] != fns["plain"].out[i]).sum()) for i in keep)
    lanes_err = max(float((fns["kernel"].out[i] - fns["plain"].out[i]).abs().max()) for i in keep)
    if lanes_diff or res["kernel"] != res["plain"]:
        fail(f"TTA step with kernels vs plain versions: {lanes_diff} lane elements differ, "
             f"fields {res}")

    # each batched candidate against eval_tta of that candidate alone: the
    # forwards run at batch sizes 2560 and 640, whose cuDNN algorithms may
    # round differently; a top-1 can flip only where two logits are that close
    single = [tta.eval_tta(step, batches, st["candidates"][k], st["keys"][k]) for k in range(4)]
    dev_max = {f: max(abs(batched[k][f] - single[k][f]) for k in range(4)) for f in TTA_FIELDS}
    tol = {"minus_loss": 1e-4, "top1_valid": 10 / c["fold_images"],
           "top1_mean": 10 / c["fold_images"], "cnt": 0.0}
    if any(dev_max[f] > tol[f] for f in TTA_FIELDS):
        fail(f"batched candidates differ from single: {dev_max} (tolerance {tol})")

    out = {"phase": "tta_main_path", "model": c["model"], "dataset": c["dataset"],
           "fold_images": c["fold_images"], "batches": n_batches, "last_batch_real": last_real,
           "batch": c["batch"], "num_policy": c["num_policy"], "num_op": c["num_op"],
           "upload_s": st["upload_s"], "main_path_wall_s": wall, "step_calls": calls,
           "launches": counts, "expected_launches": want,
           "exact": exact, "baseline": baseline, "grouped": grouped, "batched": batched,
           "audit": audit_out, "plain_vs_kernel": {"lane_elements_differing": lanes_diff,
                                                   "lanes_max_abs_err": lanes_err,
                                                   "fields_equal": True, "kernel": res["kernel"]},
           "batched_vs_single_max_abs": dev_max, "batched_vs_single_tolerance": tol}
    emit(out)
    return out


def _stage_device_us(prof, stages=TTA_STAGES) -> dict:
    """Device time (µs) under each stage's profiler range."""
    from torch.autograd import DeviceType

    totals = dict.fromkeys(stages, 0.0)
    for e in prof.events():
        if e.name in totals and e.device_type == DeviceType.CPU:
            totals[e.name] += getattr(e, "device_time_total", 0.0) or 0.0
    return totals


def model_flops(model, dev, size: int = 32) -> int:
    """Float operations (2 per multiply-add) of one image's forward through
    the model's convolutions and dense layers."""
    import torch

    macs = [0]

    def hook(mod, _inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
            macs[0] += out.numel() * k
        elif isinstance(mod, torch.nn.Linear):
            macs[0] += out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(torch.zeros((1, 3, size, size), device=dev).to(memory_format=torch.channels_last))
    finally:
        for h in handles:
            h.remove()
    return 2 * macs[0]


def k1_op_sweep(x) -> dict:
    """K1's device ms per call (CUDA-graph replay) on the images `x` with one
    slot of each op forced on, and with the slot gated off (the floor: the
    image staged and written back, no op)."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import augment as aug

    b, h, w = (int(v) for v in x.shape[:3])
    g = np.random.default_rng(9)
    draws = np.stack([np.full(b, 0.5), np.full(b, 0.25), g.uniform(0, w, b), g.uniform(0, h, b)],
                     -1).astype(np.float32)[:, None]
    draws = torch.from_numpy(draws).to(x.device)
    sub = torch.zeros(b, dtype=torch.int32, device=x.device)
    out = {}
    for op in [None] + list(range(aug.NUM_OPS)):
        pol = torch.tensor([[[op or 0, 0.0 if op is None else 1.0, 0.7]]], device=x.device)
        rec = aug.slot_records(pol, sub, draws, h, w)
        out["gate_off" if op is None else aug.OP_NAMES[op]] = graph_ms(
            lambda: _kernels.augment(x, rec))
    return out


def phase_tta_times(dev, st: dict, card: str) -> dict:
    """Seconds per trial, both kernels at the TTA shape, and a profiler
    trace of one eval_tta."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess as pre
    from fast_autoaugment_tpu_torch.search import tta

    c = FLAGSHIP
    batches, p = st["batches"], c["num_policy"]
    step = tta.make_tta_step(st["model"], num_policy=p, cutout_length=c["cutout"])
    trials = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tta.eval_tta(step, batches, st["policy"], torch.tensor([1, i], device=dev))
        torch.cuda.synchronize()
        trials.append(time.perf_counter() - t0)
    s_trial = float(np.median(trials))

    # both kernels at the step's shape: P x B = 640 lanes of 32x32
    x = batches[0]["x"].to(torch.float32).repeat(p, 1, 1, 1).contiguous()
    pol = torch.as_tensor(st["policy"], device=dev)
    src = tta.PhiloxDraws()
    d = src.draws(src.split(st["key"], p, dev), batch=c["batch"], num_sub=pol.shape[0],
                  num_op=pol.shape[1], height=32, width=32, dispatch="exact", groups=8,
                  device=dev)
    rec = aug.slot_records(pol, d.sub_idx, d.policy, 32, 32)
    y = _kernels.augment(x, rec)
    elems = x.numel()
    plan = _kernels.augment_plan(32, 32, int(pol.shape[1]))
    k1 = {"kernel": "augment", "shape": list(x.shape), "num_op": int(pol.shape[1]),
          "launches_per_call": plan.launches, "cluster": plan.cluster,
          "kernel_ms": kernel_device_ms(lambda: _kernels.augment(x, rec), kernel=plan.kernel,
                                        per_call=plan.launches),
          "kernel_event_ms": cuda_ms(lambda: _kernels.augment(x, rec)),
          "kernel_graph_ms": graph_ms(lambda: _kernels.augment(x, rec)),
          "plain_ms": cuda_ms(lambda: aug.apply_subpolicy_draws_plain(x, pol, d.sub_idx, d.policy),
                              iters=5, warmup=1),
          "bytes": 2 * elems * 4 + rec.numel() * 4,
          "by_op_graph_ms": k1_op_sweep(x)}
    k5 = {"kernel": "cifar_stack", "shape": list(x.shape),
          "kernel_ms": kernel_device_ms(lambda: pre.cifar_stack(y, d.crop, cutout_length=16),
                                        kernel="cifar_stack_kernel"),
          "kernel_event_ms": cuda_ms(lambda: pre.cifar_stack(y, d.crop, cutout_length=16)),
          "kernel_graph_ms": graph_ms(lambda: pre.cifar_stack(y, d.crop, cutout_length=16)),
          "plain_ms": cuda_ms(lambda: pre.cifar_stack_plain(y, d.crop, cutout_length=16),
                              iters=5, warmup=1),
          "bytes": 2 * elems * 4 + d.crop.numel() * 4, "ops": 3 * elems}
    for k in (k1, k5):
        bytes_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = k.get("ops", 0) / FP32_OPS_PER_S * 1e3
        k.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None)

    # a profiler trace of one eval_tta over the first TRACE_BATCHES batches
    # of the fold (the profiler's post-processing takes about 2 s per batch)
    traced = batches[:TRACE_BATCHES]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tta.eval_tta(step, traced, st["policy"], torch.tensor([2, 0], device=dev))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    t_post = time.perf_counter()
    by_name = kernel_device_us(prof)
    busy_us = sum(v for k, v in by_name.items() if not k.startswith("tta."))
    stages = _stage_device_us(prof)
    k1_us, k5_us = device_us(prof, K1_KERNELS), device_us(prof, "cifar_stack_kernel")
    n = len(traced)
    split_ms = {"sampler": stages["tta.sampler"], "augment_kernel_K1": k1_us,
                "cifar_stack_kernel_K5": k5_us,
                "augment_other": stages["tta.augment"] - k1_us - k5_us,
                "model": stages["tta.model"], "reductions": stages["tta.reductions"]}
    split_ms = {k: v / 1e3 / n for k, v in split_ms.items()}
    top = sorted(((k, v) for k, v in by_name.items() if not k.startswith("tta.")),
                 key=lambda kv: -kv[1])[:10]
    conv_us = sum(v for k, v in by_name.items() if "fprop" in k or "conv" in k.lower())
    flop = model_flops(st["model"], dev) * p * c["batch"]
    out = {"phase": "tta_times", "card": card, "fold_images": c["fold_images"],
           "num_policy": p, "seconds_per_trial": s_trial, "trial_seconds": trials,
           "images_per_s": p * c["fold_images"] / s_trial, "k1": k1, "k5": k5,
           "trace": {"wall_s": wall_s, "batches": n,
                     "device_busy_ms_per_batch": busy_us / 1e3 / n,
                     "device_idle_share": 1 - busy_us / 1e6 / wall_s if busy_us else None,
                     "device_idle_share_at_trial_wall": (1 - busy_us / 1e6 / n * len(batches)
                                                         / s_trial) if busy_us else None,
                     "device_ms_per_batch_by_stage": split_ms,
                     "convolution_kernels_ms_per_batch": conv_us / 1e3 / n,
                     "model_gflop_per_batch": flop / 1e9,
                     "model_flop_bound_ms": flop / FP32_OPS_PER_S * 1e3,
                     "convolution_tflop_per_s": flop / (conv_us / n * 1e-6) / 1e12
                     if conv_us else None,
                     "stage_ranges_found": any(v > 0 for v in stages.values()),
                     "top_device_ms_per_batch": {k[:90]: v / 1e3 / n for k, v in top},
                     "postprocess_s": time.perf_counter() - t_post},
           "timing": "seconds_per_trial: median of 3 eval_tta over the fold, host clock, "
                     "synchronized; kernel_ms: device time from torch.profiler over 20 calls; "
                     "kernel_graph_ms and by_op_graph_ms: CUDA-graph replay; "
                     "*_event_ms and plain_ms: CUDA events around back-to-back calls, host "
                     "gaps included; the trace runs with the profiler on (host time inflated), "
                     "device_idle_share_at_trial_wall sets its device time per batch against "
                     "the unprofiled trial's wall per batch"}
    emit(out)
    return out


# ------------------------------------------------- lighting normals

#: keys of the lighting check: 2^20 and an odd remainder
LIGHTING_KEYS = (1 << 20) + 37


def phase_lighting_cpu_vs_card(dev) -> dict:
    """The ImageNet stack's draws (``ops/augment.py sample_imagenet``: flip,
    jitter order, cutout centre, jitter factors and the Box-Muller lighting
    normals) from the same keys on the CPU and on the card: ``ints`` and
    ``floats`` must be the same bits."""
    import torch

    from fast_autoaugment_tpu_torch.ops.augment import sample_imagenet

    n = LIGHTING_KEYS
    keys = torch.stack([torch.full((n,), 11, dtype=torch.int64),
                        torch.arange(n, dtype=torch.int64) * 7919], dim=1)
    t0 = time.perf_counter()
    ints_cpu, floats_cpu = sample_imagenet(keys, 224, 224)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ints_gpu, floats_gpu = sample_imagenet(keys.to(dev), 224, 224)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    ints_diff = int((ints_gpu.cpu() != ints_cpu).sum())
    bits_diff = int((floats_gpu.cpu().view(torch.int32) != floats_cpu.view(torch.int32)).sum())
    normals_diff = int((floats_gpu.cpu()[:, 3:].view(torch.int32)
                        != floats_cpu[:, 3:].view(torch.int32)).sum())
    out = {"phase": "lighting_cpu_vs_card", "keys": n, "ints_differing": ints_diff,
           "float_bits_differing": bits_diff, "normal_bits_differing": normals_diff,
           "normals_std": float(floats_cpu[:, 3:].std()), "cpu_s": cpu_s, "card_s": card_s}
    emit(out)
    if ints_diff or bits_diff:
        fail(f"ImageNet draws differ between the CPU and the card: {out}")
    return out


# --------------------------------------------------------- search path

#: the search's main path (search_main_path): confs/wresnet40x2_cifar.yaml
#: at full width, on the offline synthetic_shapes data (600 train images of
#: 32x32, 2,000 test), with the depth of a run cut by these flags and
#: overrides; the quality gate is off (a shallow oracle fails the "auto"
#: floor of 0.415 and phase 3 would have nothing to retrain), the audit at
#: its default floor of 0.95.  30 epochs: at 10 the fold models' identity
#: baselines (0.15 and 0.17 on an H100) stay under the audit's 2 x chance,
#: and the audit would score nothing
SEARCH_CONF = "confs/wresnet40x2_cifar.yaml"
SEARCH_EPOCHS = 30
SEARCH_FLAGS = ["--num-fold", "2", "--cv-ratio", "0.4", "--num-policy", "5", "--num-op", "2",
                "--num-search", "4", "--num-top", "2", "--num-result-per-cv", "1",
                "--until", "3", "--fold-quality-floor", "off"]
SEARCH_STAGES = ("search.phase1", "search.phase2", "search.audit", "search.phase3")


class _LogLines:
    """The search's log lines while a block runs."""

    def __enter__(self):
        import logging

        self.lines: list[str] = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.lines.append(record.getMessage())
        self.loggers = [logging.getLogger(n) for n in ("faa_torch.search",
                                                       "faa_torch.search_cli")]
        for lg in self.loggers:
            lg.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        for lg in self.loggers:
            lg.removeHandler(self.handler)

    def count(self, part: str) -> int:
        return sum(part in line for line in self.lines)


def _search_argv(save_dir: str, epochs: int, until: int = 3) -> list[str]:
    flags = list(SEARCH_FLAGS)
    flags[flags.index("--until") + 1] = str(until)
    return (["-c", os.path.join(REPO, SEARCH_CONF), "--save-dir", save_dir] + flags
            + ["dataset=synthetic_shapes", f"epoch={epochs}"])


def _search_expected_launches(epochs: int, audited: int, audit_folds: int) -> dict:
    """K1 and K5 launches of one search run at :data:`SEARCH_FLAGS` on
    ``synthetic_shapes`` (600 train images, 2,000 test; batch 128): phase 1
    trains 2 folds of 360 images (2 steps an epoch, K5 only) and evaluates
    every 5th and the last epoch (2 valid and 16 test batches); phase 2
    scores 2 x 4 trials over 2 padded batches; the audit scores the folds'
    identity baselines (2 x 2 batches), then `audited` sub-policies on the
    `audit_folds` folds that pass its floor (up to 4 through the TTA step,
    one per call; more in chunks of 8 through the audit step); phase 3
    trains 2 arms on 600 images (4 steps an epoch; the
    augmented arm through K1 too) with the test evaluations."""
    from fast_autoaugment_tpu_torch.ops import _kernels

    evals = len([e for e in range(1, epochs + 1) if e % 5 == 0 or e == epochs])
    folds, valid, test = 2, 2, 16
    phase1 = folds * (2 * epochs + evals * (valid + test))
    trials = folds * 4 * valid
    audit_calls = folds * valid + audit_folds * valid * (
        audited if audited <= 4 else -(-audited // 8))
    phase3_steps = 4 * epochs
    phase3_evals = evals * test
    per_call = _kernels.augment_plan(32, 32, 2).launches
    return {"augment": per_call * (trials + audit_calls + phase3_steps),
            "cifar_stack": phase1 + trials + audit_calls + 2 * (phase3_steps + phase3_evals),
            "imagenet_stack": 0}


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


def phase_search_main_path(dev, workdir: str, card: str, epochs: int = SEARCH_EPOCHS) -> dict:
    """The three-phase search through ``launch/search_cli.py main`` on the
    card (:data:`SEARCH_CONF`, :data:`SEARCH_FLAGS`), with the launch counts
    set to 0 just before and read just after; then the checks: all three
    phases ran, both phase-3 arms have a ``top1_test``, the final policy is
    not empty, no trial was quarantined, the audit scored sub-policies, the
    fold checkpoints load back through ``load_checkpoint_chain`` with their
    digests; two trials re-scored with the plain versions of K1 and K5 equal
    the kernels' bitwise; the same command again resumes (phase 1 trains
    nothing, phase 2 dispatches no trial); a profiled replay of phase 2 from
    the fold checkpoints gives the device's idle share over phase 2."""
    import hashlib
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.core.checkpoint import load_checkpoint_chain, read_metadata
    from fast_autoaugment_tpu_torch.core.config import load_config
    from fast_autoaugment_tpu_torch.launch import search_cli
    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.policies.archive import policy_decoder
    from fast_autoaugment_tpu_torch.search import driver, tta

    save = os.path.join(workdir, "search")
    argv = _search_argv(save, epochs)
    conf = load_config(argv[1], overrides=[a for a in argv[2:] if "=" in a])
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _LogLines() as log:
        result = search_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernels.launch_counts()

    # ---- what the run produced
    folds = [0, 1]
    trials = _read_json(os.path.join(save, "search_trials.json"))
    final = _read_json(os.path.join(save, "final_policy.json"))
    audit = _read_json(os.path.join(save, "audit.json"))
    p3 = result.get("phase3", {})
    problems = []
    if log.count("phase1: training fold") != len(folds):
        problems.append(f"phase 1 trained {log.count('phase1: training fold')} folds, not 2")
    if sorted(trials) != ["0", "1"] or any(len(t) != 4 for t in trials.values()):
        problems.append(f"phase 2 trial log is not 2 folds x 4 trials: {trials}")
    if result.get("num_quarantined_trials"):
        problems.append(f"quarantined trials: {result['quarantined_trials']}")
    if not final:
        problems.append("final_policy.json is empty")
    if not audit.get("audit_folds") or not audit.get("scores"):
        problems.append(f"the audit scored nothing (fold baselines {audit.get('fold_baselines')})")
    for arm in ("default", "augment"):
        vals = p3.get(arm, {}).get("per_seed", [])
        if len(vals) != 1 or not 0.0 <= vals[0] <= 1.0:
            problems.append(f"phase-3 {arm} arm has no top1_test: {p3}")
    want = _search_expected_launches(epochs, len(audit.get("scores", [])),
                                     len(audit.get("audit_folds", [])))
    if counts != want:
        problems.append(f"search launch counts {counts} != {want}")
    ckpts = {}
    for f in folds:
        path = driver._fold_ckpt_path(save, conf, f, 0.4)
        got = load_checkpoint_chain(path)
        with open(path, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()
        meta = read_metadata(path)
        ok = got is not None and got[2] == path and digest == meta["digest"] == got[1]["digest"]
        ckpts[f] = {"epoch": meta["epoch"], "step": meta["step"], "digest_ok": ok,
                    "nbytes": meta["nbytes"], "metrics": meta["metrics"]}
        if not ok or meta["epoch"] != epochs:
            problems.append(f"fold {f} checkpoint does not load back intact: {ckpts[f]}")
    if problems:
        fail("search_main_path: " + "; ".join(problems))

    # ---- two trials re-scored: through the driver's own entry
    # (``_FoldEval.evaluate``, the search's settings), which must give the
    # trial log's reward; then with the kernels and with the plain versions
    # of K1 and K5 under deterministic cuDNN, which must agree bitwise
    ev = driver._FoldEval(conf, "", num_policy=5, num_op=2, cv_ratio=0.4, device=dev)
    cutout = int(conf["cutout"])
    rescored = []
    for f, t in ((0, 0), (1, 3)):
        path = driver._fold_ckpt_path(save, conf, f, 0.4)
        proposal, reward = trials[str(f)][t][:2]
        pol = ev.policy_tensor(policy_decoder(proposal, 5, 2))
        key = ev.draw_source.fold_in(tta.prng_key(77 * 0 + f), t, dev)
        rescored.append({"fold": f, "trial": t, "trial_log_reward": reward,
                         "driver": ev.evaluate(f, path, pol, key), "pol": pol, "key": key})
        if rescored[-1]["driver"]["top1_valid"] != reward:
            fail(f"search trial re-scored through _FoldEval.evaluate differs from the trial "
                 f"log: {rescored[-1]}")
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for r in rescored:
            f, pol, key = r["fold"], r.pop("pol"), r.pop("key")
            ev.load_fold(driver._fold_ckpt_path(save, conf, f, 0.4))
            keep = (0, len(ev.batches(f)) - 1)
            fns = {"kernel": _Capture(tta.cifar_augment_fn(cutout), keep),
                   "plain": _Capture(_plain_augment(cutout), keep)}
            res = {k: tta.eval_tta(tta.make_tta_step(ev.model, num_policy=5, cutout_length=cutout,
                                                     augment_fn=fn), ev.batches(f), pol, key)
                   for k, fn in fns.items()}
            lanes = sum(int((fns["kernel"].out[i] != fns["plain"].out[i]).sum()) for i in keep)
            r.update({"kernel": res["kernel"], "plain": res["plain"],
                      "lane_elements_differing": lanes,
                      "deterministic_equal_to_trial_log":
                      res["kernel"]["top1_valid"] == r["trial_log_reward"]})
            if lanes or any(res["kernel"][k] != res["plain"][k] for k in TTA_FIELDS):
                fail(f"search trial re-scored with plain K1/K5 differs: {r}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev

    # ---- the same command again resumes
    with open(os.path.join(save, "search_trials.json"), "rb") as fh:
        trial_bytes = fh.read()
    t0 = time.perf_counter()
    with _LogLines() as relog:
        again = search_cli.main(argv)
    resume_s = time.perf_counter() - t0
    with open(os.path.join(save, "search_trials.json"), "rb") as fh:
        trials_unchanged = fh.read() == trial_bytes
    resume = {"trained": relog.count("phase1: training fold"),
              "already_trained": relog.count("already trained")
              + relog.count("already searched"),
              "trials_already_complete": relog.count("trials already complete"),
              "trial_log_unchanged": trials_unchanged, "seconds": resume_s,
              "final_policy_equal": again["final_policy_set"] == result["final_policy_set"]}
    if resume["trained"] or resume["already_trained"] != 2 or \
            resume["trials_already_complete"] != 2 or not trials_unchanged:
        fail(f"search resume trained or dispatched again: {resume}")

    # ---- the device's idle share over phase 2 (trials and audit): a
    # profiled replay of phases 1-2 from copies of the fold checkpoints
    replay = os.path.join(workdir, "search_replay")
    os.makedirs(replay)
    for name in os.listdir(save):
        if name.startswith(conf["model"]["type"]):
            shutil.copy(os.path.join(save, name), replay)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rep = search_cli.main(_search_argv(replay, epochs, until=2))
        torch.cuda.synchronize()
    t_post = time.perf_counter()
    by_range = _stage_device_us(prof, SEARCH_STAGES)
    busy_us = by_range["search.phase2"] + by_range["search.audit"]
    rep_wall = rep["device_secs_phase2"] + rep.get("device_secs_audit", 0.0)
    main_wall = result["device_secs_phase2"] + result.get("device_secs_audit", 0.0)
    idle_by_range = {name: 1 - by_range[f"search.{name}"] / 1e6 / rep[f"device_secs_{name}"]
                     for name in ("phase2", "audit")
                     if by_range[f"search.{name}"] and rep.get(f"device_secs_{name}")}
    n_trials = sum(len(t) for t in trials.values())
    phase3_s = result["device_hours_total"] * 3600 - result["elapsed_total"]
    out = {"phase": "search_main_path", "card": card, "conf": SEARCH_CONF,
           "model": conf["model"]["type"], "dataset": conf["dataset"], "epochs": epochs,
           "flags": SEARCH_FLAGS, "wall_s": wall, "launches": counts,
           "phase1_seconds_per_fold": result["device_secs_phase1_per_fold"],
           "phase2_seconds_per_trial": result["device_secs_phase2"] / n_trials,
           "audit_seconds": result.get("device_secs_audit"),
           "phase3_seconds_per_run": phase3_s / 2,
           "phase2_device_idle_share": 1 - busy_us / 1e6 / rep_wall if busy_us else None,
           "phase2_device_idle_share_at_unprofiled_wall":
           1 - busy_us / 1e6 / main_wall if busy_us else None,
           "phase2_device_busy_s": busy_us / 1e6, "phase2_wall_s": rep_wall,
           "phase2_unprofiled_wall_s": main_wall,
           "device_idle_share_by_range": idle_by_range,
           "device_busy_s_by_range": {k: v / 1e6 for k, v in by_range.items()},
           "expected_launches": want,
           "replay_trial_log_equal": _read_json(os.path.join(replay, "search_trials.json"))
           == trials, "profile_postprocess_s": time.perf_counter() - t_post,
           "fold_checkpoints": ckpts, "fold_baselines": audit.get("fold_baselines"),
           "audit": {"folds": audit["audit_folds"], "scored": len(audit["scores"]),
                     "dropped": len(audit["dropped"])},
           "final_policy": final, "phase3": p3, "rescored_trials": rescored,
           "resume": resume,
           "timing": "host clock, synchronized at the ends; phase-1 seconds per fold and "
                     "phase-2 seconds are the driver's device_secs_* (wall x 1 device); "
                     "phase-3 seconds per run = (device_hours_total x 3600 - the driver's "
                     "elapsed_total) / 2 runs; idle share = 1 - the device time under the "
                     "search.phase2 and search.audit ranges of a profiled replay of phase 2 / "
                     "the replay's own wall of those ranges (the profiler inflates it); "
                     "_at_unprofiled_wall: the same device time over the first, unprofiled, "
                     "run's phase-2 wall"}
    emit(out)
    return out


# ------------------------------------------------------------ train path

TRAIN_STAGES = ("train.sampler", "train.augment", "train.model", "train.optimizer")
TRAIN_STEPS = 10
TIMED_STEPS = 20
TRACE_STEPS = 3
#: K6's kernels (csrc/imagenet.cu): the cluster path and the two-pass path
K6_KERNELS = ("imagenet_cluster_kernel", "grey_sum_kernel", "imagenet_stack_kernel")
#: K6's check shapes: the train shape, odd sizes, bands of unequal height,
#: and images too large for clusters of 16 blocks (the two-pass path) in
#: both dtypes
K6_SHAPES = ((128, 224, 224), (4, 17, 23), (3, 225, 223), (2, 1100, 300), (2, 4200, 300))


def _imagenet_k6_draws(g, b, h, w, dev):
    """Draws for ``b`` images: every (jitter order, flip) pair in turn,
    cutout centres at the corners, then at random."""
    import torch

    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    d = PhiloxDraws().imagenet_draws(torch.tensor([11, int(g.integers(0, 2**31))]), batch=b,
                                     policy_shape=None, height=h, width=w, dispatch="exact",
                                     groups=8, device=dev)
    i = torch.arange(b, dtype=torch.int32, device=dev)
    d.order, d.flip = (i % 6).contiguous(), ((i // 6) % 2).contiguous()
    corners = torch.tensor([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1]], dtype=torch.int32,
                           device=dev)
    d.centre[: min(4, b)] = corners[: min(4, b)]
    return d


def _k6_args(d) -> dict:
    """The arguments of ``_kernels.imagenet_stack`` after the images, for
    draws `d`, as ``preprocess_imagenet.imagenet_stack`` passes them."""
    import torch

    from fast_autoaugment_tpu_torch.ops import preprocess as pre
    from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as pi

    mean, rstd = (v.tolist() for v in pi.norm_constants(pi.IMAGENET_MEAN, pi.IMAGENET_STD))
    return {"ints": torch.stack([d.flip, d.order, d.centre[:, 0], d.centre[:, 1]],
                                dim=-1).contiguous(),
            "floats": torch.cat([d.factors, pi.lighting_rgb(d.alpha)], dim=-1).contiguous(),
            "scale": pre._SCALE, "mean": mean, "rstd": rstd}


def _k6_clusters(h: int, w: int, dtype) -> list[int]:
    """The cluster sizes whose block fits at this shape and dtype."""
    from fast_autoaugment_tpu_torch.ops import _kernels

    out = []
    for c in _kernels.IMAGENET_CLUSTERS:
        try:
            _kernels.imagenet_plan(h, w, dtype, c)
        except ValueError:  # does not fit
            continue
        out.append(c)
    return out


def phase_k6_vs_plain(dev) -> dict:
    """The ImageNet stack kernels against their plain version on the card:
    the six jitter orders x both flip bits x cutout 0 and 16, uint8,
    float32 and non-integral float32 inputs (partly outside [0, 255]), at
    every shape of :data:`K6_SHAPES` (the last two on the two-pass path, in
    float32 and in uint8), 128x224x224 also at every cluster size that fits;
    launches per call against ``ops/_kernels.py imagenet_plan``; and the
    stack's draws on the card against the CPU."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as pi
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    g = np.random.default_rng(6)
    report = {"phase": "k6_vs_plain", "tolerance": "bitwise: 0 differing elements",
              "cases": {}, "paths": {}, "differing_elements": 0, "max_abs_err": 0.0}

    def compare(tag, got, want, launches, plan):
        torch.cuda.synchronize()
        b, h, w = want.shape[0], want.shape[2], want.shape[3]
        if got.shape != (b, 3, h, w) or not got.is_contiguous(
                memory_format=torch.channels_last) or not bool(torch.isfinite(got).all()):
            fail(f"k6 {tag}: shape, layout or finiteness is wrong")
        if launches != plan.launches:
            fail(f"k6 {tag}: {launches} launches in one call, the plan says {plan.launches}")
        diff = (got - want).abs()
        report["cases"][tag] = int((diff > 0).sum())
        report["paths"][tag] = f"{plan.path}/{plan.cluster}"
        report["differing_elements"] += report["cases"][tag]
        report["max_abs_err"] = max(report["max_abs_err"], float(diff.max()))

    for b, h, w in K6_SHAPES:
        u8 = torch.from_numpy(g.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
        inputs = {"uint8": u8, "float32": u8.to(torch.float32),
                  "float32_off_integers": torch.from_numpy(
                      g.uniform(-40.0, 300.0, (b, h, w, 3)).astype(np.float32)).to(dev)}
        if h == 4200:  # the uint8 two-pass shape: float32 would take it too, at 4x the bytes
            inputs = {"uint8": u8}
        for length in (0, 16):
            d = _imagenet_k6_draws(g, b, h, w, dev)
            for name, imgs in inputs.items():
                plan = _kernels.imagenet_plan(h, w, imgs.dtype)
                before = _kernels.launch_counts()["imagenet_stack"]
                got = pi.imagenet_stack(imgs, d, cutout_length=length)
                launches = _kernels.launch_counts()["imagenet_stack"] - before
                want = pi.imagenet_stack_plain(imgs, d, cutout_length=length)
                compare(f"{b}x{h}x{w}_cutout{length}_{name}", got, want, launches, plan)
            if h != 224:
                continue
            args = _k6_args(d)
            for name, imgs in inputs.items():
                for c in _k6_clusters(h, w, imgs.dtype):
                    plan = _kernels.imagenet_plan(h, w, imgs.dtype, c)
                    before = _kernels.launch_counts()["imagenet_stack"]
                    got = _kernels.imagenet_stack(imgs, **args, cutout_length=length, cluster=c)
                    launches = _kernels.launch_counts()["imagenet_stack"] - before
                    want = pi.imagenet_stack_plain(imgs, d, cutout_length=length)
                    compare(f"{b}x{h}x{w}_cutout{length}_{name}_cluster{c}", got, want,
                            launches, plan)
    src, same = PhiloxDraws(), []
    for dispatch in ("exact", "grouped"):
        d = {where: src.imagenet_draws(torch.tensor([5, 1]), batch=128, policy_shape=(498, 2),
                                       height=224, width=224, dispatch=dispatch, groups=8,
                                       device=device)
             for where, device in (("card", dev), ("cpu", torch.device("cpu")))}
        same += [torch.equal(getattr(d["card"], f).cpu(), getattr(d["cpu"], f))
                 for f in ("sub_idx", "policy", "flip", "order", "factors", "alpha", "centre")]
    report["draws_bitwise_cuda_vs_cpu"] = all(same)
    emit(report)
    if report["differing_elements"] or not report["draws_bitwise_cuda_vs_cpu"]:
        fail("the ImageNet stack kernel and its plain version, or the draws, disagree")
    return report


def resnet50_setup(dev, n_batches: int = 4) -> dict:
    """ResNet-50 (1000 classes) with seeded weights, the resnet50.yaml
    optimizer and schedule over the real run's steps per epoch, the
    fa_resnet50_rimagenet policy, and seeded uint8 224x224 batches on the
    card (standing in for host-cropped images)."""
    import torch

    from fast_autoaugment_tpu_torch.models import get_model, input_image_size, num_class
    from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
    from fast_autoaugment_tpu_torch.ops.schedules import build_schedule
    from fast_autoaugment_tpu_torch.train import steps
    from fast_autoaugment_tpu_torch.train.trainer import resolve_policy_tensor

    c = RESNET50
    classes = num_class(c["dataset"])
    image = input_image_size(c["dataset"], c["model"]["type"])
    model = get_model(dict(c["model"], dataset=c["dataset"]), classes, device=dev, seed=0)
    steps_per_epoch = IMAGENET_TRAIN_IMAGES // c["batch"]
    optimizer = build_optimizer(c["optimizer"], build_schedule(c, steps_per_epoch))
    state = steps.create_train_state(model, optimizer, use_ema=False)
    policy = torch.from_numpy(resolve_policy_tensor(c["aug"])).to(dev)
    g = np.random.default_rng(8)
    batches = [(torch.from_numpy(g.integers(0, 256, (c["batch"], image, image, 3),
                                            dtype=np.uint8)).to(dev),
                torch.from_numpy(g.integers(0, classes, (c["batch"],))).to(dev))
               for _ in range(n_batches)]
    make = lambda dispatch, fn=None: steps.make_train_step(  # noqa: E731
        model, optimizer, num_classes=classes, cutout_length=c["cutout"],
        augment_fn=fn or steps.imagenet_augment_fn(c["cutout"], True, dispatch, 8))
    return {"model": model, "optimizer": optimizer, "state": state, "policy": policy,
            "batches": batches, "classes": classes, "image": image, "make": make,
            "steps_per_epoch": steps_per_epoch}


def _plain_imagenet_augment(cutout, use_policy=True):
    """The ImageNet train stack with the plain versions of K1 and K6 (of K6
    alone, on the uint8 batch, without a policy)."""
    import torch

    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as pi

    def fn(images, policy, key, src):
        b, h, w = (int(v) for v in images.shape[:3])
        d = src.imagenet_draws(key, batch=b,
                               policy_shape=tuple(policy.shape[:2]) if use_policy else None,
                               height=h, width=w, dispatch="exact", groups=8,
                               device=images.device)
        x = images
        if use_policy:
            x = aug.apply_subpolicy_draws_plain(images.to(torch.float32), policy, d.sub_idx,
                                                d.policy)
        return pi.imagenet_stack_plain(x, d, cutout_length=cutout)
    return fn


class _CaptureAugment:
    def __init__(self, fn):
        self.fn, self.out = fn, []

    def __call__(self, images, policy, key, src):
        x = self.fn(images, policy, key, src)
        self.out.append(x.detach().clone())
        return x


def _copy_state(state):
    """A separate copy of a train state: its own model and optimizer state."""
    import copy

    from fast_autoaugment_tpu_torch.train import steps

    model = copy.deepcopy(state.model)
    opt_state = copy.deepcopy(state.opt_state)
    return steps.TrainState(step=state.step, model=model, opt_state=opt_state, ema=None)


def _batchnorm_rule_error(dev) -> float:
    """The port's train-mode BatchNorm on the card, on a seeded [128, 64,
    56, 56] channels_last batch (ResNet-50's first stage) from running
    statistics (0, 1): the largest relative error of its running mean and
    variance against the flax rule ``0.9 * running + 0.1 * batch``, with
    the biased batch variance taken in float64."""
    import torch

    from fast_autoaugment_tpu_torch.models.layers import BatchNorm

    g = torch.Generator(device="cpu").manual_seed(11)
    x = (torch.randn(128, 64, 56, 56, generator=g) * 1.7 + 0.4).to(dev)
    x = x.contiguous(memory_format=torch.channels_last)
    bn = BatchNorm(64).to(dev).train()
    bn(x)
    var, mean = torch.var_mean(x.double(), dim=(0, 2, 3), unbiased=False)
    errs = [((bn.running_mean.double() - 0.1 * mean).abs() / (0.1 * mean).abs()).max(),
            ((bn.running_var.double() - (0.9 + 0.1 * var)).abs() / (0.9 + 0.1 * var)).max()]
    return float(max(errs))


def phase_train_main_path(dev, st: dict) -> dict:
    """ResNet-50 train steps through make_train_step with the ImageNet stack
    (K1, then K6 on K1's float32 output) as its augment_fn, wired as
    train_and_eval wires it, and one step without a policy (the uint8 batch
    straight into K6, as phase 1 trains); the launch counts set to 0 just
    before and read just after; then a step with the kernels against one
    with the plain versions, with and without a policy."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.train import steps

    c = RESNET50
    num_op = int(st["policy"].shape[1])
    step = st["make"]("exact")
    step_g = st["make"]("grouped")
    step_u8 = st["make"]("exact", steps.imagenet_augment_fn(c["cutout"], False))
    key = torch.tensor([0, 0], device=dev)
    losses = []
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        x, y = st["batches"][i % len(st["batches"])]
        st["state"], m = step(st["state"], x, y, st["policy"], key)
        losses.append(m["loss"] / m["num"])
    x, y = st["batches"][0]
    st["state"], mg = step_g(st["state"], x, y, st["policy"], key)
    st["state"], mu = step_u8(st["state"], x, y, st["policy"], key)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    losses = [float(v) for v in losses]
    calls = TRAIN_STEPS + 1
    per_call = _kernels.augment_plan(st["image"], st["image"], num_op).launches
    k6_f32 = _kernels.imagenet_plan(st["image"], st["image"], torch.float32).launches
    k6_u8 = _kernels.imagenet_plan(st["image"], st["image"], torch.uint8).launches
    want = {"augment": per_call * calls, "cifar_stack": 0,
            "imagenet_stack": k6_f32 * calls + k6_u8}
    if counts != want:
        fail(f"train launch counts {counts} != {want} ({calls} steps with a policy, 1 without)")
    grouped_loss = float(mg["loss"] / mg["num"])
    u8_loss = float(mu["loss"] / mu["num"])
    if not all(np.isfinite(losses + [grouped_loss, u8_loss])):
        fail(f"a train step's loss is not finite: {losses} {grouped_loss} {u8_loss}")

    # one step with the kernels against one with the plain versions, from
    # the same state, batch and key, under deterministic cuDNN: with the
    # policy (K1, then K6 on float32) and without (K6 on uint8)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    checks = {}
    try:
        for policy in (True, False):
            runs = {}
            for name, fn in (("kernel", steps.imagenet_augment_fn(c["cutout"], policy, "exact",
                                                                  8)),
                             ("plain", _plain_imagenet_augment(c["cutout"], policy))):
                state = _copy_state(st["state"])
                cap = _CaptureAugment(fn)
                make = steps.make_train_step(state.model, st["optimizer"],
                                             num_classes=st["classes"],
                                             cutout_length=c["cutout"], augment_fn=cap)
                state, m = make(state, x, y, st["policy"], key)
                torch.cuda.synchronize()
                runs[name] = (cap.out[0], float(m["loss"]), state.model.state_dict())
            (xk, lk, sk), (xp, lp, sp) = runs["kernel"], runs["plain"]
            checks["with_policy" if policy else "without_policy"] = {
                "augmented_elements_differing": int((xk != xp).sum()),
                "augmented_max_abs_err": float((xk - xp).abs().max()),
                "loss_kernel": lk, "loss_plain": lp, "state_tensors": len(sk),
                "state_tensors_differing": sorted(k for k in sk if not torch.equal(sk[k], sp[k]))}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    bn_err = _batchnorm_rule_error(dev)
    out = {"phase": "train_main_path", "model": c["model"]["type"], "dataset": c["dataset"],
           "batch": c["batch"], "image": st["image"], "classes": st["classes"],
           "policy": c["aug"], "num_sub": int(st["policy"].shape[0]), "num_op": num_op,
           "steps_per_epoch": st["steps_per_epoch"], "steps": TRAIN_STEPS,
           "grouped_steps": 1, "steps_without_policy": 1, "losses": losses,
           "grouped_loss": grouped_loss, "loss_without_policy": u8_loss,
           "main_path_wall_s": wall, "launches": counts, "expected_launches": want,
           "launches_per_step": {"augment": per_call, "imagenet_stack": k6_f32,
                                 "imagenet_stack_without_policy": k6_u8},
           "plain_vs_kernel": checks,
           "batchnorm_running_stats_rel_err": bn_err, "batchnorm_running_stats_tol": 1e-5}
    emit(out)
    for r in checks.values():
        if r["augmented_elements_differing"] or r["loss_kernel"] != r["loss_plain"] \
                or r["state_tensors_differing"]:
            fail("the train step with the kernels differs from the step with the plain versions")
    if bn_err > 1e-5:
        fail(f"BatchNorm's running statistics on the card miss the flax rule by {bn_err}")
    return out


def phase_train_flagship(dev) -> dict:
    """train_and_eval with the flagship WRN-40-2 config on ``synthetic``
    (512 train and 256 test images of 32x32): 2 epochs of 4 steps, evaluation
    every epoch, launch counts set to 0 just before and read just after."""
    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.train.trainer import train_and_eval

    c = FLAGSHIP
    conf = {"model": {"type": c["model"], "precision": c["precision"]}, "dataset": "synthetic",
            "aug": c["aug"], "cutout": c["cutout"], "batch": c["batch"], "epoch": 2,
            "lr": c["lr"], "lr_schedule": c["lr_schedule"], "optimizer": c["optimizer"]}
    _kernels.reset_launch_counts()
    result = train_and_eval(conf, "", evaluation_interval=1, device=dev)
    counts = _kernels.launch_counts()
    steps, evals = 2 * (512 // c["batch"]), 2 * -(-256 // c["batch"])
    want = {"augment": _kernels.augment_plan(32, 32, c["num_op"]).launches * steps,
            "cifar_stack": steps + evals,
            "imagenet_stack": 0}
    keys = {"epoch", "loss_train", "top1_train", "top5_train", "loss_test", "top1_test",
            "top5_test", "num_test", "best_valid_top1", "best_test_top1", "elapsed_sec"}
    out = {"phase": "train_flagship", "conf": conf, "result": result, "launches": counts,
           "expected_launches": want, "train_steps": steps, "eval_batches": evals}
    emit(out)
    if set(result) != keys or not all(np.isfinite(list(result.values()))):
        fail(f"train_and_eval result is malformed: {sorted(result)}")
    if counts != want or result["epoch"] != 2 or result["num_test"] != 256:
        fail(f"train_and_eval launch counts {counts} != {want}, or epochs/counts wrong")
    return out


def phase_train_times(dev, st: dict, card: str) -> dict:
    """The ResNet-50 step: median ms per step and images/s, a profiler
    trace split by stage, K1 and K6 at 128x224x224 against their bounds,
    and the peak device memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as pi
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    c = RESNET50
    b, image = c["batch"], st["image"]
    step = st["make"]("exact")
    key = torch.tensor([1, 0], device=dev)
    for i in range(3):
        st["state"], _ = step(st["state"], *st["batches"][i % 4], st["policy"], key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        st["state"], _ = step(st["state"], *st["batches"][i % 4], st["policy"], key)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(TRACE_STEPS):
            st["state"], _ = step(st["state"], *st["batches"][i % 4], st["policy"], key)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # kernel rows only: the stage ranges show up as device rows of their own
    by_name = {k: v for k, v in kernel_device_us(prof).items() if not k.startswith("train.")}
    busy_us = sum(by_name.values())
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in by_name and device_us_of(e) > 0)
    # K1 and K6 run a known number of times: the profile's rows of them
    # show whether it lost kernel records (then busy time is a floor)
    plan = _kernels.augment_plan(image, image, int(st["policy"].shape[1]))
    plan6 = _kernels.imagenet_plan(image, image, torch.float32)  # K6 reads K1's output
    rows_seen = kernel_counts(prof, (plan.kernel,) + plan6.kernel)
    rows_want = {plan.kernel: plan.launches * TRACE_STEPS,
                 **{k: TRACE_STEPS for k in plan6.kernel}}
    # a range's device time counts the PyTorch operators launched inside it:
    # not the kernels launched through ctypes (K1, K6), and not the backward,
    # which autograd runs on a thread of its own; so the model's share is
    # what remains of the busy time
    stages = _stage_device_us(prof, TRAIN_STAGES)
    k1_us, k6_us = device_us(prof, K1_KERNELS), device_us(prof, K6_KERNELS)
    conv_us = sum(v for k, v in by_name.items()
                  if "conv" in k.lower() or "fprop" in k or "dgrad" in k or "wgrad" in k)
    flop = 3 * model_flops(st["model"], dev, size=image) * b  # forward + 2 backward
    n = TRACE_STEPS
    split = {"sampler": stages["train.sampler"], "augment_kernel_K1": k1_us,
             "imagenet_stack_kernel_K6": k6_us, "augment_other": stages["train.augment"],
             "optimizer_and_metrics": stages["train.optimizer"]}
    split["model_forward_backward"] = busy_us - sum(split.values())
    split = {k: v / 1e3 / n for k, v in split.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # K1 and K6 at the step's shape, with the step's draws
    x, _ = st["batches"][0]
    pol = st["policy"]
    d = PhiloxDraws().imagenet_draws(torch.tensor([0, 5], device=dev), batch=b,
                                     policy_shape=tuple(pol.shape[:2]), height=image,
                                     width=image, dispatch="exact", groups=8, device=dev)
    xf = x.to(torch.float32).contiguous()
    rec = aug.slot_records(pol, d.sub_idx, d.policy, image, image)
    y1 = _kernels.augment(xf, rec)
    elems = xf.numel()
    k1 = {"kernel": "augment", "shape": list(xf.shape), "num_op": int(pol.shape[1]),
          "launches_per_call": plan.launches, "cluster": plan.cluster,
          "kernel_ms": kernel_device_ms(lambda: _kernels.augment(xf, rec), kernel=plan.kernel,
                                        per_call=plan.launches),
          "kernel_event_ms": cuda_ms(lambda: _kernels.augment(xf, rec)),
          "kernel_graph_ms": graph_ms(lambda: _kernels.augment(xf, rec)),
          "by_op_graph_ms": k1_op_sweep(xf),
          # both cluster sizes that fit at 224x224, timed alike, and how many
          # clusters of each the card holds at once
          "by_cluster": {str(c): {
              "kernel_ms": kernel_device_ms(lambda c=c: _kernels.augment(xf, rec, cluster=c)),
              "kernel_event_ms": cuda_ms(lambda c=c: _kernels.augment(xf, rec, cluster=c)),
              "kernel_graph_ms": graph_ms(lambda c=c: _kernels.augment(xf, rec, cluster=c)),
              "smem_bytes": _kernels.augment_plan(image, image, 2, c).smem_bytes,
              "threads": _kernels.augment_plan(image, image, 2, c).threads,
              "max_active_clusters": _kernels.augment_max_active_clusters(
                  image, image, cluster=c, device=dev.index or 0)} for c in FORCED_CLUSTERS},
          "plain_ms": cuda_ms(lambda: aug.apply_subpolicy_draws_plain(xf, pol, d.sub_idx,
                                                                     d.policy),
                              iters=3, warmup=1),
          "bytes": 2 * elems * 4 + rec.numel() * 4}  # images in + out once, records in
    k6 = {}
    args = _k6_args(d)
    copy_out = torch.empty(xf.shape, dtype=torch.float32, device=dev)
    for name, inp in (("float32", y1), ("uint8", x)):
        plan6 = _kernels.imagenet_plan(image, image, inp.dtype)
        raw = lambda c=None: _kernels.imagenet_stack(  # noqa: E731  (the launch alone)
            inp, **args, cutout_length=0, cluster=c)
        k6[name] = {
            "kernel": "imagenet_stack", "input": name, "shape": list(inp.shape),
            "launches_per_call": plan6.launches, "cluster": plan6.cluster,
            "threads": plan6.threads, "smem_bytes": plan6.smem_bytes,
            "kernel_ms": kernel_device_ms(lambda: pi.imagenet_stack(inp, d), kernel=plan6.kernel),
            "kernel_event_ms": cuda_ms(raw, iters=50),
            "kernel_graph_ms": graph_ms(raw),
            "wrapper_event_ms": cuda_ms(lambda: pi.imagenet_stack(inp, d)),
            # every cluster size that fits, timed alike, and how many such
            # clusters the card holds at once
            "by_cluster": {str(c): {
                "kernel_graph_ms": graph_ms(lambda c=c: raw(c)),
                "smem_bytes": _kernels.imagenet_plan(image, image, inp.dtype, c).smem_bytes,
                "threads": _kernels.imagenet_plan(image, image, inp.dtype, c).threads,
                "max_active_clusters": _kernels.imagenet_max_active_clusters(
                    image, image, inp.dtype, cluster=c, device=dev.index or 0)}
                for c in _k6_clusters(image, image, inp.dtype)},
            "plain_ms": cuda_ms(lambda: pi.imagenet_stack_plain(inp, d), iters=5, warmup=1),
            # a yardstick, not the same function: PyTorch copying the same
            # bytes (the input into a float32 tensor of the output's size)
            "copy_graph_ms": graph_ms(lambda: copy_out.copy_(inp)),
            "bytes": elems * inp.element_size() + elems * 4 + b * (4 * 4 + 6 * 4),
            "ops": 20 * elems}
    for k in (k1, *k6.values()):
        bytes_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = k.get("ops", 0) / FP32_OPS_PER_S * 1e3
        k.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None)
    out = {"phase": "train_times", "card": card, "model": c["model"]["type"], "batch": b,
           "image": image, "median_step_ms": step_ms, "step_ms": [t * 1e3 for t in times],
           "images_per_s": b / step_ms * 1e3, "max_memory_allocated_bytes": peak,
           "k1": k1, "k6": k6,
           "trace": {"steps": n, "wall_ms_per_step": wall_s * 1e3 / n,
                     "device_busy_ms_per_step": busy_us / 1e3 / n,
                     "known_kernel_rows": rows_seen, "known_kernel_rows_expected": rows_want,
                     "kernel_launches_per_step": launches / n,
                     "device_idle_share": 1 - busy_us / 1e6 / wall_s if busy_us else None,
                     "device_idle_share_at_step_wall": (1 - busy_us / 1e3 / n / step_ms)
                     if busy_us else None,
                     "device_ms_per_step_by_stage": split,
                     "convolution_kernels_ms_per_step": conv_us / 1e3 / n,
                     "model_tflop_per_step": flop / 1e12,
                     "model_flop_bound_ms": flop / FP32_OPS_PER_S * 1e3,
                     "convolution_tflop_per_s": flop / (conv_us / n * 1e-6) / 1e12
                     if conv_us else None,
                     "stage_ranges_found": any(v > 0 for v in stages.values()),
                     "top_device_ms_per_step": {k[:90]: v / 1e3 / n for k, v in top}},
           "timing": "median_step_ms: host clock around each of 20 steps after 3 warm-up "
                     "steps, synchronized; kernel_ms: device time from torch.profiler over 20 "
                     "calls; kernel_graph_ms, by_op_graph_ms and by_cluster: CUDA-graph "
                     "replay, as is K6's copy_graph_ms (PyTorch copying the same bytes); "
                     "*_event_ms and plain_ms: CUDA events around back-to-back calls "
                     "(K6's kernel_event_ms: the launch alone, 50 calls); "
                     "the trace runs with the profiler on (host time inflated); "
                     "convolution TFLOP/s counts 3x the forward's convolution and dense "
                     "FLOPs against the convolution kernels' device time"}
    emit(out)
    return out


# ------------------------------------------------- paired kernel times

#: (name, batch, image) of the paired timings: K1 at the TTA, train and
#: serving shapes, K5 at the TTA shape, K6 at the train shape on float32
#: (after K1) and uint8 (no policy) input
PAIRED = (("k1_tta", 640, 32), ("k1_train", 128, 224), ("k1_serve", 128, 32),
          ("k5_tta", 640, 32), ("k6_train_f32", 128, 224), ("k6_train_u8", 128, 224))


def time_kernels_of(tree: str) -> dict:
    """Time K1, K5 and K6 of the port in checkout `tree` on seeded inputs,
    through the functions every slice of the port since the training slice
    has (``slot_records``, the samplers, ``_kernels.augment``,
    ``preprocess.cifar_stack``, ``PhiloxDraws().imagenet_draws``,
    ``_kernels.imagenet_stack``): device ms per call by CUDA-graph replay
    (median of 3), and launches per call from the launch counters."""
    sys.path.insert(0, tree)
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess as pre
    from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    dev = torch.device("cuda", 0)
    _kernels.load_libraries()
    out = {"tree": tree, "source": _kernels.SOURCES["augment"].as_posix()}
    for name, b, img in PAIRED:
        g = np.random.default_rng(b * img)
        x = _rand_images(g, b, img, img, dev)
        if name.startswith("k6"):
            x = x.to(torch.uint8) if name.endswith("u8") else x
            d = PhiloxDraws().imagenet_draws(torch.tensor([0, 5], device=dev), batch=b,
                                             policy_shape=None, height=img, width=img,
                                             dispatch="exact", groups=8, device=dev)
            # the wrapper of _kernels, its arguments made as imagenet_stack
            # makes them: the host-to-card copies of the constants cannot be
            # captured in a CUDA graph
            args = _k6_args(d)
            out[name] = {"shape": [b, img, img, 3], "dtype": str(x.dtype),
                         **_time_one(lambda: _kernels.imagenet_stack(x, **args, cutout_length=0),
                                     _kernels)}
            continue
        if name == "k1_train":
            pol = policy_to_tensor(load_policy("fa_resnet50_rimagenet"))
        elif name == "k1_serve":
            pol = policy_to_tensor(load_policy("fa_reduced_cifar10"))
        else:
            pol = _tta_policy(g, FLAGSHIP["num_policy"], FLAGSHIP["num_op"])
        pol = torch.from_numpy(pol).to(dev)
        keys = torch.from_numpy(g.integers(0, 2**31, (b, 2), dtype=np.int64)).to(dev)
        if name == "k1_serve":
            sub, draws = aug.sample_grouped(keys[0], b, 8, pol.shape[0], pol.shape[1], img, img)
        else:
            sub, draws = aug.sample_exact(keys, pol.shape[0], pol.shape[1], img, img)
        rec = aug.slot_records(pol, sub, draws, img, img)
        if name.startswith("k1"):
            fn = lambda: _kernels.augment(x, rec)  # noqa: E731
        else:
            y, crop = _kernels.augment(x, rec), aug.sample_crop(keys, img, img)
            fn = lambda: pre.cifar_stack(y, crop, cutout_length=FLAGSHIP["cutout"])  # noqa: E731
        out[name] = {"shape": [b, img, img, 3], "num_op": int(pol.shape[1]),
                     **_time_one(fn, _kernels)}
    return out


def _time_one(fn, kernels) -> dict:
    """Launches in one call of `fn` (from the counters) and its device ms
    by CUDA-graph replay, median of 3."""
    import torch

    before = sum(kernels.launch_counts().values())
    fn()
    torch.cuda.synchronize()
    launches = sum(kernels.launch_counts().values()) - before
    return {"launches_per_call": launches,
            "graph_ms": float(np.median([graph_ms(fn, replays=10) for _ in range(3)]))}


def paired_kernel_times(other: str) -> dict:
    """K1, K5 and K6 of checkout `other` against this checkout's, in one call
    on one card: four worker processes in turns (other, this, this, other),
    each timing its tree's kernels with :func:`time_kernels_of`."""
    trees = {"other": os.path.abspath(other), "this": REPO}
    runs = []
    for which in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-kernels-of",
                               trees[which]], capture_output=True, text=True, timeout=900,
                              cwd=trees[which])
        if proc.returncode != 0:
            fail(f"timing the kernels of {trees[which]} failed: {proc.stderr[-3000:]}")
        runs.append((which, json.loads(proc.stdout.strip().splitlines()[-1])))
        emit({"phase": "paired_run", "which": which, **runs[-1][1]})
    summary = {"phase": "paired_kernel_times", "card": nvidia_smi(), "trees": trees,
               "order": [w for w, _ in runs], "timing": "CUDA-graph replay, median of 3"}
    for name, _, _ in PAIRED:
        ms = {w: [r[name]["graph_ms"] for ww, r in runs if ww == w] for w in trees}
        summary[name] = {"other_ms": ms["other"], "this_ms": ms["this"],
                         "other_over_this": min(ms["other"]) / min(ms["this"]),
                         "launches_per_call": {w: next(r[name]["launches_per_call"]
                                                       for ww, r in runs if ww == w)
                                               for w in trees}}
    emit(summary)
    return summary


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this script runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--time-kernels-of"]:  # a worker of --pair-with: imports that tree
        print(json.dumps(time_kernels_of(sys.argv[2])), flush=True)
        return 0
    sys.path.insert(0, REPO)
    try:
        from fast_autoaugment_tpu_torch.ops import _kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--pair-with"]:
        paired_kernel_times(sys.argv[2])
        return 0
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    t0 = time.perf_counter()
    _kernels.load_libraries()
    emit({"phase": "environment", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "build_s": time.perf_counter() - t0, "nvcc_s": _kernels.build_seconds,
          "nvcc_flags": list(_kernels.NVCC_FLAGS)})
    check = phase_kernel_vs_plain(dev)
    check5 = phase_k5_vs_plain(dev)
    check6 = phase_k6_vs_plain(dev)
    lighting = phase_lighting_cpu_vs_card(dev)
    with tempfile.TemporaryDirectory() as workdir:
        main_path = phase_main_path(dev, workdir)
    st = tta_setup(dev)
    tta_path = phase_tta_main_path(dev, st)
    rows = phase_times(dev, card)
    phase_trace(dev, card)
    tta_t = phase_tta_times(dev, st, card)
    del st
    torch.cuda.empty_cache()
    rn = resnet50_setup(dev)
    train_path = phase_train_main_path(dev, rn)
    flagship = phase_train_flagship(dev)
    with tempfile.TemporaryDirectory() as workdir:
        search = phase_search_main_path(dev, workdir, card)
    train_t = phase_train_times(dev, rn, card)
    at = next(r for r in rows if r["batch"] == 128)  # the largest serving shape
    k1, k5 = tta_t["k1"], tta_t["k5"]
    k1_train, k6 = train_t["k1"], train_t["k6"]["float32"]
    timing_keys = ("shape", "kernel_ms", "kernel_graph_ms", "kernel_event_ms", "plain_ms",
                   "bound_ms", "bound_by")

    def ms(row):
        """A kernel's time and its source: the profiler's device time, else
        CUDA-graph replay, else CUDA events around back-to-back calls."""
        for key, source in (("kernel_ms", "device"), ("kernel_graph_ms", "graph"),
                            ("kernel_event_ms", "events")):
            if row.get(key) is not None:
                return {"ms": row[key], "ms_source": source}
        fail("a kernel has no time")

    print(card, flush=True)
    emit({"kernels": [{
        "name": "augment", "route": "cuda",
        "source": "fast_autoaugment_tpu_torch/csrc/augment.cu",
        "replaces": "fast_autoaugment_tpu/ops/augment.py:409",
        "launches": main_path["launches"] + tta_path["launches"]["augment"]
        + train_path["launches"]["augment"] + flagship["launches"]["augment"]
        + search["launches"]["augment"],
        "launches_by_path": {"serve": main_path["launches"],
                             "tta": tta_path["launches"]["augment"],
                             "train_resnet50": train_path["launches"]["augment"],
                             "train_and_eval_wrn40_2": flagship["launches"]["augment"],
                             "search_wrn40_2": search["launches"]["augment"]},
        "launches_per_call": {"serve_32": at["launches_per_call"],
                              "tta_32": k1["launches_per_call"],
                              "train_224": k1_train["launches_per_call"]},
        "max_abs_err": check["max_abs_err"],
        "differing_elements": check["differing_elements"],
        **ms(at),
        "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"], "library_ms": None,
        "shape": [at["batch"], at["image"], at["image"], 3],
        "at_tta_shape": {k: k1.get(k) for k in timing_keys},
        "at_train_shape": {k: k1_train.get(k) for k in timing_keys},
        "at_train_shape_by_cluster": k1_train["by_cluster"]}, {
        "name": "cifar_stack", "route": "cuda",
        "source": "fast_autoaugment_tpu_torch/csrc/preprocess.cu",
        "replaces": "fast_autoaugment_tpu/ops/preprocess.py:109",
        "launches": tta_path["launches"]["cifar_stack"] + flagship["launches"]["cifar_stack"]
        + search["launches"]["cifar_stack"],
        "launches_by_path": {"tta": tta_path["launches"]["cifar_stack"],
                             "train_and_eval_wrn40_2": flagship["launches"]["cifar_stack"],
                             "search_wrn40_2": search["launches"]["cifar_stack"]},
        "train_and_eval_launches_are": f"{flagship['train_steps']} train steps + "
                                       f"{flagship['eval_batches']} eval batches",
        "max_abs_err": check5["max_abs_err"],
        "differing_elements": check5["differing_elements"],
        **ms(k5),
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": None, "shape": k5["shape"]}, {
        "name": "imagenet_stack", "route": "cuda",
        "source": "fast_autoaugment_tpu_torch/csrc/imagenet.cu",
        "replaces": "fast_autoaugment_tpu/ops/preprocess_imagenet.py:191",
        "launches": train_path["launches"]["imagenet_stack"],
        "launches_by_path": {"train_resnet50": train_path["launches"]["imagenet_stack"]},
        "launches_per_call": {"train_224_float32": k6["launches_per_call"],
                              "train_224_uint8": train_t["k6"]["uint8"]["launches_per_call"]},
        "max_abs_err": check6["max_abs_err"],
        "differing_elements": check6["differing_elements"],
        "draws_bits_differing_cpu_vs_card": lighting["float_bits_differing"]
        + lighting["ints_differing"],
        **ms(k6),
        "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        "library_ms": None, "shape": k6["shape"], "input": k6["input"],
        "at_uint8_input": {k: train_t["k6"]["uint8"].get(k) for k in timing_keys}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
