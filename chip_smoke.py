#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --imagenet-only
    python3 chip_smoke.py --sampler-only
    python3 chip_smoke.py --fleet-only
    python3 chip_smoke.py --control-only
    python3 chip_smoke.py --gameday-only
    python3 chip_smoke.py --pair-with OTHER_CHECKOUT

Run from the root of a checkout; it needs one CUDA card and ``nvcc``.  With
``--pair-with`` it only times K1, K5 and K6 of the other checkout's port
against this one's (:func:`paired_kernel_times`).  Without arguments, the phases,
each printing one JSON line:

1. environment: the card (``nvidia-smi``), torch and CUDA versions, and the
   seconds it took to build the kernels (``fast_autoaugment_tpu_torch/csrc/
   augment.cu``, ``preprocess.cu``, ``imagenet.cu`` and ``sampler.cu``,
   one ``nvcc`` each, in parallel);
2. kernel vs plain version on the card, bitwise with the count of
   differing elements: the augmentation kernel (all 19 ops forced on with
   both mirror signs over a sweep of levels, then random draws under all
   six policy archives, at 128x32x32, 4x17x23, 128x224x224, 3x225x223 (bands
   of unequal height), 2x496x300 (clusters of 16 at one block per SM),
   2x520x300 (too large for a cluster: one launch per slot) and 8x8x8 (the
   game days' serving call); at 224x224
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
   (``lighting_cpu_vs_card``); the draw sampler (K7) and the train noise
   (K8) of ``csrc/sampler.cu`` against their plain versions on the card and
   against the CPU, bitwise, at the main path's shapes (``sampler_vs_plain``:
   exact draws at 1, 8, 32 and 128 lanes of 32x32 and 1 and 8 of 224x224,
   the grouped serving call at 128 with 8 groups, the game days' serving
   call of 8 images of 8x8 exact (a single-sub policy) and grouped, the TTA
   step's 5 draw keys x 128 lanes with 1-3 slots exact and grouped, the
   ImageNet train step's
   128 lanes at 224x224 exact and grouped, each zoo model's noise at its
   preset's batch, 4096 Beta(0.2) draws, permutations of 1, 64, 128 and
   4096, the key entry), one launch a call, with their times by CUDA-graph
   replay beside the plain versions' and their bounds
   (``--sampler-only`` runs these three checks alone);
3. the serving path: two ``serve_cli`` processes on the card (the shipped
   ``fa_reduced_cifar10`` archive at 32x32, grouped dispatch; one ImageNet
   sub-policy at 224x224, shapes 1,8, exact dispatch) answer npz, raw and
   concurrent requests; every answer is checked against the plain version
   applied on the card to the same draws; the kernel's launch count in
   ``/stats`` must equal dispatches x launches per call (1 on the cluster
   path) plus each shape's graph warm-up call; SIGTERM must drain to exit 0;
   then the serving plane (``serve_plane``): (a) every padded shape's CUDA
   graph replay against the eager dispatch, bitwise (``fa_reduced_cifar10``
   grouped at 32x32, shapes 1-128; one ImageNet sub-policy exact at
   224x224, shapes 1 and 8), K1's kernel records in traced stretches against
   the counters, the capture seconds, and at 128x32x32 ms per ``apply``
   call, host runtime calls per call and the idle share of the graph and
   the eager arm; the card-only tests ``tests/test_torch_serve_graphs.py``
   in a process of their own; (b) two replicas (``--donate --double-buffer
   --watchdog auto --telemetry --compile-cache --port-dir --heartbeat-dir
   --traffic-stats --breaker-threshold 3 --breaker-exit``, one with
   ``--tenant-capacity 2 --policy-dir``) behind ``router_cli``, which
   finds them in the port dir: a closed loop through the router and one
   straight to a replica; (c) a hot ``/reload`` mid-burst: no failed
   request, each answer's digest header names one of the two policies and
   its bytes equal the eager path's under that policy; (d) a tenant warmed
   with ``/tenants/warm`` and reached through the router by its digest;
   (e) ``/augment_batch`` frames and the shm lane equal ``/augment``
   bitwise; (f) ``FAA_FAULT=serve_error`` opens a replica's breaker (typed
   500s, then 503 or exit) and it exits 77, a replica SIGKILLed mid-burst
   is failed over with no lost request, ``/metrics`` carries the
   ``faa_serve_*`` families; (g) one autoscaler cycle (scale up from one
   ``serve_cli`` replica to two on the queue signal, then down).
   ``--serve-only`` runs phase 3 alone;
4. the TTA policy-scoring path (``tta_main_path``): WRN-40-2 from the
   flagship config (:data:`FLAGSHIP`) with seeded weights, a seeded 20,000
   image uint8 fold uploaded once (157 batches of 128, the last with 32
   real images), then ``eval_tta`` of a 5-sub-policy candidate, the
   identity baseline, ``eval_tta_batched`` of 4 candidates, one audit step
   and ``eval_tta`` under grouped dispatch; the launch counts must be
   1 augmentation launch and 1 CIFAR stack launch per step call; then
   the same steps with the plain versions of both kernels on the card
   (augmented lanes bitwise, fields equal under
   ``cudnn.deterministic``) and the first and last batched candidates
   against ``eval_tta`` of that candidate alone;
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
   evaluation every epoch; the default device cache, a CUDA-graph replay a
   step) and checks its result dict and launch counts, then resumes it from
   an imported checkpoint (the reference importer's ``imported_from``
   record, written on the card: only the last epoch trains, the step at the
   resume epoch, the EMA seeded from the imported weights, the launches
   predicted);
7. the search (``search_main_path``): ``launch/search_cli.py main`` with
   ``confs/wresnet40x2_cifar.yaml`` at full width (WRN-40-2) on the offline
   ``synthetic_shapes`` data, cut in depth (:data:`SEARCH_FLAGS`,
   :data:`SEARCH_EPOCHS`): phase 1 trains 2 fold models, phase 2 runs 4 TPE
   trials per fold and the audit, phase 3 retrains the default and the
   augmented arm; the fold checkpoints load back with their digests; two
   trials re-scored with the plain versions of K1 and K5 equal the kernels'
   bitwise; the same command again trains and dispatches nothing; the same
   search with ``--device-cache off --host-step eager`` (the eager host
   feed) gives the same trial log, policy,
   audit, checkpoint digests and phase-3 values (both arms under
   deterministic cuDNN); seconds per fold, per trial and per run and the
   device's idle share over phase 2, from a profiled replay whose K1 and K5
   kernel records must match the launch counters;
8. ``train_times``: K1 and K6 at 128x224x224 against their bounds and
   plain versions, also by CUDA-graph replay (K1 also with clusters of 8
   and of 16 blocks, K6 at every cluster size that fits, on float32 and
   uint8 input, and how many such clusters the card holds at once); then
   the ImageNet data path (``imagenet_main_path``, ``--imagenet-only`` runs
   it alone): a JPEG listing written here (1,280 train and 256 val images
   in 10 ``<wnid>`` folders, sides 256-512 px, smooth seeded content, the
   Kaggle ``train_cls.txt``/``val_cls.txt``), K1, K6 and K5 against their
   plain versions on its first decoded batch, ``train_and_eval`` of
   ``confs/resnet50.yaml`` on it (1 epoch of 10 steps at 128x224x224, then
   the val set) twice, the host-fed step replayed as a CUDA graph and run
   eagerly (equal results and checkpoint bytes; the native decoder by name,
   0 decode failures, the launches the plans predict, kernel records
   against the counters; ms per step, decode rate, runtime calls per step,
   idle share, peak memory), and ``search_cli`` on it (1 fold, 1 phase-1
   epoch, 2 trials, phases 1-2: the lazy fold stream into the graphed TTA
   and audit steps);
9. the model zoo (:data:`ZOO`): ``zoo_noise_cpu_vs_card`` draws one step's
   model noise of Shake-Shake 26 2x96d, PyramidNet-272 and EfficientNet-b0
   with 8 CondConv experts, mixup's draws and 4096 Beta(0.2) draws on the
   CPU and on the card from the same keys (bitwise); ``zoo_train_main_path``
   trains each at the full width of its preset through ``make_train_step``
   with K1 and K5 (CIFAR) or K1 and K6 (EfficientNet, mixup 0.2, seeded
   uint8 224x224 batches): 3 steps with the kernels against 3 with the
   plain versions under deterministic cuDNN (bitwise), launches against
   the plans, then the median of 4 timed steps, images/s, peak memory and
   a profiled trace of 2 steps (idle share, stages, CondConv's share);
   ``zoo_train_cli`` runs ``launch/train_cli.py`` on
   ``confs/shake26_2x96d_cifar.yaml`` with ``dataset=synthetic epoch=1``,
   saving, then with ``--only-eval`` (result keys, digest, equal metrics);
10. the device-resident data path (``dispatch_main_path``): ``train_and_eval``
   of the flagship on ``synthetic_shapes`` in nine arms (the eager host
   feed, the reference; the host feed as a graph replay, N = 1, N = 8, N =
   3, N = 3 resumed from a mid-epoch link; and with an EMA the eager and
   the graphed host feed and N = 3) with checkpoints and results equal to
   the eager host feed's and the predicted launches; ms per
   step, images/s, host launches per step, the device's idle share and peak
   memory of the host feed, N = 1 and N = 8 over a seeded 50,000-image set;
   PyramidNet-272 eager against CUDA-graph replays, bitwise.
   ``--dispatch-only`` runs this phase alone;
11. the search's runtime (``search_runtime_main_path``): (a) after the TTA
   path, the flagship trial with the step replayed as one CUDA graph a batch
   against the eager step (K = 1 and K = 4, bitwise; seconds per trial, host
   runtime calls, device busy time and idle share per batch, capture
   seconds, the graph census; K1's and K5's kernel records in each traced
   stretch, and in one of the K = 4 graph, match the launch counters,
   which count a replay from its capture); (b) after the search, ``search_cli`` in a
   fresh process with the async pipeline (2 actors, depth 1), the watchdog,
   a journal, ``/metrics`` and a compile cache, whose artifacts equal the
   serial arm's, and a second process that loads every kernel from the
   cache; (c) ``train_cli`` fault drills (``sigterm``, ``hang`` under
   ``--watchdog 5``, ``nan_loss`` with a divergence retry) and the
   watchdog's cost per dispatch.  ``--runtime-only`` runs the TTA path, (a),
   the search and (b)-(c) alone;
12. the search's fleet tier (``fleet_search_main_path``,
   :func:`phase_fleet_search`), after the search and against its serial arm:
   (a) three ``search_cli --workqueue`` hosts under ``launch/fleet.py
   launch_fleet --elastic`` (local shells in place of ssh; one hangs once
   under the watchdog, one is SIGKILLed on every attempt and lost, one
   joins once it is lost) and (b) a ``--fleet-transport`` learner with two
   actors (one SIGKILLed mid-fold), side by side; both arms' trial logs,
   final policy, audit and fold checkpoints equal the serial arm's bitwise,
   with a reclaimed unit each; the seconds from each kill to its reclaim,
   the longest gap between a live host's beats, rounds per actor, the
   rounds' publish->apply latency, and each arm's kernel launches (the
   hosts' ``LAUNCHES`` lines).  ``--fleet-only`` runs the search and this
   phase alone;
13. the closed control loop (``control_main_path``,
   :func:`phase_control_main_path`), after the search: two fleets of three
   ``serve_cli --traffic-stats`` replicas behind ``router_cli``, side by
   side, under closed-loop traffic and an injected input drift; (a)
   ``launch/control_cli.py`` detects it, runs the port's ``search_cli
   --topup-trials 2`` warm-started from the search's run, canaries the
   candidate on one replica and promotes it (``drift`` -> ``research`` ->
   ``canary`` -> ``promote`` in one journal, every replica on the
   candidate's digest, the base trials kept bitwise); (b) a controller
   SIGKILLed mid-canary and ``control_cli --resume`` driving the dangling
   episode to a promote; no failed request in either; every replica's and
   the re-search's kernel launches against their predictions; detection
   latency, re-search wall, canary -> verdict wall, requests/s and p50/p99
   before the drift, during the canary and after the promotion.
   ``--control-only`` runs the search and this phase alone;
14. the game days (``gameday_main_path``, :func:`phase_gameday_main_path`):
   ``launch/gameday_cli.py --suite --smoke --device cuda`` as a subprocess,
   every registered scenario at the JAX package's smoke factor 0.4 over a
   live plane of the port's replicas on the card (8x8 images at shapes 1, 4,
   8) behind ``router_cli``, with the autoscaler and ``control_cli`` where a
   scenario has them, flash crowds, cohort rotation over the tenant LRU, a
   SIGKILLed canary, drift, shared-FS faults; the suite green, the broken
   no-shedding flash crowd failing on ``shed_not_hang``, the schedules'
   digests, no shm region left, every replica on the card and its K7 and K1
   launches as predicted (a warm-up call a graph build, one replay a
   dispatch); a line a scenario (elapsed, bring-up, offered/ok/shed/hung,
   p50/p99, goodput, scale-ups, the control decision).
   ``--gameday-only`` runs this phase alone.

The last two lines are the ``kernels`` summary and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero with
no result line.  Without a CUDA device, or run from a directory that does
not hold the repository, it exits non-zero at once.
"""

from __future__ import annotations

import inspect
import io
import json
import math
import os
import shlex
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
#: K1's check shapes: serving and TTA (one block per image), odd sizes, the
#: train shape (a cluster per image), bands of unequal height, the tallest
#: image that fits clusters of 16, an image too large for a cluster (one
#: launch per slot), and the game days' serving call (8 images of 8x8)
SHAPES = ((128, 32, 32), (4, 17, 23), (128, 224, 224), (3, 225, 223), (2, 496, 300),
          (2, 520, 300), (8, 8, 8))
#: K1's two kernels (csrc/augment.cu): the cluster path and the per-slot path
K1_KERNELS = ("augment_kernel", "augment_slot_kernel")


def k1_bytes(images, policy) -> int:
    """The bytes K1's function must move: the images in and out once, each
    image's int32 sub-policy index and its float32 draws [num_op, 4], the
    policy once and the three range tables of 19 ops (float32, float32,
    bool)."""
    b, num_sub, num_op = int(images.shape[0]), int(policy.shape[0]), int(policy.shape[1])
    return 2 * images.numel() * 4 + 4 * b + 16 * b * num_op + 12 * num_sub * num_op + 19 * 9
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
#: the keys of a train_and_eval result (the JAX package's)
TRAIN_RESULT_KEYS = {"epoch", "loss_train", "top1_train", "top5_train", "loss_test",
                     "top1_test", "top5_test", "num_test", "best_valid_top1", "best_test_top1",
                     "elapsed_sec"}


#: the script's start: each phase line carries its end as ``at_s`` seconds after it
T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def card_clocks() -> str:
    """The card's SM clock, its maximum, power draw and the active throttle
    reasons, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
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


#: the draw kernels of csrc/sampler.cu: K7's three, K8's two (alone, and
#: as a train step's draws)
SAMPLER_KERNELS = ("keys_kernel", "lanes_kernel", "grouped_kernel")
NOISE_KERNELS = ("noise_kernel", "step_kernel")
DRAW_KERNELS = SAMPLER_KERNELS + NOISE_KERNELS


def device_kernel_counts(prof) -> dict[str, int]:
    """Executions of each kernel in a profile (copies and memsets left out)."""
    from torch.autograd import DeviceType

    return {e.key: e.count for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))}


#: CUgraphNodeType values (cuda.h) of the nodes a capture may hold
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "wait_event", 7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def graph_census(fn, names: bool = False) -> tuple:
    """Every piece of device work one call of `fn` does, read from a CUDA
    graph that captures the call (after a warm-up call, as the port's graphs
    are made): its nodes by type (kernels, copies, memsets, ...) through
    libcuda's graph calls, and the launches the port's wrappers recorded
    into it; with `names` also its kernel nodes by name (``cuFuncGetName``;
    a kernel of ``csrc/sampler.cu`` by its short name, any other by its
    mangled one).  A capture misses nothing that runs on the device, where a
    profile may drop records."""
    import ctypes

    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with _kernels.counting_capture() as tally:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            fail(f"graph census: {what} returned CUresult {rc}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    types: dict[str, int] = {}
    kernels: dict[str, int] = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)), "cuGraphNodeGetType")
        name = GRAPH_NODE_TYPES.get(t.value, f"type_{t.value}")
        types[name] = types.get(name, 0) + 1
        if names and name == "kernel":
            # CUDA_KERNEL_NODE_PARAMS begins with the CUfunction; the rest of
            # the struct (its size differs between versions) is left unread
            params = (ctypes.c_void_p * 32)()
            check(cu.cuGraphKernelNodeGetParams(ctypes.c_void_p(node), params),
                  "cuGraphKernelNodeGetParams")
            raw = ctypes.c_char_p()
            check(cu.cuFuncGetName(ctypes.byref(raw), ctypes.c_void_p(params[0])),
                  "cuFuncGetName")
            full = raw.value.decode()
            short = next((k for k in DRAW_KERNELS if k in full), full)
            kernels[short] = kernels.get(short, 0) + 1
    del graph
    tally = {k: v for k, v in tally.items() if v}
    return (types, tally, kernels) if names else (types, tally)


def kernel_counts(prof, parts) -> dict[str, int]:
    """Kernel executions in a profile for each name part."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    return {p: sum(e.count for e in rows if p in e.key) for p in parts}


def records_vs_counters(prof, counts: dict, k1_name: str, tag: str) -> tuple[dict, list]:
    """K1's and K5's kernel records in a profile against the launch
    counters' increase over the same stretch (`counts`): the counters may
    not fall below the records, and may exceed them by at most
    :data:`LOST_RECORDS` each (the profiler drops records).  Under CUDA-graph
    replay the counters are derived from the capture; this observes them.
    Returns the records and the problems found."""
    seen = kernel_counts(prof, (k1_name, "cifar_stack_kernel"))
    seen = {"augment": seen[k1_name], "cifar_stack": seen["cifar_stack_kernel"]}
    problems = [f"{tag}: the trace holds {n} {k} kernels, the counter {counts.get(k, 0)}"
                for k, n in seen.items()
                if n > counts.get(k, 0) or counts.get(k, 0) - n > LOST_RECORDS]
    return seen, problems


#: the kernels whose launches each path's prediction holds exactly: K1, K5
#: and K6 by the launch plans, the sampler (K7, ``sampler``) and the train
#: noise (K8, ``train_noise``) by the path's draw calls
#: (:data:`TTA_CALL_SAMPLER`, :func:`_step_draw_launches`)
ALL_KERNELS = ("augment", "cifar_stack", "imagenet_stack", "sampler", "train_noise")
#: K7 launches of a TTA or audit step call in a fold pass (``search/tta.py``):
#: the batch key's fold_in, the split into the draw keys, the draws' record;
#: a call given its key directly makes the last two
TTA_CALL_SAMPLER = 3


def _step_draw_launches(steps: int) -> dict:
    """K7 and K8 launches of `steps` train steps (``train/steps.py``): one K8
    launch a step (``PhiloxDraws.step_draws``: the key chain, the augment
    stack's record, the noise and mixup draws), none of K7, whether the
    model has noise sites or mixup or not."""
    return {"sampler": 0, "train_noise": steps}


def launches_differ(counts: dict, want: dict) -> bool:
    """True where the launches in `counts` are not `want`'s, kernel by kernel."""
    return {k: counts.get(k, 0) for k in ALL_KERNELS} != {k: want.get(k, 0)
                                                           for k in ALL_KERNELS}


def counts_since(before: dict) -> dict:
    """The launch counters' increase since `before` (a ``launch_counts()``)."""
    from fast_autoaugment_tpu_torch.ops import _kernels

    return {k: v - before.get(k, 0) for k, v in _kernels.launch_counts().items()}


#: the record_function ranges of the port: kineto projects each onto the
#: device's timeline as a span over its kernels, which is no device work
ANNOTATIONS = ("train.", "tta.", "search.")


def device_busy(prof, launched_by=None, skip_streams=frozenset(), after_ns=None) -> dict:
    """The device's work in a profile (kernels, copies, fills; not the
    ranges of `ANNOTATIONS`; not the streams in `skip_streams`; none that
    starts before `after_ns` on the device's clock), or only
    that launched by the operators for
    which ``launched_by(name, input_shapes)`` holds: the summed durations in
    µs, their union on the device's clock (the time the card was busy: the
    sum counts an overlap twice, and cuDNN runs some convolutions on streams
    of its own), the count of activities and of streams."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    ops = {e.correlation_id(): e for e in events  # the operators (no runtime calls)
           if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0}
    spans, streams = [], set()
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0 \
                or e.is_user_annotation() or e.name().startswith(ANNOTATIONS) \
                or int(e.device_resource_id()) in skip_streams \
                or (after_ns is not None and e.start_ns() < after_ns):
            continue
        if launched_by is not None:
            op = ops.get(e.linked_correlation_id())
            if op is None or not launched_by(op.name(), op.shapes()):
                continue
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        streams.add(e.device_resource_id())
    spans.sort()
    union_ns, end = 0, None
    for a, b in spans:
        if end is None or a >= end:
            union_ns, end = union_ns + b - a, b
        elif b > end:
            union_ns, end = union_ns + b - end, b
    return {"sum_us": sum(b - a for a, b in spans) / 1e3, "union_us": union_ns / 1e3,
            "activities": len(spans), "streams": len(streams)}


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


def _records_differing(aug, imgs, pol, sub, draws, cluster=None) -> int:
    """Bits of the slot records K1 builds on chip that differ from
    ``slot_records``' on the card (float32 words compared as integers)."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels

    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    want = aug.slot_records(pol, sub, draws, h, w)
    got = torch.full_like(want, float("nan"))
    _kernels.augment(imgs, pol, sub, draws, cluster=cluster, records=got)
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def _compare(aug, imgs, pol, sub, draws, clusters=(None,)) -> tuple[int, float]:
    """(differing elements, max |diff|) of kernel vs plain version, summed
    over the plan's cluster size (None) and any forced ones, plus the words
    of the slot records K1 built that differ from ``slot_records``; each call
    must launch the kernel as often as its plan says."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels

    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    want = aug.apply_subpolicy_draws_plain(imgs, pol, sub, draws)
    n_diff, err = 0, 0.0
    for c in clusters:
        n_diff += _records_differing(aug, imgs, pol, sub, draws, c)
        before = _kernels.launch_counts()["augment"]
        if c is None:
            got = aug.apply_subpolicy_draws(imgs, pol, sub, draws)
        else:
            got = _kernels.augment(imgs, pol, sub, draws, cluster=c)
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
    """One ``serve_cli`` process on the card (or, with `module`, another of
    the port's HTTP entry points that takes ``--port 0 --port-file``)."""

    def __init__(self, args: list[str], workdir: str, tag: str,
                 module: str = "fast_autoaugment_tpu_torch.serve.serve_cli",
                 env_extra: dict | None = None):
        self.tag = tag
        self.port_file = os.path.join(workdir, f"{tag}.port")
        self.log_path = os.path.join(workdir, f"{tag}.log")
        self.log = open(self.log_path, "w")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   **(env_extra or {}))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args, "--port", "0", "--port-file", self.port_file],
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

    def request(self, path: str, body: bytes | None = None, ctype: str = "application/json",
                headers: dict | None = None) -> tuple[int, dict, bytes]:
        """One exchange that does not raise on an error status."""
        return _http(self.port, path, body, ctype, headers)

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


def _http(port: int, path: str, body: bytes | None = None, ctype: str = "application/json",
          headers: dict | None = None, timeout: float = 120.0) -> tuple[int, dict, bytes]:
    """One HTTP exchange with a local endpoint: ``(status, headers, body)``,
    without raising on an error status."""
    hdrs = dict(headers or {})
    if body is not None:
        hdrs.setdefault("Content-Type", ctype)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


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


def _replica_sampler(stats: dict, tag: str) -> int:
    """A replica's sampler launches (``/stats``), held to one a graph replay
    after each shape's warm-up call: every dispatch draws in one launch."""
    got = stats["kernel_launches"]["sampler"]
    if got - stats["kernel_launches_warmup"]["sampler"] != stats["dispatches"]:
        fail(f"replica {tag}: {got} sampler launches less the warm-ups are not its "
             f"{stats['dispatches']} dispatches x 1")
    return got


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
            st0 = before[id(r)]
            if st0["kernel_launches"]["augment"] != st0["kernel_launches_warmup"]["augment"] \
                    or st0["dispatches"] or not st0["graphs"]:
                fail("a replica launched the kernel before serving any request, beyond its "
                     "graphs' warm-up calls, or serves without graphs")
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
        warmups = 0
        for r in replicas:
            st = after[id(r)]
            n_launch = st["kernel_launches"]["augment"]
            replays = n_launch - st["kernel_launches_warmup"]["augment"]
            if replays <= 0 or replays != st["dispatches"] * per_call[id(r)]:
                fail(f"launch count {n_launch} less the warm-ups is not dispatches "
                     f"{st['dispatches']} x {per_call[id(r)]} launches per call")
            launches += n_launch
            warmups += st["kernel_launches_warmup"]["augment"]
            dispatches += st["dispatches"]
        if _kernels.launch_counts()["augment"] != 0:
            fail("the smoke process itself launched the kernel during the main path")
        served = sum(after[id(r)]["requests"] for r in replicas)
        if served != requests or requests < 16:
            fail(f"replicas served {served} requests, sent {requests}")
        emit({"phase": "main_path", "requests": requests, "dispatches": dispatches,
              "kernel_launches": launches, "launches_per_dispatch": list(per_call.values()),
              "warmup_launches": warmups,
              "launches_are": "graph warm-up calls (one a shape) + dispatches x launches "
                              "per call, counted at each replay",
              "burst_requests": burst_n,
              "burst_dispatches": burst_dispatches,
              "grouped_stats": {k: after[id(grouped)][k] for k in
                                ("dispatches", "requests", "images_served", "mean_batch")},
              "exact_stats": {k: after[id(exact)][k] for k in
                              ("dispatches", "requests", "images_served", "mean_batch")}})
        serve = phase_serve_burst(grouped)
        final = grouped.get("/stats")
        if final["kernel_launches"]["augment"] - final["kernel_launches_warmup"]["augment"] \
                != final["dispatches"] * per_call[id(grouped)]:
            fail("launch count drifted from dispatches x launches per call during the burst")
        sampler = _replica_sampler(final, "grouped") + _replica_sampler(after[id(exact)], "exact")
        rcs = [r.stop() for r in replicas]
        if rcs != [0, 0]:
            fail(f"SIGTERM drain exit codes {rcs} (want 0): {grouped.tail()} {exact.tail()}")
        emit({"phase": "drain", "exit_codes": rcs, "sampler_launches": sampler})
        return {"launches": launches, "sampler_launches": sampler, "serve": serve}
    finally:
        for r in replicas:
            r.kill()


def _closed_loop(post, clients: int, per_client: int, n: int, seed: int = 2,
                 on_progress=None) -> dict:
    """`clients` threads each send `per_client` raw requests of `n` 32x32
    images back to back through ``post(body, ctype)``; `on_progress(done)`
    is called after each answer."""
    from fast_autoaugment_tpu_torch.serve import wire

    g = np.random.default_rng(seed)
    body = wire.encode_raw(g.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8))
    lat: list[float] = []
    lock = threading.Lock()
    errors: list[str] = []

    def client():
        for _ in range(per_client):
            t0 = time.perf_counter()
            try:
                post(body, wire.RAW_CONTENT_TYPE)
            except Exception as e:  # noqa: BLE001 -- counted, fails the phase
                errors.append(repr(e))
                return
            with lock:
                lat.append(time.perf_counter() - t0)
                done = len(lat)
            if on_progress is not None:
                on_progress(done)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    ms = np.array(lat or [0.0]) * 1e3
    return {"clients": clients, "requests": len(lat), "failed": clients * per_client - len(lat),
            "errors": errors[:3], "images_per_request": n, "image": 32,
            "requests_per_s": len(lat) / wall, "images_per_s": len(lat) * n / wall,
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}


def phase_serve_burst(replica, clients: int = 16, per_client: int = 25, n: int = 8) -> dict:
    """Closed loop: `clients` threads each send `per_client` raw requests of
    `n` 32x32 images back to back."""
    d0 = replica.get("/stats")["dispatches"]
    loop = _closed_loop(replica.post, clients, per_client, n)
    if loop["failed"]:
        fail(f"closed-loop burst lost requests: {loop['errors']}")
    out = {"phase": "serve_burst", "card": nvidia_smi(), **loop,
           "policy": "fa_reduced_cifar10", "dispatch": "grouped",
           "dispatches": replica.get("/stats")["dispatches"] - d0}
    emit(out)
    return out


# ------------------------------------------------------- the serving plane

#: the flags of both replicas behind the router, beyond policy and dirs
SERVE_PLANE_FLAGS = ["--donate", "--double-buffer", "--watchdog", "auto", "--traffic-stats",
                     "--breaker-threshold", "3", "--breaker-exit", "--shm-ingest"]
#: the (c) reload burst: clients, answers before the reload, answers after it
RELOAD_CLIENTS, RELOAD_BEFORE, RELOAD_AFTER = 8, 40, 40
#: the (f) SIGKILL burst through the router
KILL_CLIENTS, KILL_PER_CLIENT = 16, 15
#: the (g) fleet replica's dispatch floor (ms), one image a dispatch: 16
#: one-image clients hold its queue above the high watermark
FLEET_FLOOR_MS = 150
SERVE_FAMILIES = ("faa_serve_dispatches_total", "faa_serve_requests_total",
                  "faa_serve_images_total", "faa_serve_robustness_total",
                  "faa_serve_stage_seconds", "faa_serve_queue_depth", "faa_serve_input_mean",
                  "faa_serve_input_std", "faa_serve_reward_proxy", "faa_tenant_events_total")


def _seeded_single_sub(seed: int) -> np.ndarray:
    """A seeded single-sub policy of 2 ops: served exactly, so each lane's
    output is a function of its image and key alone and can be checked."""
    from fast_autoaugment_tpu_torch.ops.augment import NUM_OPS

    g = np.random.default_rng(seed)
    arr = np.zeros((1, 2, 3), np.float32)
    arr[0, :, 0] = g.choice(NUM_OPS, 2, replace=False)
    arr[0, :, 1] = g.uniform(0.5, 1.0, 2).round(3)
    arr[0, :, 2] = g.uniform(0.0, 1.0, 2).round(3)
    return arr


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


def _wait_for(cond, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.1)
    fail(f"timed out after {timeout}s waiting for {what}")


def _arm_times(apply, imgs, key, calls: int = 50, traced: int = 20) -> dict:
    """ms per `apply` call at one shape (each call reads its result back),
    and over a traced stretch the host's runtime calls per call and the
    device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        apply(imgs, key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        apply(imgs, key)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            apply(imgs, key)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy = device_busy(prof)
    host = _host_launches(prof)
    kernels = device_kernel_counts(prof)
    return {"ms_per_call": ms, "traced_calls": traced,
            "device_kernels_per_call": sum(kernels.values()) / traced,
            "sampler_kernels_per_call": sum(v for k, v in kernels.items()
                                            if any(n in k for n in SAMPLER_KERNELS)) / traced,
            "traced_ms_per_call": wall_s * 1e3 / traced,
            "host_runtime_calls_per_call": sum(host.values()) / traced,
            "host_runtime_calls": {k: v / traced for k, v in host.items()},
            "device_busy_ms_per_call": busy["union_us"] / 1e3 / traced,
            "device_idle_share": 1 - busy["union_us"] / 1e6 / wall_s}


def _serve_graphs_bitwise(dev, card: str) -> dict:
    """(a): every shape's graph replay against the eager path, bitwise; K1's
    records in traced stretches against the counters; capture seconds; the
    128x32x32 graph and eager arms' times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
    from fast_autoaugment_tpu_torch.serve.policy_server import PolicyApplier

    g = np.random.default_rng(20)
    before = _kernels.launch_counts()
    cifar = PolicyApplier(policy_to_tensor(load_policy("fa_reduced_cifar10")), image=32,
                          shapes=(1, 8, 32, 128), device=dev)
    single = PolicyApplier(policy_to_tensor([load_policy("fa_resnet50_rimagenet")[0]]),
                           image=224, shapes=(1, 8), device=dev)
    checked, problems = 0, []
    for ap, size in ((cifar, 32), (single, 224)):
        for s in ap.shapes:
            for n in sorted({s, s // 2 + 1}):
                for _ in range(2):
                    imgs = g.integers(0, 256, (n, size, size, 3)).astype(np.uint8)
                    if ap.dispatch == "exact":
                        key = g.integers(0, 2**31, (n, 2)).astype(np.uint32)
                    else:
                        key = np.uint32([0, int(g.integers(0, 2**31))])
                    checked += 1
                    if not np.array_equal(ap.apply(imgs, key), ap.apply_eager(imgs, key)):
                        problems.append(f"{ap.dispatch} {size}px shape {s} n {n}: "
                                        "graph != eager")
    # each graph draws with one sampler launch (K7), then K1
    tallies = {f"{ap.dispatch}_{size}_b{s}": dict(ap._graphs[s].tally)
               for ap, size in ((cifar, 32), (single, 224)) for s in ap.shapes}
    for name, tally in tallies.items():
        if tally["sampler"] != 1 or tally["augment"] != 1:
            problems.append(f"graph {name} holds {tally}, not 1 sampler and 1 K1 launch")
    imgs = g.integers(0, 256, (128, 32, 32, 3)).astype(np.uint8)
    key = np.uint32([0, 77])
    arms = {"graph": _arm_times(cifar.apply, imgs, key),
            "eager": _arm_times(cifar.apply_eager, imgs, key)}
    k1 = _kernels.augment_plan(32, 32, cifar.num_op).kernel
    records = {}
    for name, apply in (("graph", cifar.apply), ("eager", cifar.apply_eager)):
        c0 = _kernels.launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                apply(imgs, key)
            torch.cuda.synchronize()
        counted = counts_since(c0)
        seen, found = records_vs_counters(prof, counted, k1, f"serve {name}")
        records[name] = {"kernel_records": seen, "launches_counted": counted}
        problems += found
    if problems:
        fail("serve_plane (a): " + "; ".join(problems))
    out = {"phase": "serve_plane", "part": "a_graphs", "card": card,
           "calls_checked_bitwise": checked,
           "capture_s": {"cifar_grouped_32": {s: r["sec"] for s, r in cifar.compile_log.items()},
                         "imagenet_exact_224": {s: r["sec"]
                                                for s, r in single.compile_log.items()}},
           "at_128x32x32": arms, "graph_launches": tallies, "records_vs_counters": records,
           "launches": counts_since(before),
           "timing": "host clock around 50 apply calls (each waits for its result), after 3 "
                     "warm-up calls; traced: 20 calls under torch.profiler, host runtime calls "
                     "= kernel launches, graph launches, async copies and memsets, device "
                     "busy = the union of the device's activities, idle = 1 - busy / the "
                     "traced wall"}
    emit(out)
    return out


def _card_tests() -> dict:
    """The card-only serving tests, in a process of their own."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_serve_graphs.py", "-m", "cuda",
         "--noconftest", "-q", "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")))
    tail = proc.stdout.strip().splitlines()[-1:] if proc.stdout.strip() else [""]
    if proc.returncode != 0 or "passed" not in tail[0] or "skipped" in tail[0]:
        fail(f"card-only serving tests failed: {proc.stdout[-3000:]} {proc.stderr[-2000:]}")
    return {"card_tests": tail[0], "card_tests_s": time.perf_counter() - t0}


def _reload_mid_burst(b, pols: dict) -> dict:
    """(c): exact requests with keys go to B from several clients while B
    reloads from p1 to p3; every answer must be 200, name p1 or p3 in its
    digest header and equal the eager reference under that policy."""
    from fast_autoaugment_tpu_torch.serve import wire

    answers, lock = [], threading.Lock()
    reloaded, stop = threading.Event(), threading.Event()
    info: dict = {}

    def do_reload():
        info["answer"] = b.request("/reload", json.dumps({"policy": pols["p3"]["path"]})
                                   .encode())
        with lock:
            info["at"] = len(answers)
        reloaded.set()

    def client(cid):
        i = 0
        while not stop.is_set():
            imgs = np.random.default_rng(1000 * cid + i).integers(
                0, 256, (8, 32, 32, 3)).astype(np.uint8)
            keys = np.stack([np.uint32([cid, 1000 * i + j]) for j in range(8)])
            st, hdr, body = b.request("/augment", wire.encode_raw(imgs, seeds=keys),
                                      wire.RAW_CONTENT_TYPE)
            with lock:
                answers.append((imgs, keys, st, hdr.get("X-FAA-Policy-Digest"), body))
                done = len(answers)
                start = done >= RELOAD_BEFORE and "started" not in info
                if start:
                    info["started"] = done
            if start:
                threading.Thread(target=do_reload).start()
            if reloaded.is_set() and done >= info["at"] + RELOAD_AFTER:
                stop.set()
            i += 1

    threads = [threading.Thread(target=client, args=(cid,)) for cid in range(RELOAD_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    rst, _, rbody = info["answer"]
    if rst != 200 or json.loads(rbody)["digest"] != pols["p3"]["digest"]:
        fail(f"serve_plane (c): /reload answered {rst} {rbody[:300]}")
    by = {pols["p1"]["digest"]: "p1", pols["p3"]["digest"]: "p3"}
    bad, served = [], {"p1": 0, "p3": 0}
    for imgs, keys, st, digest, body in answers:
        if st != 200 or digest not in by:
            bad.append(f"status {st} digest {digest}")
            continue
        served[by[digest]] += 1
        if not np.array_equal(wire.decode_raw(body)[0],
                              _u8(pols[by[digest]]["ref"].apply_eager(imgs, keys))):
            bad.append(f"an output differs from the reference under {by[digest]}")
    if bad or not served["p1"] or not served["p3"]:
        fail(f"serve_plane (c): {len(bad)} bad answers {bad[:3]}, served {served}")
    return {"requests": len(answers), "failed": 0, "served_by": served,
            "reload_started_after": info["started"], "reload_done_after": info["at"],
            "reload": json.loads(rbody), "outputs_bitwise": True}


def _tenancy_via_router(b, rt, pols: dict) -> dict:
    """(d): p2 warmed on B; requests naming p2 go through the router, which
    tries the replicas in rendezvous order and lands on B."""
    from fast_autoaugment_tpu_torch.serve import wire
    from fast_autoaugment_tpu_torch.serve.router import rendezvous_order

    st, _, body = b.request("/tenants/warm", json.dumps({"policy": pols["p2"]["path"]})
                            .encode())
    if st != 200 or json.loads(body)["digest"] != pols["p2"]["digest"]:
        fail(f"serve_plane (d): /tenants/warm answered {st} {body[:300]}")
    routed, bad = [], []
    for i in range(10):
        imgs = np.random.default_rng(500 + i).integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
        keys = np.stack([np.uint32([9, 100 * i + j]) for j in range(4)])
        st, hdr, body = rt.request("/augment", wire.encode_raw(imgs, seeds=keys),
                                   wire.RAW_CONTENT_TYPE,
                                   {"X-FAA-Policy-Digest": pols["p2"]["digest"]})
        routed.append(hdr.get("X-FAA-Routed-To"))
        if st != 200 or routed[-1] != "rB" or not np.array_equal(
                wire.decode_raw(body)[0], _u8(pols["p2"]["ref"].apply_eager(imgs, keys))):
            bad.append(f"request {i}: {st} via {routed[-1]}")
    ten = b.get("/stats")["tenancy"]
    if bad or pols["p2"]["digest"] not in ten["resident"] or ten["hits"] < 10:
        fail(f"serve_plane (d): {bad[:3]}, tenancy {ten}")
    return {"rendezvous_order": rendezvous_order(pols["p2"]["digest"], ["rA", "rB"]),
            "routed_to": routed, "tenancy": ten, "outputs_bitwise": True}


def _lanes(b, ref) -> dict:
    """(e): the raw lane, two frames of /augment_batch and the shm lane
    give B's answer for the same images and keys, bitwise."""
    from fast_autoaugment_tpu_torch.serve import wire

    imgs = np.random.default_rng(600).integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    keys = np.stack([np.uint32([3, j]) for j in range(8)])
    st, _, body = b.request("/augment", wire.encode_raw(imgs, seeds=keys), wire.RAW_CONTENT_TYPE)
    raw = wire.decode_raw(body)[0]
    frames = wire.encode_frames([
        ({"ctype": wire.RAW_CONTENT_TYPE}, wire.encode_raw(imgs[:5], seeds=keys[:5])),
        ({"ctype": wire.RAW_CONTENT_TYPE}, wire.encode_raw(imgs[5:], seeds=keys[5:]))])
    fst, _, fbody = b.request("/augment_batch", frames, wire.FRAME_CONTENT_TYPE)
    framed = np.concatenate([wire.decode_raw(bytes(pb))[0]
                             for _, pb in wire.decode_frames(fbody)])
    region = wire.ShmRegion(imgs.shape, np.uint8)
    try:
        region.write(imgs)
        sst, _, _ = b.request("/augment", region.request_body(seeds=keys), wire.SHM_CONTENT_TYPE)
        shm = region.read_result()
    finally:
        region.close()
    same = (np.array_equal(raw, _u8(ref.apply_eager(imgs, keys)))
            and np.array_equal(framed, raw) and np.array_equal(shm, raw))
    if (st, fst, sst) != (200, 200, 200) or not same:
        fail(f"serve_plane (e): the lanes answered {(st, fst, sst)}, bitwise equal {same}")
    return {"raw_frames_shm_bitwise": True, "images": 8, "frames": 2}


def _breaker_drill(c) -> dict:
    """(f): C runs under ``FAA_FAULT=serve_error@dispatch=1..3`` with
    ``--breaker-threshold 3 --breaker-exit``: three typed 500s open the
    breaker, the next request is refused with a typed 503 (or finds the
    replica gone), and the replica exits 77."""
    from fast_autoaugment_tpu_torch.serve import wire

    body = wire.encode_raw(np.zeros((2, 32, 32, 3), np.uint8))
    drill = []
    for _ in range(4):
        try:
            st, _, resp = c.request("/augment", body, wire.RAW_CONTENT_TYPE)
            drill.append([st, json.loads(resp).get("type")])
        except OSError as e:  # the replica exited after the breaker opened
            drill.append(["gone", type(e).__name__])
    rc = c.proc.wait(timeout=60)
    typed_503 = drill[3][0] == "gone" or (drill[3][0] == 503
                                          and drill[3][1] in ("breaker_open", "draining"))
    if drill[:3] != [[500, "dispatch_error"]] * 3 or not typed_503 or rc != 77:
        fail(f"serve_plane (f): breaker drill {drill}, exit {rc}: {c.tail()}")
    return {"answers": drill, "exit_code": rc}


def _autoscaler_cycle(fleet, port_dir: str) -> dict:
    """(g): the fleet's one replica is held above the queue watermark by 16
    one-image clients; one step scales up to two (the port's serve_cli);
    once the burst ends and the queue drains, one step scales back down."""
    from fast_autoaugment_tpu_torch.serve import autoscaler, wire
    from fast_autoaugment_tpu_torch.serve.router import discover_replicas

    t0 = time.perf_counter()

    def ready():
        up = []
        for r in discover_replicas(port_dir) or []:
            try:
                if _http(r["port"], "/readyz", timeout=5)[0] == 200:
                    up.append(r)
            except OSError:
                pass
        return up

    first = _wait_for(ready, 180, "the fleet's first replica")[0]
    scraper = autoscaler.ReplicaScraper(port_dir)
    policy = autoscaler.AutoscalerPolicy(high_queue=4.0, low_queue=0.0, high_shed_rate=1e9,
                                         low_shed_rate=1e9, up_polls=1, down_polls=1,
                                         cooldown_s=0.0, min_replicas=1, max_replicas=2)
    scaler = autoscaler.Autoscaler(scraper.scrape, fleet.scale_up, fleet.scale_down,
                                   fleet.count, policy, name="smoke")
    stop, errors = threading.Event(), []
    body = wire.encode_raw(np.zeros((1, 32, 32, 3), np.uint8))

    def client():
        while not stop.is_set():
            try:
                st = _http(first["port"], "/augment", body, wire.RAW_CONTENT_TYPE)[0]
                if st != 200:
                    errors.append(st)
            except OSError as e:
                errors.append(repr(e))

    def signal_where(pred):
        sig = scraper.scrape()
        return sig if pred(sig) else None

    threads = [threading.Thread(target=client) for _ in range(16)]
    for t in threads:
        t.start()
    try:
        sig_up = _wait_for(lambda: signal_where(lambda s: s["queue_depth"] >= 4), 60,
                           "the fleet's queue above the high watermark")
        up = scaler.step()
        if up != "up" or fleet.count() != 2:
            fail(f"serve_plane (g): the scale-up step did {up}, fleet {fleet.count()}")
        _wait_for(lambda: len(ready()) == 2, 180, "the scaled-up replica")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    sig_down = _wait_for(lambda: signal_where(lambda s: s["queue_depth"] == 0), 60,
                         "the fleet's queue to drain")
    down = scaler.step()
    if down != "down" or fleet.count() != 1 or errors:
        fail(f"serve_plane (g): the scale-down step did {down}, fleet {fleet.count()}, "
             f"client errors {errors[:3]}")
    keys = ("queue_depth", "shed_rate", "breaker_open", "reachable")
    return {"scale_up_signal": {k: sig_up[k] for k in keys},
            "scale_down_signal": {k: sig_down[k] for k in keys},
            "decisions": scaler.stats()["decisions"], "replicas_after": fleet.count(),
            "records_after": sorted(r["tag"] for r in discover_replicas(port_dir) or []),
            "cycle_s": time.perf_counter() - t0}


def phase_serve_plane(dev, workdir: str, card: str) -> dict:
    """The serving plane on the card: (a) graphs bitwise, (b) two replicas
    behind ``router_cli``, (c) a hot reload mid-burst, (d) tenancy, (e) the
    frame and shm lanes, (f) the breaker, SIGKILL and /metrics drills, (g)
    one autoscaler cycle.  The replicas start together at the phase's start
    and come up while (a) runs."""
    import shutil

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.policies.archive import tensor_to_policy
    from fast_autoaugment_tpu_torch.serve import autoscaler
    from fast_autoaugment_tpu_torch.serve.policy_server import PolicyApplier, policy_digest
    from fast_autoaugment_tpu_torch.serve.router import discover_replicas

    t_phase = time.perf_counter()
    d = {k: os.path.join(workdir, k) for k in ("ports", "beats", "journal", "cache",
                                                 "policies", "fleet")}
    for path in d.values():
        os.makedirs(path, exist_ok=True)
    for name in _kernels.SOURCES:  # the replicas load this process's build from the cache
        lib = _kernels._library_path(name)
        shutil.copy2(lib, os.path.join(d["cache"], lib.name))
    pols = {}
    for name, seed in (("p1", 11), ("p2", 12), ("p3", 13)):
        arr = _seeded_single_sub(seed)
        path = os.path.join(workdir, f"{name}.json")
        with open(path, "w") as fh:
            json.dump(tensor_to_policy(arr), fh)
        pols[name] = {"path": path, "digest": policy_digest(arr),
                      "ref": PolicyApplier(arr, image=32, shapes=(1, 8, 32, 128), device=dev)}
    shutil.copy2(pols["p2"]["path"], os.path.join(d["policies"], "p2.json"))
    common = ["--image", "32", "--port-dir", d["ports"], "--heartbeat-dir", d["beats"],
              "--telemetry", d["journal"], "--compile-cache", d["cache"], *SERVE_PLANE_FLAGS]
    pypath = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = {
        "A": Replica(["--policy", "fa_reduced_cifar10", "--host-tag", "rA", *common],
                     workdir, "plane_a"),
        "B": Replica(["--policy", pols["p1"]["path"], "--host-tag", "rB", "--tenant-capacity",
                      "2", "--policy-dir", d["policies"], *common], workdir, "plane_b"),
        "C": Replica(["--policy", pols["p1"]["path"], "--image", "32", "--shapes", "1,8",
                      "--breaker-threshold", "3", "--breaker-exit", "--host-tag", "rC"],
                     workdir, "plane_c",
                     env_extra={"FAA_FAULT": "serve_error@dispatch=1;serve_error@dispatch=2;"
                                             "serve_error@dispatch=3"}),
        "router": Replica(["--port-dir", d["ports"], "--poll-interval", "0.2",
                           "--eject-after", "1", "--readmit-after", "1",
                           "--failover-attempts", "2"], workdir, "plane_router",
                          module="fast_autoaugment_tpu_torch.serve.router_cli"),
    }
    fleet = autoscaler.LocalReplicaFleet(
        ["--policy", pols["p1"]["path"], "--image", "32", "--shapes", "1", "--max-batch", "1",
         "--dispatch-floor-ms", str(FLEET_FLOOR_MS), "--compile-cache", d["cache"]],
        d["fleet"], extra_env=pypath, tag_prefix="fleet")
    fleet.scale_up()
    out = {"phase": "serve_plane", "card": card}
    try:
        out.update(_card_tests())
        graphs = _serve_graphs_bitwise(dev, card)
        for p in procs.values():
            p.wait_ready()
        a, b, c, rt = procs["A"], procs["B"], procs["C"], procs["router"]
        _wait_for(lambda: json.loads(rt.request("/readyz")[2]).get("in_rotation") == 2, 120,
                  "both replicas in the router's rotation")
        out["startup_s"] = time.perf_counter() - t_phase
        for k, r in (("A", a), ("B", b)):
            st = r.get("/stats")
            cc = st["compile_cache"]
            if not st["graphs"] or cc["misses"] or not cc["hits"]:
                fail(f"replica {k}: graphs {st['graphs']}, compile cache {cc}")
            out[f"graph_capture_{k}"] = st["graph_capture"]

        # (b) the closed loop through the router, then straight to one replica
        routed = _closed_loop(rt.post, 16, 25, 8)
        direct = _closed_loop(a.post, 16, 25, 8)
        if routed["failed"] or direct["failed"]:
            fail(f"serve_plane (b): failed requests {routed['errors']} {direct['errors']}")
        rstats = json.loads(rt.request("/stats")[2])
        out["b_burst"] = {"through_router": routed, "direct_to_A": direct,
                          "router_outcomes": rstats["outcomes"],
                          "in_rotation": rstats["in_rotation"]}
        out["c_reload"] = _reload_mid_burst(b, pols)
        out["d_tenancy"] = _tenancy_via_router(b, rt, pols)
        out["e_lanes"] = _lanes(b, pols["p3"]["ref"])

        # (f) drills: the breaker on C, SIGKILL of A mid-burst, /metrics on B
        breaker = _breaker_drill(c)
        stats_a = a.get("/stats")
        killed = threading.Event()

        def kill_a(done):
            if done >= KILL_CLIENTS * KILL_PER_CLIENT // 3 and not killed.is_set():
                killed.set()
                a.proc.kill()

        kill_loop = _closed_loop(rt.post, KILL_CLIENTS, KILL_PER_CLIENT, 8, seed=7,
                                 on_progress=kill_a)
        rstats = json.loads(rt.request("/stats")[2])
        if kill_loop["failed"] or not killed.is_set():
            fail(f"serve_plane (f): the SIGKILL burst lost {kill_loop['failed']} requests: "
                 f"{kill_loop['errors']}")
        metrics = b.request("/metrics")[2].decode()
        missing = [f for f in SERVE_FAMILIES if f not in metrics]
        if missing:
            fail(f"serve_plane (f): /metrics lacks {missing}")
        out["f_drills"] = {"breaker": breaker, "sigkill_burst": kill_loop,
                           "router_after_kill": {k: rstats[k] for k in
                                                 ("in_rotation", "failovers", "outcomes")},
                           "metrics_families": len(SERVE_FAMILIES)}
        out["g_autoscaler"] = _autoscaler_cycle(fleet, d["fleet"])

        # the records the replicas left, and their launch accounting
        stats_b = b.get("/stats")
        beats = sorted(os.listdir(os.path.join(d["beats"], "hosts")))
        records = sorted(r["tag"] for r in discover_replicas(d["ports"]) or [])
        journal = [n for n in os.listdir(d["journal"]) if n.endswith(".jsonl")]
        rc_b, rc_rt = b.stop(), rt.stop()
        left = sorted(r["tag"] for r in discover_replicas(d["ports"]) or [])
        if rc_b != 0 or rc_rt != 0 or "rB.json" not in beats or not journal or "rB" in left:
            fail(f"serve_plane: exits B {rc_b} router {rc_rt}, beats {beats}, journal "
                 f"{journal}, records after B's drain {left}")
        launches = {}
        for k, st in (("A", stats_a), ("B", stats_b)):
            total = st["kernel_launches"]["augment"]
            replays = total - st["kernel_launches_warmup"]["augment"]
            per_call = _kernels.augment_plan(32, 32, st["num_op"]).launches
            if replays != st["dispatches"] * per_call:
                fail(f"replica {k}: {replays} replayed launches != {st['dispatches']} "
                     f"dispatches x {per_call}")
            launches[k] = {"total": total, "warmup": st["kernel_launches_warmup"]["augment"],
                           "dispatches": st["dispatches"],
                           "sampler": _replica_sampler(st, k)}
        out.update({"records_before_drain": records, "beats": beats,
                    "journal_segments": len(journal), "replica_launches": launches,
                    "in_process_launches": graphs["launches"],
                    "launches": graphs["launches"]["augment"]
                    + sum(v["total"] for v in launches.values()),
                    "sampler_launches": graphs["launches"]["sampler"]
                    + sum(v["sampler"] for v in launches.values()),
                    "stats_b": {k: stats_b.get(k) for k in ("dispatches", "requests",
                                                             "images_served", "reloads",
                                                             "traffic", "data_plane")},
                    "phase_s": time.perf_counter() - t_phase})
        emit(out)
        return out
    finally:
        for p in procs.values():
            p.kill()
        fleet.stop_all(drain_timeout=10.0)


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
        rec = aug.slot_records(policy, sub, draws, img, img)  # the work, for the bound
        plan = _kernels.augment_plan(img, img, int(policy.shape[1]))
        k1 = lambda: _kernels.augment(x, policy, sub, draws)  # noqa: E731
        kernel_event_ms = cuda_ms(k1)
        kernel_graph_ms = graph_ms(k1)
        kernel_ms = kernel_device_ms(k1, kernel=plan.kernel, per_call=plan.launches)
        wrapper_ms = cuda_ms(lambda: aug.apply_subpolicy_draws(x, policy, sub, draws))
        plain_ms = cuda_ms(lambda: aug.apply_subpolicy_draws_plain(x, policy, sub, draws),
                           iters=5, warmup=1)
        nbytes = k1_bytes(x, policy)
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


#: apply_subpolicy_draws calls profiled alone by phase_trace
APPLY_CALLS = 5
#: empty kernels that open a profiled window, each waited for, with a gap
#: before the next that doubles from :data:`PRIMING_FIRST_GAP_S`: the profiler
#: drops the device records that it places before the window's start (a
#: window's first 4-5 back-to-back kernels, and late in a long run a traced
#: step's first K1 and K6: PERF.md §7), so a window's work begins ~0.33 s
#: after its start, and the priming records kept bracket that cut
#: (:func:`priming_kept`)
PRIMING_LAUNCHES = 16
PRIMING_FIRST_GAP_S = 10e-6


def prime_profiler(dev) -> list[float]:
    """Launch :data:`PRIMING_LAUNCHES` empty kernels (uncounted, on no path),
    each waited for and followed by a doubling gap: call it first thing in a
    profiled window.  Returns each launch's time in s since the call."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels

    t0, offsets = time.perf_counter(), []
    for i in range(PRIMING_LAUNCHES):
        if i:
            time.sleep(PRIMING_FIRST_GAP_S * 2 ** (i - 1))
        offsets.append(time.perf_counter() - t0)
        _kernels.empty_kernel(dev)
        torch.cuda.synchronize(dev)
    return offsets


def priming_kept(prof, offsets: list[float]) -> dict:
    """The priming kernel records that a profile kept, of those launched at
    `offsets` (:func:`prime_profiler`).  The drops are the first ones, so the
    window's start was cut between the last dropped launch and the first
    kept one (``cut_ms``, from the priming's start; a bound is None where
    every record was kept or none)."""
    kept = kernel_counts(prof, ("empty_kernel",))["empty_kernel"]
    lost = len(offsets) - kept
    return {"launched": len(offsets), "kept": kept,
            "cut_ms": [offsets[lost - 1] * 1e3 if lost > 0 else None,
                       offsets[lost] * 1e3 if 0 <= lost < len(offsets) else None]}


def priming_end_ns(prof) -> int | None:
    """The device start of a profile's last priming kernel record (None if
    it kept none): the work after :func:`prime_profiler` starts later."""
    from torch.autograd import DeviceType

    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and "empty_kernel" in e.name()]
    return max(starts) if starts else None


def phase_trace(dev, card: str) -> dict:
    """``torch.profiler`` over 20 ``PolicyApplier.apply`` calls at the
    largest serving shape (128 x 32 x 32, grouped): device time by kernel
    and the device's idle share of the wall (the HTTP layer excluded).
    Fails unless the serving step's graph holds K7 and K1 and nothing else,
    ``apply_subpolicy_draws``'s K1 and nothing else (:func:`graph_census`),
    and unless the profiles show no other kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
    from fast_autoaugment_tpu_torch.serve.policy_server import PolicyApplier

    applier = PolicyApplier(policy_to_tensor(load_policy("fa_reduced_cifar10")), image=32,
                            device=dev)
    imgs = np.random.default_rng(4).integers(0, 256, (128, 32, 32, 3)).astype(np.uint8)
    for i in range(3):
        applier.apply(imgs, np.uint32([9, i]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        priming = prime_profiler(dev)
        t0 = time.perf_counter()
        for i in range(20):
            applier.apply(imgs, np.uint32([9, 100 + i]))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = {k: v for k, v in kernel_device_us(prof).items() if "empty_kernel" not in k}
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    kernels = {k: v for k, v in device_kernel_counts(prof).items() if "empty_kernel" not in k}
    # apply_subpolicy_draws alone on the card: K1 and no other kernel (its
    # captured graph below also shows no copy and no memset)
    x = torch.from_numpy(imgs.astype(np.float32)).to(dev)
    sub, draws = aug.sample_grouped(torch.tensor([0, 9], device=dev), 128, applier.groups,
                                    applier.num_sub, applier.num_op, 32, 32)
    aug.apply_subpolicy_draws(x, applier.policy, sub, draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof1:
        prime_profiler(dev)
        for _ in range(APPLY_CALLS):
            aug.apply_subpolicy_draws(x, applier.policy, sub, draws)
        torch.cuda.synchronize()
    alone = {k: v for k, v in device_kernel_counts(prof1).items() if "empty_kernel" not in k}
    # the same two calls captured: every node of their graphs
    keys = torch.tensor([0, 9], dtype=torch.int64, device=dev)
    replay_nodes, replay_launches = graph_census(lambda: applier._step(x, keys, 128))
    alone_nodes, alone_launches = graph_census(
        lambda: aug.apply_subpolicy_draws(x, applier.policy, sub, draws))
    out = {"phase": "trace", "card": card, "calls": 20, "batch": 128, "image": 32,
           "wall_ms_per_call": wall_s * 1e3 / 20,
           "device_busy_ms_per_call": busy_us / 1e3 / 20 if busy_us else None,
           "device_idle_share": (1 - busy_us / 1e6 / wall_s) if busy_us else None,
           "device_kernels": len(by_name), "priming": priming_kept(prof, priming),
           "device_kernels_per_call": sum(kernels.values()) / 20,
           "kernels_per_call": {k[:80]: v / 20 for k, v in kernels.items()},
           "augment_kernel_us_per_call": device_us(prof, K1_KERNELS) / 20,
           "top_device_us_per_call": {k[:80]: v / 20 for k, v in top},
           "apply_subpolicy_draws_kernels_per_call": {k[:80]: v / APPLY_CALLS
                                                      for k, v in alone.items()},
           "graph_census": {"serving_step_128": {"nodes": replay_nodes,
                                                 "launches": replay_launches},
                            "apply_subpolicy_draws_128": {"nodes": alone_nodes,
                                                          "launches": alone_launches}},
           "census": "the serving step (PolicyApplier._step: the grouped draws, then the "
                     "policy) and one apply_subpolicy_draws call, each captured in a CUDA "
                     "graph: its nodes by type (libcuda) and the wrappers' launches"}
    emit(out)
    # the graphed call holds K7 (the grouped draws) and K1, one each, and
    # nothing else; apply_subpolicy_draws alone, K1 and nothing else.  The
    # profiles may drop records, never add them: they must show no other
    # kernel and no more than one of each a call
    problems = []
    if replay_nodes != {"kernel": 2} or replay_launches != {"sampler": 1, "augment": 1}:
        problems.append(f"the serving step's graph holds {replay_nodes} from "
                        f"{replay_launches}, not K7 and K1")
    if alone_nodes != {"kernel": 1} or alone_launches != {"augment": 1}:
        problems.append(f"apply_subpolicy_draws's graph holds {alone_nodes} from "
                        f"{alone_launches}, not K1 alone")
    for name, part in (("K7", "grouped_kernel"), ("K1", "augment_kernel")):
        n = sum(v for k, v in kernels.items() if part in k)
        if n > 20:
            problems.append(f"the graphed serving call ran {name} {n} times in 20 calls")
    others = [k for k in kernels if "grouped_kernel" not in k and "augment_kernel" not in k]
    if others:
        problems.append(f"the graphed serving call ran other kernels: {others[:8]}")
    foreign = [k for k in alone if "augment_kernel" not in k]
    if foreign or sum(alone.values()) > APPLY_CALLS:
        problems.append(f"{APPLY_CALLS} apply_subpolicy_draws calls ran {alone}")
    if problems:
        fail("trace: " + "; ".join(problems))
    return out


# ------------------------------------------------------------ TTA path

TTA_FIELDS = ("minus_loss", "top1_valid", "top1_mean", "cnt")
#: stages of the TTA step (its torch.profiler ranges, search/tta.py)
TTA_STAGES = ("tta.sampler", "tta.augment", "tta.model", "tta.reductions")
TRACE_BATCHES = 8


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


def _eager(step):
    """`step` with its fold sums run eagerly on the card (``search/tta.py
    _eager_sums``): the reference the graph replays are held against, and
    the only way to run an `augment_fn` that reads values on the host (the
    kernels' plain versions)."""
    import functools
    import types

    from fast_autoaugment_tpu_torch.search import tta

    return types.SimpleNamespace(sums=functools.partial(tta._eager_sums, step))


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

    # each of the four fold passes replays one CUDA graph a batch after one
    # warm-up call (the capture's launches count at each replay); the audit
    # step is called once, eagerly, with its key (no fold_in)
    calls = 4 * (n_batches + 1) + 1
    per_call = _kernels.augment_plan(32, 32, c["num_op"]).launches
    want = {"augment": per_call * calls, "cifar_stack": calls, "imagenet_stack": 0,
            "sampler": TTA_CALL_SAMPLER * calls - 1, "train_noise": 0}
    if launches_differ(counts, want):
        fail(f"TTA launch counts {counts} != {want} ({calls} step calls)")
    for tag, r in [("exact", exact), ("baseline", baseline), ("grouped", grouped)] + \
            [(f"batched[{k}]", r) for k, r in enumerate(batched)]:
        _check_fields(tag, r, float(c["fold_images"]))
    if audit_out["cnt"] != c["batch"] or len(audit_out["correct_mean_sum"]) != c["num_policy"]:
        fail(f"audit step output is malformed: {audit_out}")

    # kernels against their plain versions on the card: the same step, run
    # eagerly (the plain versions read values on the host: no graph), the
    # same draws and weights; lanes bitwise, fields equal under deterministic cuDNN
    keep = (0, n_batches - 1)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        fns = {"kernel": _Capture(tta.cifar_augment_fn(c["cutout"]), keep),
               "plain": _Capture(_plain_augment(c["cutout"]), keep)}
        res = {k: tta.eval_tta(_eager(tta.make_tta_step(model, augment_fn=fn, **opts)),
                               batches, st["policy"], st["key"]) for k, fn in fns.items()}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    lanes_diff = sum(int((fns["kernel"].out[i] != fns["plain"].out[i]).sum()) for i in keep)
    lanes_err = max(float((fns["kernel"].out[i] - fns["plain"].out[i]).abs().max()) for i in keep)
    if lanes_diff or res["kernel"] != res["plain"]:
        fail(f"TTA step with kernels vs plain versions: {lanes_diff} lane elements differ, "
             f"fields {res}")

    # batched candidates against eval_tta of that candidate alone: the
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


#: timed trials of each arm of phase_tta_graphs (2 before the ImageNet
#: phase joined the script)
ARM_TRIALS = 1


def _tta_arm(dev, st: dict, step, tag: str) -> tuple[dict, object, list]:
    """One arm of :func:`phase_tta_graphs`: timed trials of `step` over the
    fold (the first call, and so a graph's capture, before them), then a
    profiled ``eval_tta`` over the fold's first :data:`TRACE_BATCHES`
    batches: the device's busy time (the union of its activities), its idle
    share over the traced wall, the runtime calls that put work on the card,
    per batch, and K1's and K5's kernel records against the launch counters
    over the stretch.  Returns the arm, the profile and the problems."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.search import tta

    batches = st["batches"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = tta.eval_tta(step, batches[:1], st["policy"], torch.tensor([3, 0], device=dev))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    trials, fields = [], []
    for i in range(ARM_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fields.append(tta.eval_tta(step, batches, st["policy"], torch.tensor([1, i], device=dev)))
        torch.cuda.synchronize()
        trials.append(time.perf_counter() - t0)
    s_trial = float(np.median(trials))
    traced = batches[:TRACE_BATCHES]
    torch.cuda.synchronize()
    before = _kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tta.eval_tta(step, traced, st["policy"], torch.tensor([2, 0], device=dev))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    counted = counts_since(before)
    records, problems = records_vs_counters(
        prof, counted, _kernels.augment_plan(32, 32, FLAGSHIP["num_op"]).kernel, f"{tag} arm")
    busy = device_busy(prof)
    n = len(traced)
    calls = _host_launches(prof)
    return {"arm": tag, "first_call_1_batch_s": first_s, "first_call_fields": first,
            "seconds_per_trial": s_trial, "trial_seconds": trials, "trial_fields": fields,
            "images_per_s": FLAGSHIP["num_policy"] * FLAGSHIP["fold_images"] / s_trial,
            "trace": {"batches": n, "wall_s": wall_s,
                      "host_runtime_calls_per_batch": sum(calls.values()) / n,
                      "host_runtime_calls_by_name": calls,
                      "device_busy_ms_per_batch": busy["union_us"] / 1e3 / n,
                      "device_idle_share": 1 - busy["union_us"] / 1e6 / wall_s,
                      "device_activities_per_batch": busy["activities"] / n,
                      "kernel_records": records, "launches_counted": counted}}, prof, problems


def phase_tta_graphs(dev, st: dict, card: str) -> dict:
    """``search_runtime_main_path`` (a): the flagship TTA trial (WRN-40-2,
    the seeded 20,000-image fold, P = 5, batch 128) with the step replayed
    as one CUDA graph a batch against the same step run eagerly, both under
    deterministic cuDNN: at K = 1 and K = 4 (``eval_tta_batched``) the
    fields over the fold are equal bitwise; per arm the seconds per trial,
    the host's runtime calls, the device's busy time and idle share per
    batch (a traced stretch of :data:`TRACE_BATCHES` batches, in which K1's
    and K5's kernel records must match the launch counters, and so does a
    traced stretch of the K = 4 graph) and the first call's seconds (the
    capture, for the graph); the graph census equals one graph per step and
    policy shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.core import compilecache
    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.search import census, tta

    c = FLAGSHIP
    model, batches = st["model"], st["batches"]
    opts = dict(num_policy=c["num_policy"], cutout_length=c["cutout"])
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    arms, problems = {}, []
    _kernels.reset_launch_counts()
    try:
        step_g = tta.make_tta_step(model, **opts)
        seam0 = compilecache.compile_cache_stats()["labels"].get("tta", {}).get("sec", 0.0)
        arms["graph"], _, found = _tta_arm(dev, st, step_g, "graph")
        problems += found
        arms["graph"]["capture_s"] = \
            compilecache.compile_cache_stats()["labels"]["tta"]["sec"] - seam0
        arms["eager"], eager_prof, found = _tta_arm(
            dev, st, _eager(tta.make_tta_step(model, **opts)), "eager")
        problems += found
        # the trials of each arm drew the same keys: fields bitwise
        fields = {k: arms[k]["trial_fields"] for k in arms}
        step_kg = tta.make_tta_step(model, num_candidates=4, **opts)
        k4, k4_s = {}, {}
        for k, s in (("graph", step_kg), ("eager", _eager(tta.make_tta_step(
                model, num_candidates=4, **opts)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k4[k] = tta.eval_tta_batched(s, batches, st["candidates"], st["keys"])
            torch.cuda.synchronize()
            k4_s[k] = time.perf_counter() - t0
        # the K = 4 graph's replays, traced: its records against the counters
        before = _kernels.launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tta.eval_tta_batched(step_kg, batches[:TRACE_BATCHES], st["candidates"], st["keys"])
            torch.cuda.synchronize()
        k4_counted = counts_since(before)
        k4_records, found = records_vs_counters(
            prof, k4_counted, _kernels.augment_plan(32, 32, c["num_op"]).kernel, "K = 4 graph")
        problems += found
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    counts = _kernels.launch_counts()
    # step calls: per arm a 1-batch first call, the trials and the traced
    # stretch; the graph arms add a warm-up call per capture; then K = 4 over
    # the fold both ways, and its graph's traced stretch
    n = len(batches)
    calls = 2 * (1 + ARM_TRIALS * n + TRACE_BATCHES) + 1 + 2 * n + 1 + TRACE_BATCHES
    want = {"augment": _kernels.augment_plan(32, 32, c["num_op"]).launches * calls,
            "cifar_stack": calls, "imagenet_stack": 0, "sampler": TTA_CALL_SAMPLER * calls,
            "train_noise": 0}
    if launches_differ(counts, want):
        problems.append(f"launch counts {counts} != {want} ({calls} step calls)")
    if fields["graph"] != fields["eager"]:
        problems.append(f"K = 1 fields graph {fields['graph']} != eager {fields['eager']}")
    if k4["graph"] != k4["eager"]:
        problems.append(f"K = 4 fields graph {k4['graph']} != eager {k4['eager']}")
    graphs = {"tta": census.executable_census(step_g),
              "tta_batched": census.executable_census(step_kg)}
    want_graphs = {"tta": 1, "tta_batched": 1}
    # the launches each graph recorded: the batch key's fold_in, the draw
    # keys' split and the record are K7's three, then K1 and K5
    held = {name: {k: v for k, v in tally.items() if v}
            for name, s in (("tta", step_g), ("tta_batched", step_kg))
            for sums in s._graphs.values() for _, _, tally in sums.graphs.values()}
    if any(h.get("sampler") != 3 for h in held.values()):
        problems.append(f"TTA graphs hold {held}, not 3 sampler launches each")
    if graphs != want_graphs:
        problems.append(f"graph census {graphs} != {want_graphs}")
    if problems:
        fail("search_runtime_main_path (a): " + "; ".join(problems))
    out = {"phase": "search_runtime_main_path", "part": "tta_graphs", "card": card,
           "model": c["model"], "fold_images": c["fold_images"], "batch": c["batch"],
           "num_policy": c["num_policy"], "batches": len(batches),
           "arms": arms, "fields_equal_k1": True,
           "fields_equal_k4": True, "k4_seconds_per_trial": k4_s,
           "k4_graph_trace": {"batches": TRACE_BATCHES, "kernel_records": k4_records,
                              "launches_counted": k4_counted},
           "graph_census": graphs, "graph_census_expected": want_graphs,
           "graph_launches": held, "launches": counts, "expected_launches": want,
           "timing": "host clock around eval_tta over the fold, synchronized, deterministic "
                     f"cuDNN, median of {ARM_TRIALS}; traced stretch: torch.profiler, device busy = the "
                     "union of the device's activities, idle = 1 - busy / the same stretch's "
                     "wall; kernel_records: K1's and K5's kernels in that trace, held against "
                     "the launch counters' increase over it (launches_counted); capture_s: "
                     "the graph's first call through the compile seam (warm-up and capture)"}
    emit(out)
    return dict(out, eager_prof=eager_prof)


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
        out["gate_off" if op is None else aug.OP_NAMES[op]] = graph_ms(
            lambda: _kernels.augment(x, pol, sub, draws))
    return out


def phase_tta_times(dev, st: dict, card: str, graphs: dict) -> dict:
    """Seconds per trial of the eager step and its trace split by stage
    (both measured by :func:`phase_tta_graphs`), and both kernels at the TTA
    shape."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess as pre
    from fast_autoaugment_tpu_torch.search import tta

    c = FLAGSHIP
    batches, p = st["batches"], c["num_policy"]
    # the eager step's trial times and trace, from the graphs phase
    eager = graphs["arms"]["eager"]
    trials, s_trial = eager["trial_seconds"], eager["seconds_per_trial"]

    # both kernels at the step's shape: P x B = 640 lanes of 32x32
    x = batches[0]["x"].to(torch.float32).repeat(p, 1, 1, 1).contiguous()
    pol = torch.as_tensor(st["policy"], device=dev)
    src = tta.PhiloxDraws()
    d = src.draws(src.split(st["key"], p, dev), batch=c["batch"], num_sub=pol.shape[0],
                  num_op=pol.shape[1], height=32, width=32, dispatch="exact", groups=8,
                  device=dev)
    call = lambda: _kernels.augment(x, pol, d.sub_idx, d.policy)  # noqa: E731
    y = call()
    elems = x.numel()
    plan = _kernels.augment_plan(32, 32, int(pol.shape[1]))
    k1 = {"kernel": "augment", "shape": list(x.shape), "num_op": int(pol.shape[1]),
          "launches_per_call": plan.launches, "cluster": plan.cluster,
          "kernel_ms": kernel_device_ms(call, kernel=plan.kernel, per_call=plan.launches),
          "kernel_event_ms": cuda_ms(call),
          "kernel_graph_ms": graph_ms(call),
          "plain_ms": cuda_ms(lambda: aug.apply_subpolicy_draws_plain(x, pol, d.sub_idx, d.policy),
                              iters=5, warmup=1),
          "bytes": k1_bytes(x, pol),
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

    prof, wall_s = graphs["eager_prof"], eager["trace"]["wall_s"]
    t_post = time.perf_counter()
    by_name = kernel_device_us(prof)
    busy_us = sum(v for k, v in by_name.items() if not k.startswith("tta."))
    stages = _stage_device_us(prof)
    k1_us, k5_us = device_us(prof, K1_KERNELS), device_us(prof, "cifar_stack_kernel")
    n = TRACE_BATCHES
    # K1, K5 and K7 are launched through ctypes, outside the ranges' torch
    # operators, so no range holds them (the tta.sampler range read 0 with
    # K7 inside it): the sampler stage is its range's work and K7's kernels
    # by name, augment_other the tta.augment range's work
    k7_us = device_us(prof, SAMPLER_KERNELS)
    split_ms = {"sampler": stages["tta.sampler"] + k7_us,
                "sampler_kernels_K7": k7_us, "augment_kernel_K1": k1_us,
                "cifar_stack_kernel_K5": k5_us,
                "augment_other": stages["tta.augment"],
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
           "timing": "seconds_per_trial: median of 2 eval_tta of the eager step over the fold "
                     "(phase_tta_graphs), host clock, synchronized, deterministic cuDNN; "
                     "kernel_ms: device time from torch.profiler over 20 calls; "
                     "kernel_graph_ms and by_op_graph_ms: CUDA-graph replay; "
                     "*_event_ms and plain_ms: CUDA events around back-to-back calls, host "
                     "gaps included; the trace runs with the profiler on (host time inflated), "
                     "device_idle_share_at_trial_wall sets its device time per batch against "
                     "the unprofiled trial's wall per batch"}
    emit(out)
    return out


# ------------------------------------------------- lighting normals

# ------------------------------------------------ K7 and K8 against plain

#: the H100 SXM's int32 rate: 64 INT32 lanes an SM x 132 SMs x the 1,980 MHz
#: boost clock (the Hopper architecture white paper)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
#: int32 operations of one Philox4x32-10 block: 10 rounds of 2 products
#: (hi and lo each), 4 xors and 2 key increments; and of one compare of a
#: stable sort of words (two compares, the word's and the index's, and a select)
PHILOX_OPS, COMPARE_OPS = 100, 3
#: the sampler's shapes on the main path: exact lanes of serving (32x32 and
#: 224x224), the grouped serving call, the TTA step's 5 draw keys x 128
#: lanes, the ImageNet train step's 128 lanes at 224x224
SAMPLER_EXACT = ((1, 32), (8, 32), (32, 32), (128, 32), (1, 224), (8, 224))
SAMPLER_PERMS = (1, 64, 128, 4096)
BETA_DRAWS = 4096


def _bits_differ(a, b) -> tuple[int, float]:
    """Differing elements (float bits, ints, bools) and the largest absolute
    difference of two results (tensors, or tuples and lists of them)."""
    import torch

    if isinstance(a, (tuple, list)):
        pairs = [_bits_differ(x, y) for x, y in zip(a, b)]
        return sum(p[0] for p in pairs), max((p[1] for p in pairs), default=0.0)
    if a is None or b is None:
        return (0 if a is None and b is None else 1), 0.0
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel(), 1), float("inf")
    if a.dtype in (torch.float32, torch.float64):
        bits = torch.int32 if a.dtype == torch.float32 else torch.int64
        n = int((a.view(bits) != b.view(bits)).sum())
        err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        return n, err
    return int((a != b).sum()), float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def _draw_fields(d) -> tuple:
    """The tensors of a LaneDraws, ImageNetDraws or ModelNoise, in order."""
    import dataclasses

    if hasattr(d, "tensors"):
        return tuple(t for ts in d.tensors for t in ts)
    return tuple(getattr(d, f.name) for f in dataclasses.fields(d))


def _sort_compares(n: int) -> int:
    """Compares of a sort of n words: n ceil(log2 n)."""
    return n * math.ceil(math.log2(n)) if n > 1 else 0


def _sampler_bound(blocks: float, compares: float, nbytes: float) -> dict:
    """The least time of a draw call: its bytes in and out at the memory
    rate, or its Philox and sort work at the int32 rate, the larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (blocks * PHILOX_OPS + compares * COMPARE_OPS) / INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "philox_blocks": blocks, "sort_compares": compares,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _mixup_plain(keys, alpha: float, num: int) -> tuple:
    """The plain mixup draws of each key of ``keys [N, 2]``
    (``search/tta.py mixup_draws_plain``): float32 Betas from ``split(key,
    2)[0]`` and, with `num`, the first key's permutation of `num` from its
    ``split(key, 2)[1]``."""
    import torch

    from fast_autoaugment_tpu_torch.ops import rng

    pair = rng.split_plain(keys, 2)
    lam = rng.beta_symmetric(pair[:, 0], alpha).to(torch.float32)
    return (lam, rng.permutation(pair[0, 1], num)) if num else (lam,)


def _mixup_draws(keys, alpha: float, num: int) -> tuple:
    """:func:`_mixup_plain`'s draws by one K8 launch on the card (the
    train-noise kernel's mixup keys), by the plain version on the CPU."""
    from fast_autoaugment_tpu_torch.ops import _kernels, rng

    if keys.device.type == "cpu":
        return _mixup_plain(keys, alpha, num)
    out = _kernels.train_noise(mix_keys=keys, perm_n=num, gamma=rng.gamma_constants(alpha))
    return (out["lam"], out["perm"]) if num else (out["lam"],)


def _noise_fns(src, sites, batch: int, alpha: float) -> tuple:
    """One train step's noise and mixup draws (``PhiloxDraws.train_draws``:
    one K8 launch on the card) and their plain version, as flat tuples."""
    from fast_autoaugment_tpu_torch.ops.shake import ModelNoise
    from fast_autoaugment_tpu_torch.search import tta

    def kernel(k, d):
        noise, lam, perm = src.train_draws(sites, batch, k[0], k[1], k[2], alpha, d)
        return _draw_fields(noise) + ((lam, perm) if alpha else ())

    def plain(k, d):
        noise = ModelNoise.draw_plain(sites, batch, k[0], k[1])
        return _draw_fields(noise) + (tta.mixup_draws_plain(k[2], batch, alpha) if alpha else ())

    return kernel, plain


def _step_fields(d) -> tuple:
    """The tensors of a ``StepDraws``, in order (None where a draw is absent)."""
    return ((d.key_aug, d.lam, d.perm) + (_draw_fields(d.draws) if d.draws is not None else ())
            + (_draw_fields(d.noise) if d.noise is not None else ()))


#: the step counter of the timed train-step draws: above 2^32, exact in float64
STEP_DRAWS_STEP = 2**33 + 5


def _step_draws_fns(src, sites, batch: int, alpha: float, imagenet: bool, num_sub: int):
    """Every draw of one train step (``PhiloxDraws.step_draws``: the key
    chain, the augment stack's record, exact dispatch and 2 slots, the noise
    and mixup) from a key ``[1, 2]`` at step :data:`STEP_DRAWS_STEP`: the one
    launch, the parent's chain of K7 and K8 launches (``tta.step_draws``
    over ``PhiloxDraws``' own calls) and the plain versions, each as a flat
    tuple of tensors."""
    import torch

    from fast_autoaugment_tpu_torch.ops import rng
    from fast_autoaugment_tpu_torch.ops.shake import ModelNoise, noise_layout
    from fast_autoaugment_tpu_torch.search import tta

    hw = 224 if imagenet else 32
    record = tta.DrawRecord(imagenet, batch, hw, hw, (num_sub, 2), "exact", 8)
    kw = dict(sites=sites, batch=batch, alpha=alpha, record=record)
    layout = noise_layout(sites, batch) if sites else None
    made: dict = {}  # the step's scalars on each device, made at the first (uncaptured) call

    def scalars(d):
        if str(d) not in made:
            made[str(d)] = torch.tensor([float(STEP_DRAWS_STEP), 0.1, 0.0, 1.0],
                                        dtype=torch.float64, device=d)
        return made[str(d)]

    def one(k, d):
        return _step_fields(src.step_draws(k[0], scalars(d), layout=layout, **kw))

    def chain(k, d):
        return _step_fields(tta.step_draws(src, k[0], scalars(d), **kw))

    def plain(k, d):
        key_aug, key_model = rng.split_plain(
            rng.fold_in_plain(k[0], scalars(d)[0].to(torch.int64)), 2)
        noise = lam = perm = None
        if sites or alpha:
            km, ks, kd = rng.split_plain(key_model, 3)
            noise = ModelNoise.draw_plain(sites, batch, ks, kd) if sites else None
            lam, perm = tta.mixup_draws_plain(km, batch, alpha) if alpha else (None, None)
        lanes = key_aug.reshape(1, 2)
        draws = (tta.imagenet_draws_plain(lanes, batch, (num_sub, 2), hw, hw, False, 8)
                 if imagenet else tta.lane_draws_plain(lanes, batch, num_sub, 2, hw, hw, False, 8))
        return _step_fields(tta.StepDraws(key_aug, draws, noise, lam, perm))

    return one, chain, plain


def _step_draws_bound(lay, batch: int, alpha: float, imagenet: bool, num_op: int = 2) -> dict:
    """:func:`_sampler_bound` of one train step's draws: the key chain's
    Philox blocks (fold_in, the two halves of the step key's split, the
    model key's three), a fold_in a noise site and a block an item, mixup's
    (the splits of the mix key and of key_lam, a candidate each Gamma, the
    permutation's words and its sort), and the exact record's blocks a lane
    (its key, the sub-policy, the slots, the crop's 2 or ImageNet's 3);
    bytes: the key, the counter, key_aug, the packed noise, lam and the
    permutation, the record."""
    noisy = lay is not None or alpha > 0
    blocks = 1 + 2 + (3 if noisy else 0)
    if lay is not None:
        blocks += lay.count + lay.items
    if alpha:
        blocks += 2 + 2 + 2 + batch
    blocks += batch * (1 + 1 + num_op + (3 if imagenet else 2))
    nbytes = (16 + 8 + 16 + (lay.nbytes if lay is not None else 0)
              + (4 + 8 * batch if alpha else 0)
              + batch * (4 + 16 * num_op + (40 if imagenet else 20)))
    return _sampler_bound(blocks, _sort_compares(batch) if alpha else 0, nbytes)


def phase_sampler_vs_plain(dev) -> dict:
    """K7 (``sampler``) and K8 (``train_noise``) against their plain versions
    on the card and against the CPU, bitwise, at the main path's shapes; one
    launch a call; their times by CUDA-graph replay beside the plain
    versions' (CUDA events) and their bounds."""
    import torch

    from fast_autoaugment_tpu_torch.core.config import load_config
    from fast_autoaugment_tpu_torch.models import get_model, num_class
    from fast_autoaugment_tpu_torch.ops import _kernels, rng
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops.shake import noise_layout, noise_sites
    from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
    from fast_autoaugment_tpu_torch.search import tta

    g = np.random.default_rng(12)
    cpu = torch.device("cpu")
    src = tta.PhiloxDraws()
    cifar_sub = policy_to_tensor(load_policy("fa_reduced_cifar10")).shape[0]
    inet_sub = policy_to_tensor(load_policy("fa_resnet50_rimagenet")).shape[0]

    def keys(n):
        return torch.from_numpy(g.integers(0, 2**32, (n, 2), dtype=np.int64))

    cases = {}  # name: (kernel, fn(keys, dev) on the public path, plain fn(keys, dev), keys)
    for lanes, hw in SAMPLER_EXACT:
        ns = cifar_sub if hw == 32 else inet_sub
        cases[f"exact_{lanes}x{hw}"] = (
            "sampler", lambda k, d, hw=hw, ns=ns: aug.sample_exact(k, ns, 2, hw, hw),
            lambda k, d, hw=hw, ns=ns: aug.sample_exact_plain(k, ns, 2, hw, hw), keys(lanes))
    cases["grouped_128x32_g8"] = (
        "sampler", lambda k, d: aug.sample_grouped(k[0], 128, 8, cifar_sub, 2, 32, 32),
        lambda k, d: aug.sample_grouped_plain(k[0], 128, 8, cifar_sub, 2, 32, 32), keys(1))
    # the game days' serving call: 8 images of 8x8 under their generated
    # single-sub policies (exact dispatch, serve_cli's "auto"), and grouped
    cases["gameday_exact_8x8_1sub"] = (
        "sampler", lambda k, d: aug.sample_exact(k, 1, 2, 8, 8),
        lambda k, d: aug.sample_exact_plain(k, 1, 2, 8, 8), keys(8))
    cases["gameday_grouped_8x8_g8"] = (
        "sampler", lambda k, d: aug.sample_grouped(k[0], 8, 8, cifar_sub, 2, 8, 8),
        lambda k, d: aug.sample_grouped_plain(k[0], 8, 8, cifar_sub, 2, 8, 8), keys(1))
    for num_op in (1, 2, 3):
        for dispatch in ("exact", "grouped"):
            kw = dict(batch=128, num_sub=cifar_sub, num_op=num_op, height=32, width=32,
                      groups=8)
            cases[f"tta_5x128_op{num_op}_{dispatch}"] = (
                "sampler", lambda k, d, kw=kw, dispatch=dispatch: _draw_fields(
                    src.draws(k, dispatch=dispatch, device=d, **kw)),
                lambda k, d, kw=kw, dispatch=dispatch: _draw_fields(tta.lane_draws_plain(
                    k, kw["batch"], kw["num_sub"], kw["num_op"], 32, 32, dispatch == "grouped",
                    8)), keys(5))
    for dispatch in ("exact", "grouped"):
        cases[f"imagenet_128x224_{dispatch}"] = (
            "sampler", lambda k, d, dispatch=dispatch: _draw_fields(src.imagenet_draws(
                k[0], batch=128, policy_shape=(inet_sub, 2), height=224, width=224,
                dispatch=dispatch, groups=8, device=d)),
            lambda k, d, dispatch=dispatch: _draw_fields(tta.imagenet_draws_plain(
                k[:1], 128, (inet_sub, 2), 224, 224, dispatch == "grouped", 8)), keys(1))
    zoo = {}
    for name, path, overrides in ZOO:
        conf = load_config(os.path.join(REPO, path), overrides=overrides)
        model = get_model(dict(conf["model"], dataset=conf["dataset"]),
                          num_class(conf["dataset"]), device="meta")
        sites, b = noise_sites(model), int(conf["batch"])
        alpha = float(conf.get("mixup", 0) or 0)
        zoo[name] = (sites, b, alpha, conf["dataset"].endswith("imagenet"))
        cases[f"noise_{name}"] = ("train_noise", *_noise_fns(src, sites, b, alpha), keys(3))
    # mixup's draws of N keys in one launch: N Betas, the first key's
    # permutation of n
    cases[f"beta_{BETA_DRAWS}_0.2"] = (
        "train_noise", lambda k, d: _mixup_draws(k, 0.2, 0),
        lambda k, d: _mixup_plain(k, 0.2, 0), keys(BETA_DRAWS))
    for n in SAMPLER_PERMS:
        cases[f"permutation_{n}"] = ("train_noise", lambda k, d, n=n: _mixup_draws(k, 0.2, n),
                                     lambda k, d, n=n: _mixup_plain(k, 0.2, n), keys(1))
    cases["key_entry"] = (
        "sampler", lambda k, d: (rng.fold_in(k[0], torch.tensor(2**33 + 5, device=d)),
                                 rng.split(k, 5), rng.fold_in_range(k[1], 90),
                                 *rng.blocks(k[:3], 128, 9)),
        lambda k, d: (rng.fold_in_plain(k[0], torch.tensor(2**33 + 5, device=d)),
                      rng.split_plain(k, 5), rng.fold_in_range_plain(k[1], 90),
                      *rng.blocks_plain(k[:3], 128, 9)), keys(5))

    rows, problems = {}, []
    totals = {"sampler": [0, 0, 0.0], "train_noise": [0, 0, 0.0]}  # vs plain, vs CPU, err
    for name, (kernel, fn, plain, k) in cases.items():
        kd = k.to(dev)
        before = _kernels.launch_counts()[kernel]
        card = fn(kd, dev)
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()[kernel] - before
        on_card = plain(kd, dev)
        host = fn(k, cpu)
        n_plain, err_plain = _bits_differ(card, on_card)
        n_cpu, err_cpu = _bits_differ(card, host)
        # keys_kernel runs once for each of the four key helpers of the case
        want = 4 if name == "key_entry" else 1
        rows[name] = {"kernel": kernel, "launches": launches, "differing_vs_plain": n_plain,
                      "differing_vs_cpu": n_cpu, "max_abs_err": max(err_plain, err_cpu)}
        totals[kernel][0] += n_plain
        totals[kernel][1] += n_cpu
        totals[kernel][2] = max(totals[kernel][2], err_plain, err_cpu)
        if n_plain or n_cpu or launches != want:
            problems.append(f"{name}: {rows[name]}")

    # times: the kernel by graph replay, the plain version on the card by
    # CUDA events, at the serving, TTA and train shapes
    def timed(kernel, fn, plain, k, bound):
        kd = k.to(dev)
        before = _kernels.launch_counts()
        fn(kd, dev)
        launches = {n: v for n, v in counts_since(before).items() if v}
        return {"kernel": kernel, "ms": graph_ms(lambda: fn(kd, dev), iters=20, replays=5),
                "ms_source": "graph", "plain_ms": cuda_ms(lambda: plain(kd, dev), iters=5,
                                                          warmup=1),
                "launches_per_call": launches, **bound}

    # the bounds count the work each function needs, not the kernels': a
    # Philox block for each block of words it uses (the grouped sampler's
    # min(groups, B) chunk picks, not the kernel's one a lane), one
    # candidate a Gamma (the least a Beta needs), and n ceil(log2 n)
    # compares for a stable sort of n words (the kernel counts n^2 ranks)
    rec = lambda lanes, num_op, extra: lanes * (4 + 16 * num_op) + extra  # noqa: E731
    b, d, chunks = 128, 5, 8
    times = {
        "serve_grouped_128x32": timed(*cases["grouped_128x32_g8"][:3], keys(1), _sampler_bound(
            b * (1 + 2) + chunks, _sort_compares(b), 16 + rec(b, 2, 0))),
        "serve_exact_128x32": timed(*cases["exact_128x32"][:3], keys(128), _sampler_bound(
            b * (1 + 2), 0, 16 * b + rec(b, 2, 0))),
        "tta_5x128_exact": timed(*cases["tta_5x128_op2_exact"][:3], keys(d), _sampler_bound(
            d * b * (1 + 1 + 2 + 2), 0, 16 * d + rec(d * b, 2, 20 * d * b))),
        "tta_5x128_grouped": timed(*cases["tta_5x128_op2_grouped"][:3], keys(d), _sampler_bound(
            d * (b * (1 + 1 + 2 + 2) + chunks), d * _sort_compares(b),
            16 * d + rec(d * b, 2, 20 * d * b))),
        "imagenet_128x224_exact": timed(*cases["imagenet_128x224_exact"][:3], keys(1),
                                        _sampler_bound(b * (1 + 3 + 1 + 2), 0,
                                                       16 + rec(b, 2, 40 * b))),
    }
    for name, (sites, nb, alpha, _) in zoo.items():
        lay = noise_layout(sites, nb)
        # a fold_in a site, a block an item; mixup: split(mix key, 2), split(key_lam, 2),
        # a candidate of each Gamma, the permutation's words
        blocks = len(sites) + lay.items + (2 + 2 + 2 + nb if alpha else 0)
        times[f"noise_{name}"] = timed(*cases[f"noise_{name}"][:3], keys(3), _sampler_bound(
            blocks, _sort_compares(nb) if alpha else 0,
            48 + lay.nbytes + (4 + 8 * nb if alpha else 0)))
    # where K8 alone spends its time at EfficientNet's step: mixup alone (a
    # Beta's warp, the permutation's block) and the noise sites alone
    sites, nb, alpha, _ = zoo["efficientnet_b0_condconv8"]
    lay = noise_layout(sites, nb)
    times["mixup_efficientnet_b0_condconv8"] = timed(
        "train_noise", lambda k, d: _mixup_draws(k, alpha, nb),
        lambda k, d: _mixup_plain(k, alpha, nb), keys(1),
        _sampler_bound(2 + 2 + 2 + nb, _sort_compares(nb), 16 + 4 + 8 * nb))
    times["noise_efficientnet_b0_condconv8_sites"] = timed(
        "train_noise", *_noise_fns(src, sites, nb, 0.0), keys(3),
        _sampler_bound(len(sites) + lay.items, 0, 32 + lay.nbytes))
    # every draw of one train step (the step's key chain, the noise and
    # mixup, the augment stack's record): the one launch beside the parent's
    # chain of K7 and K8 launches and the plain versions, bitwise, timed in
    # turns (one, chain, chain, one) by graph replay, for the flagship
    # WRN-40-2, each zoo model and ResNet-50
    steps_at = dict(wrn40_2=([], 128, 0.0, False), **zoo,
                    resnet50=([], int(RESNET50["batch"]), 0.0, True))
    for name, (sites, nb, alpha, imagenet) in steps_at.items():
        one, chain, plain = _step_draws_fns(src, sites, nb, alpha, imagenet,
                                            inet_sub if imagenet else cifar_sub)
        k = keys(1)
        kd = k.to(dev)
        before = _kernels.launch_counts()
        got = one(kd, dev)
        torch.cuda.synchronize()
        one_launches = {n: v for n, v in counts_since(before).items() if v}
        before = _kernels.launch_counts()
        ref = chain(kd, dev)
        torch.cuda.synchronize()
        chain_launches = {n: v for n, v in counts_since(before).items() if v}
        n_chain, err_chain = _bits_differ(got, ref)
        n_plain, err_plain = _bits_differ(got, plain(kd, dev))
        n_cpu, err_cpu = _bits_differ(got, one(k, cpu))
        row = timed("train_noise", one, plain, k, _step_draws_bound(
            noise_layout(sites, nb) if sites else None, nb, alpha, imagenet))
        chain_ms = [graph_ms(lambda: chain(kd, dev), iters=20, replays=5) for _ in range(2)]
        row["ms_turns"] = [row["ms"], graph_ms(lambda: one(kd, dev), iters=20, replays=5)]
        row.update(ms=float(np.median(row["ms_turns"])), chain_ms=float(np.median(chain_ms)),
                   chain_ms_turns=chain_ms, chain_launches_per_call=chain_launches,
                   differing_vs_chain=n_chain, differing_vs_plain=n_plain,
                   differing_vs_cpu=n_cpu, max_abs_err=max(err_chain, err_plain, err_cpu))
        times[f"train_step_draws_{name}"] = row
        totals["train_noise"][0] += n_plain + n_chain
        totals["train_noise"][1] += n_cpu
        totals["train_noise"][2] = max(totals["train_noise"][2], row["max_abs_err"])
        if n_chain or n_plain or n_cpu or one_launches != {"train_noise": 1}:
            problems.append(f"train_step_draws_{name}: launches {one_launches}, "
                            f"differing vs chain {n_chain}, plain {n_plain}, CPU {n_cpu}")
    # the floor of any one-launch design: an empty kernel, timed as K7 is
    empty_ms = graph_ms(lambda: _kernels.empty_kernel(dev), iters=20, replays=5)
    out = {"phase": "sampler_vs_plain", "tolerance": "bitwise: 0 differing elements",
           "cases": rows, "times": times, "empty_kernel_graph_ms": empty_ms,
           "sampler": {"differing_vs_plain": totals["sampler"][0],
                       "differing_vs_cpu": totals["sampler"][1],
                       "max_abs_err": totals["sampler"][2]},
           "train_noise": {"differing_vs_plain": totals["train_noise"][0],
                           "differing_vs_cpu": totals["train_noise"][1],
                           "max_abs_err": totals["train_noise"][2]},
           "bound": "max(bytes in and out at 3.35 TB/s, (Philox blocks x 100 + sort compares "
                    "x 3) int32 operations at 64 x 132 x 1.98 GHz), counting the function's "
                    "work: the Philox blocks whose words it uses (min(groups, B) chunk picks, "
                    "one candidate a Gamma) and n ceil(log2 n) compares a sort of n; the "
                    "Box-Muller and Gamma float64 work is left out of the count",
           "timing": "kernel: 20 calls captured in a CUDA graph, replayed 5 times between "
                     "CUDA events; plain: 5 eager calls between CUDA events after 1 warm-up"}
    emit(out)
    if problems:
        fail("sampler_vs_plain: " + "; ".join(problems))
    return out


#: the train steps whose captured graphs `step_draws_census` reads: the
#: flagship WRN-40-2 (no noise sites, no mixup) and Shake-Shake 26 2x96d
#: (noise sites), each at its preset's batch on 32x32 CIFAR batches
CENSUS_STEPS = (("wrn40_2", "confs/wresnet40x2_cifar.yaml"),
                ("shakeshake26_2x96d", "confs/shake26_2x96d_cifar.yaml"))


def phase_step_draws_census(dev) -> dict:
    """The nodes of a captured train step (:func:`graph_census`, kernels by
    name): with ``PhiloxDraws`` one draw kernel node (``step_kernel``) and
    one ``train_noise`` launch; with the parent's chain (``tta.step_draws``
    over ``PhiloxDraws``' calls) 3 or 5 draw kernels and the step counter's
    cast, so the chain's graph holds as many kernel nodes more as it has
    draw kernels."""
    import torch

    from fast_autoaugment_tpu_torch.core.config import load_config
    from fast_autoaugment_tpu_torch.models import get_model, num_class
    from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
    from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
    from fast_autoaugment_tpu_torch.search import tta
    from fast_autoaugment_tpu_torch.train import steps

    class Chain(tta.PhiloxDraws):
        def step_draws(self, *a, **kw):
            return tta.step_draws(self, *a, **kw)

    policy = torch.from_numpy(policy_to_tensor(load_policy("fa_reduced_cifar10"))).to(dev)
    key = torch.tensor([0, 7], device=dev)
    out, problems = {"phase": "step_draws_census"}, []
    for name, path in CENSUS_STEPS:
        conf = load_config(os.path.join(REPO, path))
        classes, b = num_class(conf["dataset"]), int(conf["batch"])
        model = get_model(dict(conf["model"], dataset=conf["dataset"]), classes, device=dev)
        opt = build_optimizer(conf["optimizer"], lambda c: 0.01)
        state = steps.create_train_state(model, opt, use_ema=False)
        g = np.random.default_rng(3)
        x = torch.from_numpy(g.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)).to(dev)
        y = torch.from_numpy(g.integers(0, classes, b)).to(dev)
        arms = {}
        for arm, src in (("one_launch", tta.PhiloxDraws()), ("chain", Chain())):
            body = steps.make_train_step_body(model, opt, num_classes=classes,
                                              cutout_length=int(conf.get("cutout", 0) or 0),
                                              draw_source=src)
            scalars = torch.from_numpy(body.scalars(9, 9)[0]).to(dev)
            types, tally, kernels = graph_census(
                lambda: body(state, x, y, policy, key, scalars), names=True)
            arms[arm] = {"nodes": types, "launches": tally,
                         "draw_kernel_nodes": {k: v for k, v in kernels.items()
                                               if k in DRAW_KERNELS}}
        one, chain = arms["one_launch"], arms["chain"]
        chain_draws = sum(chain["draw_kernel_nodes"].values())
        extra = chain["nodes"].get("kernel", 0) - one["nodes"].get("kernel", 0)
        arms["chain_kernel_nodes_more"] = extra
        out[name] = arms
        if one["draw_kernel_nodes"] != {"step_kernel": 1} \
                or {k: one["launches"].get(k, 0) for k in ("sampler", "train_noise")} \
                != {"sampler": 0, "train_noise": 1}:
            problems.append(f"{name}: the captured step holds {one}")
        if chain_draws not in (3, 5) or extra != chain_draws:
            problems.append(f"{name}: the chain's captured step holds {chain_draws} draw kernels "
                            f"and {extra} kernel nodes more than the one launch's")
        del model, state, opt
    emit(out)
    if problems:
        fail("step_draws_census: " + "; ".join(problems))
    return out


#: keys of the lighting check: 2^20 and an odd remainder
LIGHTING_KEYS = (1 << 20) + 37


def phase_lighting_cpu_vs_card(dev) -> dict:
    """The ImageNet stack's draws (``ops/augment.py sample_imagenet``: flip,
    jitter order, cutout centre, jitter factors and the Box-Muller lighting
    normals) from the same keys by the sampler kernel on the card (K7, one
    launch) and by the plain version on the CPU: ``ints`` and ``floats``
    must be the same bits."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops.augment import sample_imagenet

    n = LIGHTING_KEYS
    keys = torch.stack([torch.full((n,), 11, dtype=torch.int64),
                        torch.arange(n, dtype=torch.int64) * 7919], dim=1)
    t0 = time.perf_counter()
    ints_cpu, floats_cpu = sample_imagenet(keys, 224, 224)
    cpu_s = time.perf_counter() - t0
    keys_card = keys.to(dev)
    before = _kernels.launch_counts()["sampler"]
    t0 = time.perf_counter()
    ints_gpu, floats_gpu = sample_imagenet(keys_card, 224, 224)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = _kernels.launch_counts()["sampler"] - before
    ints_diff = int((ints_gpu.cpu() != ints_cpu).sum())
    bits_diff = int((floats_gpu.cpu().view(torch.int32) != floats_cpu.view(torch.int32)).sum())
    normals_diff = int((floats_gpu.cpu()[:, 3:].view(torch.int32)
                        != floats_cpu[:, 3:].view(torch.int32)).sum())
    out = {"phase": "lighting_cpu_vs_card", "compares": "the sampler kernel (csrc/sampler.cu "
           "lanes_kernel) on the card with the plain version on the CPU",
           "kernel_launches": launches, "keys": n, "ints_differing": ints_diff,
           "float_bits_differing": bits_diff, "normal_bits_differing": normals_diff,
           "normals_std": float(floats_cpu[:, 3:].std()), "cpu_s": cpu_s, "card_s": card_s}
    emit(out)
    if ints_diff or bits_diff or launches != 1:
        fail(f"ImageNet draws differ between the CPU and the card, or took other than one "
             f"kernel launch: {out}")
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
    """The log lines of `names` (the search's by default) while a block
    runs, with the times they came."""

    def __init__(self, *names):
        self.names = names or ("faa_torch.search", "faa_torch.search_cli")

    def __enter__(self):
        import logging

        self.lines: list[str] = []
        self.times: list[float] = []
        self.handler = logging.Handler()

        def keep(record):
            self.times.append(time.time())
            self.lines.append(record.getMessage())

        self.handler.emit = keep
        self.loggers = [logging.getLogger(n) for n in self.names]
        for lg in self.loggers:
            lg.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        for lg in self.loggers:
            lg.removeHandler(self.handler)

    def count(self, part: str) -> int:
        return sum(part in line for line in self.lines)

    def first(self, *parts) -> tuple[float, str] | None:
        """The first line holding every one of `parts`, with its time."""
        return next(((t, m) for t, m in zip(list(self.times), list(self.lines))
                     if all(p in m for p in parts)), None)


def _search_argv(save_dir: str, epochs: int, until: int = 3, extra=()) -> list[str]:
    flags = list(SEARCH_FLAGS) + list(extra)
    flags[flags.index("--until") + 1] = str(until)
    return (["-c", os.path.join(REPO, SEARCH_CONF), "--save-dir", save_dir] + flags
            + ["dataset=synthetic_shapes", f"epoch={epochs}"])


def _search_expected_launches(epochs: int, audited: int, audit_folds: int,
                              graphed: bool = True) -> dict:
    """K1 and K5 launches of one search run at :data:`SEARCH_FLAGS` on
    ``synthetic_shapes`` (600 train images, 2,000 test; batch 128): phase 1
    trains 2 folds of 360 images (2 steps an epoch, K5 only) and evaluates
    every 5th and the last epoch (2 valid and 16 test batches); phase 2
    scores 2 x 4 trials over 2 padded batches; the audit scores the folds'
    identity baselines (2 x 2 batches), then `audited` sub-policies on the
    `audit_folds` folds that pass its floor (up to 4 through the TTA step,
    one per call; more in chunks of 8 through the audit step); phase 3
    trains 2 arms on 600 images (4 steps an epoch; the
    augmented arm through K1 too) with the test evaluations; each training
    run whose step is a CUDA graph (`graphed`: the device cache's, or the
    host feed's unless ``--host-step eager``) adds the graph's warm-up step,
    and each CUDA graph of phase 2 and the audit one warm-up call.  K7: every
    train step's and TTA or audit call's draws, each trial's key
    (``fold_in(key_fold, trial)``) and, past 4 audited sub-policies, the
    two fold_ins of each audit chunk's key; the flagship draws no K8."""
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
    # each of the 2 fold and 2 phase-3 runs replays one CUDA graph of a step
    # after one warm-up step, unless it steps eagerly
    warm = 1 if graphed else 0
    # phase 2 and the audit replay one CUDA graph a batch: a warm-up call
    # each for the trials' policy shape, the single-sub shape (the
    # baselines, and up to 4 audited sub-policies) and, past 4 audited
    # sub-policies, the audit step's
    tta_warm = 2 + (1 if audited > 4 else 0)
    train_steps = folds * (2 * epochs + warm) + 2 * (phase3_steps + warm)
    key_folds = folds * 4 + (2 * audit_folds * -(-audited // 8) if audited > 4 else 0)
    return {"augment": per_call * (trials + audit_calls + phase3_steps + warm + tta_warm),
            "cifar_stack": phase1 + trials + audit_calls + 2 * (phase3_steps + phase3_evals)
            + 4 * warm + tta_warm, "imagenet_stack": 0,
            "sampler": _step_draw_launches(train_steps)["sampler"]
            + TTA_CALL_SAMPLER * (trials + audit_calls + tta_warm) + key_folds,
            "train_noise": _step_draw_launches(train_steps)["train_noise"]}


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


def phase_search_main_path(dev, workdir: str, card: str, epochs: int = SEARCH_EPOCHS) -> dict:
    """The three-phase search through ``launch/search_cli.py main`` on the
    card (:data:`SEARCH_CONF`, :data:`SEARCH_FLAGS`; the default device
    cache), with the launch counts set to 0 just before and read just after,
    and again with ``--device-cache off --host-step eager``, the eager host
    feed (both under deterministic cuDNN:
    trial log, final policy, audit, every checkpoint's digest and the
    phase-3 values equal); then the checks: all three
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
    # deterministic cuDNN, so that the host-fed arm below can equal this one
    # bit for bit (the graphs capture under it whatever the flags)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _LogLines() as log:
        result = search_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    # ---- the second arm: the same search on the host feed
    save_off = os.path.join(workdir, "search_off")
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    off = search_cli.main(_search_argv(save_off, epochs,
                                       extra=["--device-cache", "off", "--host-step", "eager"]))
    torch.cuda.synchronize()
    off_wall = time.perf_counter() - t0
    off_counts = _kernels.launch_counts()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev

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
    if launches_differ(counts, want):
        problems.append(f"search launch counts {counts} != {want}")
    want_off = _search_expected_launches(epochs, len(audit.get("scores", [])),
                                         len(audit.get("audit_folds", [])), graphed=False)
    if launches_differ(off_counts, want_off):
        problems.append(f"host-fed search launch counts {off_counts} != {want_off}")
    arms_equal = {}
    for name in ("search_trials.json", "final_policy.json", "audit.json"):
        with open(os.path.join(save, name), "rb") as a, open(os.path.join(save_off, name),
                                                             "rb") as b:
            arms_equal[name] = a.read() == b.read()
    for name in sorted(os.listdir(save)):
        if name.endswith(".meta.json"):
            other = os.path.join(save_off, name)
            arms_equal[name] = os.path.exists(other) and \
                _read_json(os.path.join(save, name))["digest"] == _read_json(other)["digest"]
    arms_equal["phase3"] = {a: p3[a]["per_seed"] for a in ("default", "augment")} == \
        {a: off["phase3"][a]["per_seed"] for a in ("default", "augment")}
    arms_equal["stamps"] = (result["device_cache"], off["device_cache"]) == ("auto", "off")
    if not all(arms_equal.values()):
        problems.append("the host-fed search arm differs from the cache arm: "
                        f"{[k for k, v in arms_equal.items() if not v]}")
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
            res = {k: tta.eval_tta(_eager(tta.make_tta_step(ev.model, num_policy=5,
                                                            cutout_length=cutout, augment_fn=fn)),
                                   ev.batches(f), pol, key)
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
    before = _kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rep = search_cli.main(_search_argv(replay, epochs, until=2))
        torch.cuda.synchronize()
    t_post = time.perf_counter()
    # the replay's TTA and audit graphs: their K1 and K5 kernel records
    # against the launch counters, which count a replay from its capture
    rep_counted = counts_since(before)
    rep_records, found = records_vs_counters(
        prof, rep_counted, _kernels.augment_plan(32, 32, 2).kernel, "phase-2 replay")
    if found:
        fail("search_main_path: " + "; ".join(found))
    by_range = _stage_device_us(prof, SEARCH_STAGES)
    # the device's busy time is the union of its activities over the replay
    # (phases 2 and the audit: phase 1 trains nothing): the kernels of a
    # CUDA-graph replay are not attributed to the ranges
    busy_us = device_busy(prof)["union_us"]
    rep_wall = rep["device_secs_phase2"] + rep.get("device_secs_audit", 0.0)
    main_wall = result["device_secs_phase2"] + result.get("device_secs_audit", 0.0)
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
           "phase2_replay_kernel_records": rep_records,
           "phase2_replay_launches_counted": rep_counted,
           "phase2_unprofiled_wall_s": main_wall,
           "device_busy_s_by_range": {k: v / 1e6 for k, v in by_range.items()},
           "expected_launches": want,
           "replay_trial_log_equal": _read_json(os.path.join(replay, "search_trials.json"))
           == trials, "profile_postprocess_s": time.perf_counter() - t_post,
           "host_fed_arm": {"wall_s": off_wall, "launches": off_counts,
                            "expected_launches": want_off,
                            "phase1_seconds_per_fold": off["device_secs_phase1_per_fold"],
                            "phase3_seconds_per_run":
                            (off["device_hours_total"] * 3600 - off["elapsed_total"]) / 2,
                            "artifacts_equal": arms_equal},
           "save_dir": save, "phase1_s": result["device_secs_phase1"],
           "phase2_s": result["device_secs_phase2"],
           "fold_checkpoints": ckpts, "fold_baselines": audit.get("fold_baselines"),
           "audit": {"folds": audit["audit_folds"], "scored": len(audit["scores"]),
                     "dropped": len(audit["dropped"])},
           "final_policy": final, "phase3": p3, "rescored_trials": rescored,
           "resume": resume,
           "timing": "host clock, synchronized at the ends; phase-1 seconds per fold and "
                     "phase-2 seconds are the driver's device_secs_* (wall x 1 device); "
                     "phase-3 seconds per run = (device_hours_total x 3600 - the driver's "
                     "elapsed_total) / 2 runs; idle share = 1 - the device time of a profiled "
                     "replay of phase 2 / the replay's own phase-2 and audit wall (the "
                     "profiler inflates it); "
                     "_at_unprofiled_wall: the same device time over the first, unprofiled, "
                     "run's phase-2 wall; the device time is the union of the device's "
                     "activities over the replay (by_range: what the ranges hold, without the "
                     "graph replays' kernels)"}
    emit(out)
    return out


#: a CLI's main() in a fresh process under deterministic cuDNN (as the
#: search arms in this process run), its result as the last stdout line
CLI_RUNNER = ("import json, sys, torch\n"
              "torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False\n"
              "sys.path.insert(0, {repo!r})\n"
              "from fast_autoaugment_tpu_torch.core import compilecache\n"
              "from fast_autoaugment_tpu_torch.launch import {cli}\n"
              "res = {cli}.main(sys.argv[1:])\n"
              "print('COMPILE ' + json.dumps(compilecache.compile_cache_stats()), flush=True)\n"
              "print('RESULT ' + json.dumps(res, default=str), flush=True)\n")
#: search_runtime_main_path (b): the machinery's flags on the search arm
PIPELINE_FLAGS = ["--async-pipeline", "on", "--pipeline-actors", "2",
                  "--pipeline-queue-depth", "1", "--watchdog", "auto"]
#: (c): the fault drills' train_cli run: the flagship on `synthetic` (512
#: train images, 4 steps an epoch), 2 epochs, evaluated every epoch
FAULT_ARGS = ["--evaluation-interval", "1", "dataset=synthetic", "epoch=2"]
FAULT_STEP, NAN_STEP, HANG_DEADLINE_S = 3, 6, 5


def _cli_process(cli: str, argv: list, log: str, env_extra: dict | None = None,
                 runner: str = CLI_RUNNER):
    """Start `cli`'s main() on `argv` in a fresh process (stdout and stderr
    to `log`)."""
    env = dict(os.environ, **(env_extra or {}))
    fh = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-c", runner.format(repo=REPO, cli=cli)] + argv,
                            cwd=REPO, env=env, stdout=fh, stderr=subprocess.STDOUT)
    proc.log_path, proc.log_fh, proc.t0, proc.exit_wall = log, fh, time.time(), None

    def note_exit():  # the exit time, whenever the caller gets to wait
        proc.wait()
        proc.exit_wall = time.time()

    threading.Thread(target=note_exit, daemon=True).start()
    return proc


def _cli_wait(proc, timeout: float) -> dict:
    """Wait for a :func:`_cli_process`; its exit code, seconds to its exit,
    result and log tail.  A process past `timeout` is killed."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    end = proc.exit_wall or time.time()
    proc.log_fh.close()
    with open(proc.log_path) as fh:
        text = fh.read()
    lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
    stats = [ln for ln in text.splitlines() if ln.startswith("COMPILE ")]
    launches = [ln for ln in text.splitlines() if ln.startswith("LAUNCHES ")]
    return {"rc": rc, "seconds": end - proc.t0, "end_wall": end,
            "result": json.loads(lines[-1][7:]) if lines else None,
            "compile_cache": json.loads(stats[-1][8:]) if stats else {},
            "launches": json.loads(launches[-1][9:]) if launches else None, "tail": text[-1500:]}


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _journal(directory: str) -> list[dict]:
    """The journal's events (a line torn by a SIGKILLed writer is skipped)."""
    out = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("journal-") and name.endswith(".jsonl"):
            with open(os.path.join(directory, name)) as fh:
                for ln in fh:
                    try:
                        out.append(json.loads(ln))
                    except ValueError:
                        pass
    return out


def phase_search_runtime(dev, workdir: str, card: str, serial: dict) -> dict:
    """``search_runtime_main_path`` (b) and (c).

    (b) ``search_cli`` in a fresh process with the search arm's config and
    cuts (:func:`_search_argv`, phases 1 and 2 and the audit) and
    :data:`PIPELINE_FLAGS`, a journal, a ``/metrics`` port and a compile
    cache: its trial log, final policy, audit and fold checkpoint digests
    equal the serial arm's (``search_main_path``); the overlap timeline shows
    overlap; the journal holds ``tta`` dispatch events; ``GET /metrics``
    answered with the dispatch histograms while it ran; the process built
    every kernel library into the cache (misses), and a second process on the
    same cache (``train_cli --only-eval`` of fold 0's model, which must
    reproduce the model's test metric) loads them all (hits) and builds
    nothing.

    (c) ``train_cli`` on WRN-40-2 (:data:`FAULT_ARGS`): ``sigterm@step=K``
    exits 77 and its rerun ends with the checkpoint bytes of an
    uninterrupted run; ``hang@step=K`` with ``--watchdog 5`` exits 77 once the
    deadline passes; ``nan_loss@step=K`` with ``--divergence-retries 1``
    finishes with one retry recorded.  The drills run beside (b), the
    resume as soon as its drill ends.  Also the watchdog's cost per dispatch
    in this process."""
    import torch

    from fast_autoaugment_tpu_torch.core.watchdog import DispatchWatchdog
    from fast_autoaugment_tpu_torch.ops import _kernels

    problems = []
    # ---- (c)'s drills through train_cli, started first: they run beside (b)
    conf = os.path.join(REPO, SEARCH_CONF)

    def drill(name, extra, fault):
        d = os.path.join(workdir, f"fault_{name}")
        os.makedirs(d)
        ckpt = os.path.join(d, "m.msgpack")
        argv = ["-c", conf, "--save", ckpt, "--telemetry", os.path.join(d, "tel")] + extra \
            + FAULT_ARGS
        env = {"FAA_FAULT": fault} if fault else {}
        return ckpt, argv, _cli_process("train_cli", argv, os.path.join(d, "log"), env)

    runs = {"whole": drill("whole", [], None),
            "sigterm": drill("sigterm", [], f"sigterm@step={FAULT_STEP}"),
            "hang": drill("hang", ["--watchdog", str(HANG_DEADLINE_S)],
                          f"hang@step={FAULT_STEP}"),
            "nan": drill("nan", ["--divergence-retries", "1"], f"nan_loss@step={NAN_STEP}")}
    done, resume_proc, preempted_meta = {}, None, None
    ckpt, argv_sigterm, _p = runs["sigterm"]

    def start_resume():
        """The sigterm drill's rerun, as soon as the drill has exited."""
        nonlocal resume_proc, preempted_meta
        done["sigterm"] = _cli_wait(runs["sigterm"][2], 600)
        if os.path.exists(ckpt + ".meta.json"):
            preempted_meta = _read_json(ckpt + ".meta.json")
        resume_proc = _cli_process("train_cli", argv_sigterm, os.path.join(workdir, "resume.log"))

    # ---- (b) the search with the machinery on
    save = os.path.join(workdir, "search_pipeline")
    cc, tel = os.path.join(workdir, "kernel_cache"), os.path.join(workdir, "telemetry")
    port = _free_port()
    argv = _search_argv(save, SEARCH_EPOCHS, until=2, extra=PIPELINE_FLAGS + [
        "--telemetry", tel, "--telemetry-port", str(port), "--compile-cache", cc])
    proc = _cli_process("search_cli", argv, os.path.join(workdir, "pipeline.log"))
    scrape, scrapes = None, 0
    while proc.poll() is None:
        time.sleep(1.0)
        if resume_proc is None and runs["sigterm"][2].poll() is not None:
            start_resume()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                text = r.read().decode()
            scrapes += 1
            if 'faa_dispatch_seconds_bucket{label="tta"' in text:
                scrape = text
        except OSError:
            pass
    first = _cli_wait(proc, 60)
    if first["rc"] != 0 or first["result"] is None:
        fail(f"search_cli with the pipeline exited {first['rc']}: {first['tail']}")
    res = first["result"]
    first_cc = dict(res.get("compile_cache") or {})

    # ---- (b)'s second process: an evaluation of fold 0's model on the cache
    fold0 = [n for n in os.listdir(save) if "_fold0_" in n and n.endswith(".msgpack")][0]
    again_proc = _cli_process("train_cli", [
        "-c", conf, "--save", os.path.join(save, fold0), "--only-eval", "--cv-ratio", "0.4",
        "--cv", "0", "--compile-cache", cc, "dataset=synthetic_shapes",
        f"epoch={SEARCH_EPOCHS}"], os.path.join(workdir, "pipeline_again.log"))
    if resume_proc is None:
        start_resume()
    done.update({k: _cli_wait(v[2], 600) for k, v in runs.items() if k != "sigterm"})
    resumed = _cli_wait(resume_proc, 600)
    again = _cli_wait(again_proc, 600)

    # ---- (b)'s checks
    equal = {}
    for name in ("search_trials.json", "final_policy.json", "audit.json"):
        with open(os.path.join(save, name), "rb") as a, \
                open(os.path.join(serial["save_dir"], name), "rb") as b:
            equal[name] = a.read() == b.read()
    for name in sorted(os.listdir(serial["save_dir"])):
        if name.endswith(".meta.json") and not name.startswith("final_"):
            other = os.path.join(save, name)
            equal[name] = os.path.exists(other) and _read_json(other)["digest"] == \
                _read_json(os.path.join(serial["save_dir"], name))["digest"]
    if not all(equal.values()):
        problems.append(f"pipeline arm differs from the serial arm: "
                        f"{[k for k, v in equal.items() if not v]}")
    pipe = res.get("pipeline") or {}
    overlap_s = (pipe.get("overlap") or {}).get("overlap_secs", 0.0)
    if not overlap_s > 0:
        problems.append(f"no phase overlap: {pipe.get('overlap')}")
    events = _journal(tel)
    tta_events = sum(1 for e in events if e["type"] == "dispatch" and e["label"] == "tta")
    if not tta_events:
        problems.append("the journal holds no tta dispatch event")
    if scrape is None:
        problems.append(f"GET /metrics never showed the tta dispatch histogram ({scrapes} "
                        "scrapes)")
    libs = len(_kernels.SOURCES)  # one build, then one load, of each kernel library
    if not (first_cc.get("misses") == libs and first_cc.get("hits") == 0):
        problems.append(f"first process compile cache {first_cc} (want {libs} misses, 0 hits)")
    again_cc = again["compile_cache"]
    if again["rc"] != 0 or not (again_cc.get("hits") == libs and again_cc.get("misses") == 0):
        problems.append(f"second process on the cache: rc {again['rc']}, {again_cc}")
    fold0_test = (again["result"] or {}).get("top1_test")
    if fold0_test != _read_json(os.path.join(save, fold0 + ".meta.json"))["metrics"]["top1_test"]:
        problems.append(f"fold 0's model evaluated on the cache: top1_test {fold0_test} is not "
                        "its checkpoint's")
    if res.get("tta_executables") != res.get("tta_executables_expected"):
        problems.append(f"graph census {res.get('tta_executables')} != "
                        f"{res.get('tta_executables_expected')}")
    if problems:
        fail("search_runtime_main_path (b): " + "; ".join(problems))
    n_trials = 8
    out_b = {"phase": "search_runtime_main_path", "part": "search_cli", "card": card,
             "flags": PIPELINE_FLAGS, "wall_s": first["seconds"], "artifacts_equal": equal,
             "phase1_plus_phase2_s": {"pipeline": res["device_secs_phase2"],
                                      "serial": serial["phase1_s"] + serial["phase2_s"]},
             "phase2_s": {"pipeline_overlapped_region": res["device_secs_phase2"],
                          "serial": serial["phase2_s"]},
             "phase2_seconds_per_trial_serial": serial["phase2_s"] / n_trials,
             "overlap_secs": overlap_s, "overlap": pipe.get("overlap"),
             "dispatch_gaps": pipe.get("dispatch_gaps"), "tell_reorders": pipe.get("tell_reorders"),
             "watchdog": res.get("resilience", {}).get("watchdog"),
             "watchdog_fires": res.get("watchdog_fires"),
             "tta_executables": res.get("tta_executables"),
             "tta_executables_first": res.get("tta_executables_first"),
             "tta_executables_expected": res.get("tta_executables_expected"),
             "journal_events": len(events), "journal_tta_dispatch_events": tta_events,
             "metrics_scrapes": scrapes,
             "metrics_dispatch_lines": [ln for ln in (scrape or "").splitlines()
                                        if ln.startswith("faa_dispatch_seconds_count")],
             "compile_cache_first_process": first_cc, "compile_cache_second_process": again_cc,
             "nvcc_build_s": first_cc.get("labels", {}).get("kernels", {}).get("sec"),
             "cache_load_s": again_cc.get("labels", {}).get("kernels", {}).get("sec"),
             "second_process_s": again["seconds"]}
    emit(out_b)

    # ---- (c)'s checks
    def payload(path):
        with open(path, "rb") as fh:
            return fh.read()

    fires = [e for e in _journal(os.path.join(workdir, "fault_hang", "tel"))
             if e["type"] == "watchdog_fire"]
    hang_exit_after_fire = done["hang"]["end_wall"] - fires[0]["t_wall"] if fires else None
    nan_res = done["nan"]["result"] or {}
    checks = {
        "whole_rc0": done["whole"]["rc"] == 0,
        "sigterm_rc77": done["sigterm"]["rc"] == 77,
        "sigterm_link_preempted": bool(preempted_meta and preempted_meta.get("preempted")
                                       and preempted_meta.get("in_epoch")),
        "resume_rc0": resumed["rc"] == 0,
        "resume_bytes_equal": resumed["rc"] == 0
        and payload(ckpt) == payload(runs["whole"][0]),
        "hang_rc77": done["hang"]["rc"] == 77,
        "hang_fired_within_deadline": bool(fires) and
        fires[0]["waited_sec"] <= HANG_DEADLINE_S + 2.0,
        "hang_exit_prompt": hang_exit_after_fire is not None and hang_exit_after_fire < 30.0,
        "nan_rc0": done["nan"]["rc"] == 0,
        "nan_one_retry": nan_res.get("divergence_retries_used") == 1,
        "nan_finished": nan_res.get("epoch") == 2,
    }
    # the watchdog's cost per dispatch: a small dispatch direct (with its
    # wait) against through the watchdog, alternating
    x = torch.zeros(1 << 20, device=dev)

    def small():
        return x.add_(1.0)

    wd = DispatchWatchdog("auto")
    wd.run("probe", small)
    direct, watched = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            small()
            torch.cuda.current_stream().synchronize()
        direct.append((time.perf_counter() - t0) / 200)
        t0 = time.perf_counter()
        for _ in range(200):
            wd.run("probe", small)
        watched.append((time.perf_counter() - t0) / 200)
    out_c = {"phase": "search_runtime_main_path", "part": "faults", "card": card,
             "checks": checks, "drills": {k: {"rc": v["rc"], "seconds": v["seconds"]}
                                          for k, v in done.items()},
             "resume": {"rc": resumed["rc"], "seconds": resumed["seconds"]},
             "preempted_link": preempted_meta and {k: preempted_meta.get(k) for k in
                                                   ("epoch", "step", "preempted", "in_epoch")},
             "hang_watchdog_fire": fires[0] if fires else None,
             "hang_exit_s_after_fire": hang_exit_after_fire,
             "nan_result": {k: nan_res.get(k) for k in ("epoch", "divergence_retries_used",
                                                        "loss_train", "top1_test")},
             "watchdog_cost_us_per_dispatch": {
                 "direct_median": float(np.median(direct)) * 1e6,
                 "watched_median": float(np.median(watched)) * 1e6,
                 "cost": (float(np.median(watched)) - float(np.median(direct))) * 1e6}}
    emit(out_c)
    if not all(checks.values()):
        fail("search_runtime_main_path (c): " + str({k: v for k, v in checks.items() if not v})
             + " " + json.dumps({k: v["tail"][-600:] for k, v in done.items()}))
    return {"b": out_b, "c": out_c}


# ------------------------------------------------------------ fleet search

#: a fleet host: ``search_cli`` through :data:`CLI_RUNNER` (the serial arm's
#: cuDNN flags) that also prints its kernel launch counters when it exits
#: normally (a SIGKILLed or exit-77 host prints none)
FLEET_RUNNER = CLI_RUNNER + ("from fast_autoaugment_tpu_torch.ops import _kernels\n"
                             "print('LAUNCHES ' + json.dumps(_kernels.launch_counts()), "
                             "flush=True)\n")
#: the transport arm's lease TTL, the bound every live lease's gap between
#: two writes must stay under in both arms, and the queue arm's watchdog
#: deadline (seconds)
FLEET_TTL_S, FLEET_WATCHDOG_S = 10, 5
#: the queue arm's lease TTL: b's relaunch re-claims its own unit only if
#: no other host has found that lease stale first, and a relaunch's process
#: start and warm-up take 8-15 s before its claim (``relaunch_gaps_s``)
FLEET_QUEUE_TTL_S = 2 * FLEET_TTL_S
#: the queue arm's hosts and their faults: a hangs once (the watchdog exits 77
#: and the relaunch resumes), b is SIGKILLed at step 3 on every attempt (lost
#: after its retries), c is clean and joins once b is lost
FLEET_FAULTS = {"a": "hang@step=2,attempt=1", "b": "sigkill@step=3", "c": None}
FLEET_HOST_RETRIES, FLEET_RETRY_BACKOFF_S = 2, 0.2
#: the transport arm's first actor is SIGKILLed at this trial of fold 0; the
#: second starts once the first has posted the round before it
FLEET_KILL_TRIAL = 2
#: the longest a gated host waits for its gate (seconds)
FLEET_GATE_S = 240
#: arguments every fleet host gets first (a CPU rehearsal puts --device cpu)
FLEET_HOST_ARGS: list = []


class _LeaseWatch(threading.Thread):
    """Polls a lease queue's ``hosts/*.json`` and ``leases/*.json`` (under
    `root`) every 0.1 s.  An observer reclaims a lease it has seen unchanged
    for the TTL, so the longest time one live process's lease went unchanged
    (between two of its writes) is what the TTL must dominate; the host
    beats are what the supervisor's wedge detector reads.  A lease's writes
    form one series per unit, owner, epoch and owner process (the pid of
    the owner's newest host beat), so a relaunched host's re-claim starts a
    new series."""

    def __init__(self, root: str):
        super().__init__(daemon=True)
        self.root, self.stop = root, threading.Event()
        self.beats: dict[tuple, list] = {}
        self.leases: dict[tuple, list] = {}
        self.pid: dict = {}

    def _records(self, sub: str):
        try:
            names = os.listdir(os.path.join(self.root, sub))
        except OSError:
            return
        for name in names:
            if name.endswith(".json"):
                try:
                    yield _read_json(os.path.join(self.root, sub, name))
                except (OSError, ValueError):
                    continue

    @staticmethod
    def _tick(series: dict, key: tuple, now: float, stamp) -> None:
        ticks = series.setdefault(key, [])
        if not ticks or ticks[-1][1] != stamp:
            ticks.append((now, stamp))

    def run(self):
        while not self.stop.wait(0.1):
            now = time.time()
            for rec in self._records("hosts"):
                self.pid[rec.get("owner")] = rec.get("pid")
                self._tick(self.beats, (rec.get("owner"), rec.get("pid")), now,
                           rec.get("heartbeat"))
            for rec in self._records("leases"):
                owner = rec.get("owner")
                self._tick(self.leases, (rec.get("unit"), owner, rec.get("epoch"),
                                         self.pid.get(owner)), now, rec.get("heartbeat"))

    @staticmethod
    def _longest(series: dict) -> dict:
        out = {}
        for key, ticks in series.items():
            times = [t for t, _stamp in ticks]
            for a, b in zip(times, times[1:]):
                if b - a > out.get(key, {}).get("s", 0.0):
                    out[key] = {"s": b - a, "from_wall": a, "to_wall": b}
        return out

    def lease_gaps(self, events=()) -> list:
        """Each lease series: its longest gap between two writes, its first
        three gaps after the claim (the first dispatch's breakdown) and what
        the holder's journal (`events`) holds inside the longest gap."""
        out = []
        longest = self._longest(self.leases)
        for key, ticks in sorted(self.leases.items(), key=lambda kv: kv[1][0][0]):
            unit, owner, epoch, pid = key
            g = longest.get(key, {"s": 0.0, "from_wall": None, "to_wall": None})
            times = [t for t, _stamp in ticks]
            inside = [e for e in events if g["from_wall"] is not None
                      and e.get("host") == owner and e.get("pid") == pid
                      and g["from_wall"] - 0.2 <= e["t_wall"] <= g["to_wall"] + 0.2]
            out.append({"unit": unit, "owner": owner, "epoch": epoch, "pid": pid,
                        "writes": len(ticks), "longest_s": g["s"],
                        "first_gaps_s": [b - a for a, b in zip(times, times[1:])][:3],
                        "journal_in_longest": [
                            {k: e.get(k) for k in ("type", "label", "action", "dur_sec")
                             if e.get(k)} | {"at_s": round(e["t_wall"] - g["from_wall"], 3)}
                            for e in inside][:12]})
        return out

    def relaunch_gaps(self) -> list:
        """Per unit, owner and epoch, the seconds from one process's last
        write of the lease to the first write by the owner's next process
        (a relaunch re-claiming its own unit): what the TTL must dominate
        for the relaunch to keep its unit."""
        spans: dict = {}
        for (unit, owner, epoch, _pid), ticks in self.leases.items():
            spans.setdefault((unit, owner, epoch), []).append((ticks[0][0], ticks[-1][0]))
        return [{"unit": unit, "owner": owner, "s": b[0] - a[1]}
                for (unit, owner, _epoch), runs in sorted(spans.items(), key=str)
                for a, b in zip(sorted(runs), sorted(runs)[1:])]

    def beat_gaps(self) -> dict:
        """Per host, its processes' longest gap between two host beats."""
        out: dict = {}
        for (owner, _pid), g in self._longest(self.beats).items():
            out[owner] = max(out.get(owner, 0.0), g["s"])
        return out


def _lease_report(watch: _LeaseWatch, events: list) -> dict:
    """The lease watch's findings and the two checks on them: every lease
    gap of a live holder under :data:`FLEET_TTL_S` (the transport's TTL, half
    the queue's), and no holder that lost its lease
    while it ran (a ``lease`` event with action ``lost``): the drill's
    reclaims are of dead or hung hosts only."""
    watch.stop.set()
    gaps = watch.lease_gaps(events)
    longest = max((g["longest_s"] for g in gaps), default=0.0)
    lost = [{k: e.get(k) for k in ("label", "host", "new_owner")} for e in events
            if e["type"] == "lease" and e.get("action") == "lost"]
    return {"lease_gaps": gaps, "lease_gap_max_s": longest, "lease_gap_bound_s": FLEET_TTL_S,
            "relaunch_gaps_s": watch.relaunch_gaps(), "leases_lost_by_live_holders": lost,
            "host_beat_gap_max_s": watch.beat_gaps(),
            "checks": {"ttl_dominates_lease_gaps": longest < FLEET_TTL_S,
                       "no_live_lease_lost": not lost}}


def _fleet_artifacts_equal(save: str, serial: dict, trial_files: bool) -> dict:
    """The fleet arm's trial logs (one file, or one per fold under the work
    queue), final policy, audit and fold checkpoint digests against the
    serial arm's, bitwise."""
    ref = serial["save_dir"]
    equal = {}
    if trial_files:
        trials = _read_json(os.path.join(ref, "search_trials.json"))
        for k in sorted(trials, key=int):
            path = os.path.join(save, f"search_trials.fold{k}.json")
            equal[f"search_trials.fold{k}.json"] = os.path.exists(path) and \
                open(path).read() == json.dumps(trials[k])
    names = ("final_policy.json", "audit.json") + (() if trial_files else ("search_trials.json",))
    for name in names:
        path = os.path.join(save, name)
        with open(os.path.join(ref, name), "rb") as b:
            equal[name] = os.path.exists(path) and open(path, "rb").read() == b.read()
    for name in sorted(os.listdir(ref)):
        if name.endswith(".msgpack.meta.json") and not name.startswith("final_"):
            other = os.path.join(save, name)
            equal[name] = os.path.exists(other) and _read_json(other)["digest"] == \
                _read_json(os.path.join(ref, name))["digest"]
    return equal


def _sum_launches(parts) -> dict:
    from fast_autoaugment_tpu_torch.ops import _kernels

    total = dict.fromkeys(_kernels.launch_counts(), 0)
    for counts in parts:
        for k, v in (counts or {}).items():
            total[k] += v
    return total


def _fleet_transport_arm(root: str, out: dict) -> None:
    """Arm (b): one learner and two actors on a round transport (processes of
    their own, ``--search-role``); the first actor is SIGKILLed at trial
    :data:`FLEET_KILL_TRIAL` of fold 0, the second starts once the first has
    posted the round before it.  Results into `out`."""
    tr, save, tel = (os.path.join(root, n) for n in ("transport", "search", "telemetry"))
    out.update(save=save, tr=tr, tel=tel)
    argv = FLEET_HOST_ARGS + _search_argv(save, SEARCH_EPOCHS, until=2, extra=[
        "--fleet-transport", tr, "--lease-ttl", str(FLEET_TTL_S), "--pipeline-actors", "1",
        "--pipeline-queue-depth", "0", "--telemetry", tel])
    watch = out["watch"] = _LeaseWatch(tr)
    watch.start()
    t0 = time.time()
    procs = {"learner": _cli_process(
        "search_cli", argv + ["--search-role", "learner", "--host-id", "0"],
        os.path.join(root, "learner.log"), {"FAA_HOST_ID": "0"}, runner=FLEET_RUNNER)}
    procs["doomed"] = _cli_process(
        "search_cli", argv + ["--search-role", "actor", "--host-id", "1"],
        os.path.join(root, "actor1.log"),
        {"FAA_HOST_ID": "1", "FAA_FAULT": f"sigkill_trial@trial={FLEET_KILL_TRIAL},attempt=1"},
        runner=FLEET_RUNNER)
    gate = os.path.join(tr, "done", f"p2r-f0-t{FLEET_KILL_TRIAL - 1:06d}.json")
    deadline = time.time() + FLEET_GATE_S
    while not os.path.exists(gate) and time.time() < deadline \
            and procs["learner"].poll() is None:
        time.sleep(0.1)
    procs["survivor"] = _cli_process(
        "search_cli", argv + ["--search-role", "actor", "--host-id", "2"],
        os.path.join(root, "actor2.log"), {"FAA_HOST_ID": "2"}, runner=FLEET_RUNNER)
    done = {k: _cli_wait(v, 900) for k, v in procs.items()}
    watch.stop.set()
    out.update(done=done, wall_s=time.time() - t0, doomed_exit=procs["doomed"].exit_wall)


def phase_fleet_search(workdir: str, card: str, serial: dict) -> dict:
    """``fleet_search_main_path``: the search's fleet tier against the serial
    arm (``search_main_path``), with its config and cuts
    (:func:`_search_argv`, phases 1 and 2 and the audit), every host a
    ``search_cli`` process of its own on the card.

    (a) The elastic work queue: ``launch/fleet.py launch_fleet`` over three
    local hosts (a local shell in place of ssh) with ``--elastic``,
    :data:`FLEET_HOST_RETRIES` retries and the heartbeat wedge detector, each
    host ``search_cli --workqueue --lease-ttl 20 --watchdog 5`` with its fault
    of :data:`FLEET_FAULTS`.  The fleet exits 0; the result is degraded,
    host1 (b) lost, a unit reclaimed; every ``p1-fold<k>``/``p2-fold<k>`` unit
    has a done marker; the per-fold trial logs, final policy, audit and fold
    checkpoint digests equal the serial arm's.  (b) The round transport
    (:func:`_fleet_transport_arm`), beside (a): the learner's trial log, final
    policy, audit and fold checkpoints equal the serial arm's; the killed
    actor's round was reclaimed (a done marker at lease attempt 2); the
    surviving actor exits 0 with rounds evaluated; nothing is quarantined.
    Each arm's kernel launches are the sums of its hosts' ``LAUNCHES`` lines.
    Also the seconds from each kill to its reclaim, the longest gap between
    a live host's beats (what the TTL must dominate), the rounds per actor
    and the publish->apply latency of the transport's rounds."""
    from fast_autoaugment_tpu_torch.launch import fleet as fleet_mod

    t_phase = time.time()
    root_a, root_b = os.path.join(workdir, "fleet_queue"), os.path.join(workdir, "fleet_transport")
    os.makedirs(root_a)
    os.makedirs(root_b)
    arm_b: dict = {}

    def run_b():
        try:
            _fleet_transport_arm(root_b, arm_b)
        except Exception as e:  # reported with (b)'s checks
            arm_b["error"] = f"{type(e).__name__}: {e}"

    thread_b = threading.Thread(target=run_b, daemon=True)
    thread_b.start()

    # ---- (a) the elastic work queue under the fleet supervisor
    save, wq, tel = (os.path.join(root_a, n) for n in ("search", "wq", "telemetry"))
    gate = os.path.join(root_a, "host_b_lost")
    runner = os.path.join(root_a, "host.py")  # a file: the supervisor logs each command
    with open(runner, "w") as fh:
        fh.write(FLEET_RUNNER.format(repo=REPO, cli="search_cli"))
    command = [sys.executable, runner] + FLEET_HOST_ARGS + _search_argv(save, SEARCH_EPOCHS, until=2, extra=[
            "--workqueue", wq, "--lease-ttl", str(FLEET_QUEUE_TTL_S), "--watchdog",
            str(FLEET_WATCHDOG_S), "--ckpt-every-dispatch", "1", "--telemetry", tel])

    def preamble(host: str) -> str:
        fault = FLEET_FAULTS[host]
        pre = f"export FAA_FAULT={shlex.quote(fault)}; " if fault else "unset FAA_FAULT; "
        if host == "c":  # a spare host: joins once b is lost
            pre += (f"for i in $(seq {FLEET_GATE_S * 5}); do [ -e {shlex.quote(gate)} ] && "
                    "break; sleep 0.2; done; ")
        return pre

    host_log = open(os.path.join(root_a, "hosts.log"), "wb")
    real_argv, real_stream = fleet_mod._remote_argv, fleet_mod._stream
    fleet_mod._remote_argv = lambda host, wire: ["bash", "-c", preamble(host) + wire]
    fleet_mod._stream = lambda prefix, pipe, _out: real_stream(prefix, pipe, host_log)
    os.makedirs(os.path.join(wq, "hosts"))
    watch = _LeaseWatch(wq)
    watch.start()
    t0 = time.time()
    try:
        with _LogLines("faa_torch.fleet") as flog:
            lost_seen = threading.Event()

            def open_gate():
                while not lost_seen.wait(0.2):
                    if flog.first("host=b ", "LOST") or time.time() - t0 > FLEET_GATE_S:
                        with open(gate, "w"):
                            pass
                        lost_seen.set()

            threading.Thread(target=open_gate, daemon=True).start()
            code = fleet_mod.launch_fleet(
                ["a", "b", "c"], command, "localhost:8476", host_retries=FLEET_HOST_RETRIES,
                retry_backoff=FLEET_RETRY_BACKOFF_S, elastic=True, workqueue_dir=wq,
                heartbeat_timeout=12 * FLEET_TTL_S)
            lost_seen.set()
    finally:
        fleet_mod._remote_argv, fleet_mod._stream = real_argv, real_stream
        watch.stop.set()
        host_log.close()
    wall_a = time.time() - t0
    thread_b.join(timeout=1200)
    problems = []

    # ---- (a)'s checks
    with open(os.path.join(root_a, "hosts.log"), errors="replace") as fh:
        host_lines = fh.read().splitlines()
    launches_a = _sum_launches(json.loads(ln.split(" LAUNCHES ", 1)[1]) for ln in host_lines
                               if " LAUNCHES " in ln)
    res_a = _read_json(os.path.join(save, "search_result.json")) \
        if os.path.exists(os.path.join(save, "search_result.json")) else {}
    done_units = sorted(n[:-5] for n in os.listdir(os.path.join(wq, "done")))
    want_units = sorted(f"p{p}-fold{k}" for p in (1, 2) for k in (0, 1))
    equal_a = _fleet_artifacts_equal(save, serial, trial_files=True)
    events_a = _journal(tel) if os.path.isdir(tel) else []
    reclaims = [e for e in events_a if e["type"] == "lease" and e.get("action") == "reclaim"]
    fires = [e for e in events_a if e["type"] == "watchdog_fire"]
    lost_at = flog.first("host=b ", "LOST")
    from_b = [e for e in reclaims if e.get("reclaimed_from") == "host1"]
    attempts = flog.first("fleet done")
    leases_a = _lease_report(watch, events_a)
    checks_a = {
        "fleet_rc0": code == 0,
        "degraded": res_a.get("degraded") is True,
        "host1_lost": "host1" in (res_a.get("lost_hosts") or []),
        "units_reclaimed": bool(res_a.get("reclaimed_units")),
        "every_unit_done": all(u in done_units for u in want_units),
        "artifacts_equal_serial": bool(equal_a) and all(equal_a.values()),
        "host_a_watchdog_fired": any(e.get("host") == "host0" for e in fires),
        "host_b_lost_by_supervisor": lost_at is not None,
        **leases_a.pop("checks"),
    }
    out_a = {"phase": "fleet_search_main_path", "part": "workqueue", "card": card,
             "checks": checks_a, "wall_s": wall_a, "fleet_exit": code,
             "supervisor": attempts and attempts[1], "degraded": res_a.get("degraded"),
             "lost_hosts": res_a.get("lost_hosts"), "reclaimed_units": res_a.get("reclaimed_units"),
             "fleet_accounting": (res_a.get("resilience") or {}).get("fleet"),
             "done_units": done_units, "artifacts_equal": equal_a,
             "kill_to_reclaim_s": (from_b[0]["t_wall"] - lost_at[0]) if from_b and lost_at
             else None,
             "kill_to_reclaim_is": "the reclaim of host b's unit (its journal event) after the "
                                   "supervisor logged host b lost (its last attempt's exit)",
             "reclaims": [{k: e.get(k) for k in ("label", "host", "reclaimed_from",
                                                 "lease_attempt", "lease_epoch",
                                                 "observed_stale_sec")} for e in reclaims],
             "watchdog_fires": [{k: e.get(k) for k in ("host", "attempt", "label_detail",
                                                       "waited_sec")} for e in fires],
             **leases_a, "launches": launches_a,
             "hosts_reporting_launches": sum(" LAUNCHES " in ln for ln in host_lines)}
    emit(out_a)
    if not all(checks_a.values()):
        problems.append("(a) " + str({k: v for k, v in checks_a.items() if not v})
                        + " " + "\n".join(host_lines[-40:]))

    # ---- (b)'s checks
    done = arm_b.get("done") or {}
    learner, survivor, doomed = (done.get(k) or {"rc": None} for k in
                                 ("learner", "survivor", "doomed"))
    equal_b = _fleet_artifacts_equal(arm_b["save"], serial, trial_files=False) \
        if learner["rc"] == 0 else {}
    if arm_b.get("error"):
        problems.append(f"(b) {arm_b['error']}")
    markers = []
    if arm_b.get("tr") and os.path.isdir(os.path.join(arm_b["tr"], "done")):
        markers = [_read_json(os.path.join(arm_b["tr"], "done", n))
                   for n in sorted(os.listdir(os.path.join(arm_b["tr"], "done")))]
    res_b = learner.get("result") or {}
    srv = survivor.get("result") or {}
    events_b = _journal(arm_b["tel"]) if arm_b.get("tel") and os.path.isdir(arm_b["tel"]) else []
    rounds = {}
    for e in events_b:
        if e["type"] == "round":
            rounds.setdefault(e["label"], {}).setdefault(e["action"], e)
    pub_to_apply = sorted((r["apply"]["t_wall"] - r["publish"]["t_wall"]) * 1e3
                          for r in rounds.values() if "apply" in r and "publish" in r)
    ret_to_apply = sorted(r["apply"]["return_to_apply_ms"] for r in rounds.values()
                          if r.get("apply", {}).get("return_to_apply_ms") is not None)
    reclaim_b = [e for e in events_b if e["type"] == "lease" and e.get("action") == "reclaim"]
    leases_b = _lease_report(arm_b["watch"], events_b) if arm_b.get("watch") else \
        {"checks": {"lease_watch_ran": False}}
    # the learner trains phase 1 and runs the audit; the surviving actor's
    # rounds must launch the TTA's kernels by themselves
    survivor_launches = survivor.get("launches") or {}
    checks_b = {
        "learner_rc0": learner["rc"] == 0,
        "artifacts_equal_serial": bool(equal_b) and all(equal_b.values()),
        "round_reclaimed": any(int(m.get("attempt", 1)) > 1 for m in markers),
        "survivor_rc0": survivor["rc"] == 0,
        "survivor_rounds_ok": int(srv.get("rounds_ok") or 0) > 0,
        "doomed_killed": doomed["rc"] == -signal.SIGKILL,
        "nothing_quarantined": res_b.get("num_quarantined_trials") == 0,
        "survivor_launched_tta_kernels": all(survivor_launches.get(k) for k in
                                             ("augment", "cifar_stack", "sampler")),
        **leases_b.pop("checks"),
    }
    launches_b = _sum_launches([learner.get("launches"), survivor.get("launches")])
    out_b = {"phase": "fleet_search_main_path", "part": "transport", "card": card,
             "checks": checks_b, "wall_s": arm_b.get("wall_s"),
             "rcs": {k: v["rc"] for k, v in (("learner", learner), ("actor1", doomed),
                                             ("actor2", survivor))},
             "artifacts_equal": equal_b, "degraded": res_b.get("degraded"),
             "lost_hosts": res_b.get("lost_hosts"), "reclaimed_units": res_b.get("reclaimed_units"),
             "fleet_transport": res_b.get("fleet_transport"),
             "rounds_by_actor": {m.get("owner"): sum(x.get("owner") == m.get("owner")
                                                     for x in markers) for m in markers},
             "survivor": {k: srv.get(k) for k in ("rounds_ok", "rounds_err", "lease_lost",
                                                  "folds", "reclaimed_units",
                                                  "tta_executables")},
             "kill_to_reclaim_s": (reclaim_b[0]["t_wall"] - arm_b["doomed_exit"])
             if reclaim_b and arm_b.get("doomed_exit") else None,
             "kill_to_reclaim_is": "the survivor's reclaim (its journal event) after actor 1's "
                                   "process exit",
             "publish_to_apply_ms": {"median": float(np.median(pub_to_apply)),
                                     "max": pub_to_apply[-1], "rounds": len(pub_to_apply)}
             if pub_to_apply else None,
             "return_to_apply_ms": {"median": float(np.median(ret_to_apply)),
                                    "max": ret_to_apply[-1]} if ret_to_apply else None,
             **leases_b, "launches": launches_b,
             "launches_by_host": {"learner": learner.get("launches"),
                                  "survivor": survivor.get("launches")}}
    emit(out_b)
    if not all(checks_b.values()):
        problems.append("(b) " + str({k: v for k, v in checks_b.items() if not v}) + " "
                        + json.dumps({k: v.get("tail", "")[-800:] for k, v in done.items()}))
    if problems:
        fail("fleet_search_main_path: " + "; ".join(problems))
    out = {"phase": "fleet_search_main_path", "part": "summary", "card": card,
           "wall_s": time.time() - t_phase, "queue_arm_s": wall_a,
           "transport_arm_s": arm_b.get("wall_s"),
           "kill_to_reclaim_s": {"workqueue": out_a["kill_to_reclaim_s"],
                                 "transport": out_b["kill_to_reclaim_s"]}}
    emit(out)
    return {"workqueue": launches_a, "transport": launches_b, **out}


# --------------------------------------------------------- the control loop

#: control_main_path: every replica's inputs shift by CONTROL_SHIFT from its
#: CONTROL_DRIFT_DISPATCH-th dispatch on (FAA_FAULT ``drift``; past the drift
#: monitor's 20-sample baseline window on every replica)
CONTROL_DRIFT_DISPATCH, CONTROL_SHIFT = 24, 60
#: the replicas' padded shapes (one CUDA graph each, a warm-up call each at
#: start and at every reload) and the closed-loop clients of each fleet
CONTROL_SHAPES = (8, 32)
CONTROL_CLIENTS, CONTROL_IMAGES = 4, 8
#: trials the re-search adds to each fold of the search cell's base run
CONTROL_TOPUP = 2
#: seconds of traffic kept after each arm's promotion
CONTROL_AFTER_S = 2.0
#: the longest either arm waits for its promotion (seconds)
CONTROL_DEADLINE_S = 420
#: control_cli flags of both arms (the JAX drills' gate: non-inferiority
#: with a wide margin, two judgeable polls).  The monitor watches the
#: inputs, where the drift is injected: the reward proxy moves with the
#: served policy itself, and the window re-baselined after a promotion
#: holds dispatches served before the replicas' reloads, so watching it
#: can start a second episode after the promotion (seen on an H100: a
#: CUSUM of 11.88 on reward_proxy 0.9 s after the promote)
CONTROL_FLAGS = ["--drift-metrics", "input_mean", "--canary-replicas", "1", "--split-every",
                 "2", "--quality-margin", "10", "--min-arm-dispatches", "1",
                 "--reload-timeout", "300"]
#: arguments every replica and the re-search get first (a CPU rehearsal
#: puts --device cpu)
CONTROL_HOST_ARGS: list = []


class _Traffic:
    """Closed-loop clients through one endpoint: `clients` threads each POST
    raw requests of `n` 32x32 images (a seeded pool of batches, cycled)
    back to back until stopped; every request's start, end and error."""

    def __init__(self, port: int, clients: int = CONTROL_CLIENTS, n: int = CONTROL_IMAGES,
                 seed: int = 5):
        from fast_autoaugment_tpu_torch.serve import wire

        g = np.random.default_rng(seed)
        self.bodies = [wire.encode_raw(g.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8))
                       for _ in range(16)]
        self.ctype, self.port = wire.RAW_CONTENT_TYPE, port
        self.rows: list[tuple] = []
        self.lock = threading.Lock()
        self.stop_event = threading.Event()
        self.threads = [threading.Thread(target=self._client, args=(i, clients), daemon=True)
                        for i in range(clients)]
        self.t0 = time.time()
        for t in self.threads:
            t.start()

    def _client(self, i: int, clients: int) -> None:
        k = i
        while not self.stop_event.is_set():
            body = self.bodies[k % len(self.bodies)]
            k += clients
            t0 = time.time()
            try:
                status, _h, _b = _http(self.port, "/augment", body, self.ctype)
                err = None if status == 200 else f"status {status}: {_b[:200]!r}"
            except Exception as e:  # noqa: BLE001 -- counted, fails the phase
                err = repr(e)
            with self.lock:
                self.rows.append((t0, time.time(), err))

    def stop(self) -> None:
        self.stop_event.set()
        for t in self.threads:
            t.join(timeout=150)
        self.t1 = time.time()

    def window(self, t0: float, t1: float) -> dict:
        """Requests answered in [t0, t1): count, failures, requests/s, p50/p99."""
        with self.lock:
            rows = [r for r in self.rows if t0 <= r[1] < t1]
        ms = np.array([(b - a) * 1e3 for a, b, e in rows if e is None] or [0.0])
        return {"requests": len(rows), "failed": sum(e is not None for _a, _b, e in rows),
                "seconds": t1 - t0, "requests_per_s": len(rows) / max(t1 - t0, 1e-9),
                "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}

    def failures(self) -> list[str]:
        with self.lock:
            return [e for _a, _b, e in self.rows if e is not None]


def _control_fleet(root: str, baseline: str, tag: str) -> dict:
    """Three ``serve_cli --traffic-stats`` replicas of `baseline` (grouped,
    32x32, journaling into one shared dir, drifting at
    :data:`CONTROL_DRIFT_DISPATCH`) and ``router_cli`` over their port dir;
    started, not waited for."""
    d = {k: os.path.join(root, k) for k in ("telemetry", "ports")}
    for path in d.values():
        os.makedirs(path, exist_ok=True)
    drift = f"drift@dispatch={CONTROL_DRIFT_DISPATCH},shift={CONTROL_SHIFT}"
    reps = [Replica(CONTROL_HOST_ARGS + [
        "--policy", baseline, "--image", "32", "--shapes", ",".join(map(str, CONTROL_SHAPES)),
        "--dispatch", "grouped", "--max-wait-ms", "2", "--traffic-stats", "--telemetry",
        d["telemetry"], "--port-dir", d["ports"], "--host-tag", f"replica{i}"],
        root, f"{tag}_replica{i}", env_extra={"FAA_FAULT": drift, "FAA_HOST_ID": str(i)})
        for i in range(3)]
    rt = Replica(["--port-dir", d["ports"], "--poll-interval", "0.2", "--telemetry",
                  d["telemetry"]], root, f"{tag}_router",
                 module="fast_autoaugment_tpu_torch.serve.router_cli",
                 env_extra={"FAA_HOST_ID": "9"})
    return {**d, "replicas": reps, "router": rt, "root": root}


def _wait_watching(proc, timeout: float = 120.0) -> None:
    """Until the controller's loop runs (its "control loop watching" log
    line), so that the traffic's drift meets a polling monitor."""
    _wait_for(lambda: "control loop watching" in _tail(proc.log_path, 1 << 20)
              or (proc.poll() is not None and fail(
                  f"control_main_path: {os.path.basename(proc.log_path)} exited "
                  f"{proc.returncode}: {_tail(proc.log_path)}")),
              timeout, f"{os.path.basename(proc.log_path)} to watch")


def _stop_proc(proc, timeout: float = 60.0):
    """SIGTERM a :func:`_cli_process` (killed past `timeout`); its exit code."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    proc.log_fh.close()
    return proc.returncode


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as fh:
        return fh.read()[-n:]


def _wait_event(tel: str, pred, procs, timeout: float, what: str):
    """The first journal event of `tel` satisfying `pred`; fails if a
    process of `procs` exits first or `timeout` passes."""
    def found():
        event = next((e for e in _journal(tel) if pred(e)), None)
        for p in procs:
            if event is None and p.poll() is not None:
                fail(f"control_main_path: {os.path.basename(p.log_path)} exited "
                     f"{p.returncode} before {what}: {_tail(p.log_path)}")
        return event

    return _wait_for(found, timeout, what)


def _replica_launches(st: dict, reloads: int) -> tuple[dict, dict]:
    """A control replica's launch counters against the prediction: each
    graph build (start, every reload) is a warm-up call a shape, every
    dispatch one K7 and one K1 call; nothing else."""
    from fast_autoaugment_tpu_torch.ops import _kernels

    per_call = _kernels.augment_plan(32, 32, st["num_op"]).launches
    calls = len(CONTROL_SHAPES) * (1 + reloads) + st["dispatches"]
    want = dict.fromkeys(ALL_KERNELS, 0)
    want.update(augment=per_call * calls, sampler=calls)
    return st["kernel_launches"], want


def _research_expected_launches(base: str, cand: str) -> dict:
    """K1, K5, K7 and K8 launches of the re-search process (``search_cli
    --topup-trials`` at ``--until 2`` over the seeded base run, the async
    pipeline): no fold retrains (the seeded checkpoints are at the run's
    epochs), so K8 0; each new trial is its key (1 K7) and one TTA call a
    valid batch (2 a fold); the audit recomputes each fold's identity
    baseline (2 calls a fold) and scores the final sub-policies the base
    run's ``audit.json`` does not hold (through the TTA step up to 4, else
    the audit step in chunks of 8 with two key fold_ins each); each graph
    (the trials' policy shape, the single-sub shape, the audit step's) adds
    a warm-up call.  A TTA or audit call: ``augment_plan`` K1, 1 K5, 3 K7."""
    from fast_autoaugment_tpu_torch.ops import _kernels

    base_log, cand_log = (_read_json(os.path.join(d, "search_trials.json")) for d in (base, cand))
    folds = sorted(base_log)
    new_trials = sum(len(cand_log[f]) - len(base_log[f]) for f in folds)
    base_audit, audit = (_read_json(os.path.join(d, "audit.json")) for d in (base, cand))
    same = base_audit["audit_folds"] == audit["audit_folds"] and all(
        abs(base_audit["fold_baselines"][str(f)] - audit["fold_baselines"][str(f)]) < 1e-6
        for f in audit["audit_folds"])
    cached = {json.dumps(s["sub_policy"]) for s in base_audit["scores"]} if same else set()
    audited = sum(json.dumps(s["sub_policy"]) not in cached for s in audit["scores"])
    n_audit = len(audit["audit_folds"])
    valid = 2
    calls = new_trials * valid + len(folds) * valid + n_audit * valid * (
        audited if audited <= 4 else -(-audited // 8))
    warm = (1 if new_trials else 0) + 1 + (1 if audited > 4 else 0)
    keys = new_trials + (2 * n_audit * -(-audited // 8) if audited > 4 else 0)
    per_call = _kernels.augment_plan(32, 32, 2).launches
    want = dict.fromkeys(ALL_KERNELS, 0)
    want.update(augment=per_call * (calls + warm), cifar_stack=calls + warm,
                sampler=TTA_CALL_SAMPLER * (calls + warm) + keys)
    return {"launches": want, "new_trials": new_trials, "audited": audited,
            "audit_cache_reused": same}


def _stats_of(fleet: dict) -> dict:
    return {f"replica{i}": r.get("/stats") for i, r in enumerate(fleet["replicas"])}


def _control_arm_a(fleet: dict, base_dir: str, baseline: str, go: threading.Event,
                   out: dict) -> None:
    """(a): the full loop on `fleet` with a real warm-started re-search.  The
    controller starts once the router is up (its start overlaps the
    replicas'), the traffic once `go` is set (every replica in rotation)."""
    root, tel = fleet["root"], fleet["telemetry"]
    runner = os.path.join(root, "research_host.py")
    with open(runner, "w") as fh:
        fh.write(FLEET_RUNNER.format(repo=REPO, cli="search_cli"))
    research_argv = CONTROL_HOST_ARGS + _search_argv("{out}", SEARCH_EPOCHS, until=2, extra=[
        "--topup-trials", str(CONTROL_TOPUP), "--async-pipeline", "on"])
    research_cmd = " ".join(shlex.quote(a) for a in [sys.executable, runner, *research_argv])
    rt = fleet["router"]
    rt.wait_ready()
    stats_file = os.path.join(root, "control_stats.json")
    ctl = _cli_process("control_cli", [
        "--telemetry", tel, "--port-dir", fleet["ports"], "--router-url",
        f"http://127.0.0.1:{rt.port}", "--baseline-policy", baseline, "--base-search-dir",
        base_dir, "--research-cmd", research_cmd, "--candidate-dir",
        os.path.join(root, "research"), "--gate-polls", "2", "--poll-interval", "0.3",
        "--stats-file", stats_file, *CONTROL_FLAGS], os.path.join(root, "control.log"))
    out.update(ctl=ctl, research_cmd=research_cmd, stats_file=stats_file)
    traffic = None
    try:
        _wait_watching(ctl)
        if not go.wait(CONTROL_DEADLINE_S) or out.get("abort"):
            return
        traffic = out["traffic"] = _Traffic(rt.port)
        out["decision"] = _wait_event(tel, lambda e: e["type"] in ("promote", "rollback") or (
            e["type"] == "mark" and e.get("event") == "research_failed"), [ctl],
            CONTROL_DEADLINE_S, "a promote")
        time.sleep(CONTROL_AFTER_S)
    finally:
        if traffic is not None:
            traffic.stop()
            out["stats"] = _stats_of(fleet)
        out["ctl_rc"] = _stop_proc(ctl)


def _control_arm_b(fleet: dict, baseline: str, candidate: str, go: threading.Event,
                   out: dict) -> None:
    """(b): ``control_cli --candidate-policy`` SIGKILLed once its canary
    split is armed on the router, then ``--resume`` to a promote (the first
    controller starts once the router is up, the traffic once `go` is
    set; ``out["abort"]`` then means the fleet never came up)."""
    root, tel, rt = fleet["root"], fleet["telemetry"], fleet["router"]
    rt.wait_ready()
    common = ["--telemetry", tel, "--port-dir", fleet["ports"], "--router-url",
              f"http://127.0.0.1:{rt.port}", "--baseline-policy", baseline,
              "--candidate-policy", candidate, *CONTROL_FLAGS]
    # a wide gate window, so that the kill lands mid-canary
    first = _cli_process("control_cli", common + [
        "--gate-polls", "40", "--gate-timeout-polls", "200", "--poll-interval", "0.5"],
        os.path.join(root, "control_first.log"))
    procs = [first]
    traffic = None
    try:
        _wait_watching(first)
        if not go.wait(CONTROL_DEADLINE_S) or out.get("abort"):
            return
        traffic = out["traffic"] = _Traffic(rt.port, seed=6)
        armed = _wait_for(lambda: json.loads(rt.request("/stats")[2]).get("canary")
                          if first.poll() is None else fail(
                              f"control_main_path (b): the first controller exited "
                              f"{first.returncode}: {_tail(first.log_path)}"),
                          CONTROL_DEADLINE_S, "the first controller's canary split")
        first.kill()
        first.wait(timeout=30)
        out["killed_at"] = time.time()
        time.sleep(1.0)
        out["armed"] = armed
        out["dangling"] = json.loads(rt.request("/stats")[2]).get("canary")
        stats_file = os.path.join(root, "resume_stats.json")
        second = _cli_process("control_cli", common + [
            "--gate-polls", "2", "--poll-interval", "0.3", "--resume", "--stats-file",
            stats_file], os.path.join(root, "control_resume.log"))
        procs.append(second)
        out["decision"] = _wait_event(tel, lambda e: e["type"] in ("promote", "rollback"),
                                      [second], CONTROL_DEADLINE_S, "the resumed promote")
        time.sleep(CONTROL_AFTER_S)
    finally:
        if traffic is not None:
            traffic.stop()
            out["stats"] = _stats_of(fleet)
            out["router_canary_after"] = json.loads(rt.request("/stats")[2]).get("canary")
        out["rcs"] = [_stop_proc(p) for p in procs]
        out["stats_file"] = os.path.join(root, "resume_stats.json")


def _shift_and_detection(events: list, drift: dict) -> dict:
    """The shift's first dispatch on each replica (its
    :data:`CONTROL_DRIFT_DISPATCH`-th journaled ``serve_dispatch``; the
    journal's 50-a-second budget per replica keeps every dispatch up to
    it), and the detection latency to the ``drift`` verdict in seconds and
    in journaled shifted dispatches up to the sample that tripped it."""
    by_host: dict = {}
    for e in events:
        if e["type"] == "dispatch" and e.get("label") == "serve_dispatch":
            by_host.setdefault(e["host"], []).append(e)
    shift_seq, means = {}, {}
    for host, recs in by_host.items():
        recs.sort(key=lambda e: e["seq"])
        if len(recs) >= CONTROL_DRIFT_DISPATCH:
            shift_seq[host] = recs[CONTROL_DRIFT_DISPATCH - 1]["seq"]
            before = [r["input_mean"] for r in recs[:CONTROL_DRIFT_DISPATCH - 1]]
            means[host] = (float(np.mean(before)),
                           recs[CONTROL_DRIFT_DISPATCH - 1]["input_mean"])
    first = min((r["t_wall"] for h, recs in by_host.items() for r in recs
                 if h in shift_seq and r["seq"] == shift_seq[h]), default=None)
    trip = next((r for r in by_host.get(drift.get("source_host"), [])
                 if r["seq"] == drift.get("source_seq")), None)
    shifted = sum(1 for h, recs in by_host.items() for r in recs
                  if h in shift_seq and r["seq"] >= shift_seq[h] and trip is not None
                  and r["t_wall"] <= trip["t_wall"])
    return {"shift_first_dispatch_wall": first, "replicas_shifted": len(shift_seq),
            "input_mean_before_and_at_shift": means,
            "detection_s": drift["t_wall"] - first if first is not None else None,
            "detection_dispatches": shifted, "verdict": {k: drift.get(k) for k in (
                "id", "metric", "direction", "stat", "threshold", "sample", "value",
                "baseline_mean", "baseline_sigma")}}


def phase_control_main_path(workdir: str, card: str, serial: dict) -> dict:
    """``control_main_path``: the closed control loop
    (``launch/control_cli.py``, ``control/``) actuating two routed fleets of
    the port's replicas on the card, side by side, each of three ``serve_cli
    --traffic-stats`` replicas serving ``fa_reduced_cifar10`` (grouped,
    32x32) behind ``router_cli``, with :data:`CONTROL_CLIENTS` closed-loop
    clients through the router from before the drift to after the
    promotion and ``FAA_FAULT=drift@dispatch=24,shift=60`` on every replica.

    (a) The full loop: ``control_cli --research-cmd`` running the port's
    ``search_cli --topup-trials 2 --until 2 --async-pipeline on`` on the
    search cell's geometry over a directory seeded from `serial`'s run; the
    journal holds ``drift`` -> ``research`` -> ``canary`` -> ``promote`` of
    one episode in that order; the promoted digest is the candidate's
    provenance sidecar's and every replica's after; the top-up's trial logs
    keep the base entries bitwise and add 2 trials a fold; no request fails.
    (b) The crash drill: ``control_cli --candidate-policy`` (a copy of the
    base run's final policy) SIGKILLed once its canary split is armed on the
    router, which then holds a dangling split; ``control_cli --resume``
    re-asserts it and promotes; the split is cleared; no request fails.
    Every replica's K7 and K1 launches and the re-search's K1, K5, K7 and K8
    launches equal their predictions (:func:`_replica_launches`,
    :func:`_research_expected_launches`).  Prints detection latency,
    re-search wall, canary -> verdict wall, requests/s and p50/p99 before
    the drift, during the canary and after the promotion."""
    import shutil

    from fast_autoaugment_tpu_torch.control.research import policy_file_digest
    from fast_autoaugment_tpu_torch.control import select_canary_replicas
    from fast_autoaugment_tpu_torch.policies.archive import load_policy

    t_phase = time.time()
    root = os.path.join(workdir, "control")
    roots = {k: os.path.join(root, k) for k in ("a", "b")}
    for d in roots.values():
        os.makedirs(d)
    baseline = os.path.join(root, "baseline.json")
    with open(baseline, "w") as fh:
        json.dump([[list(op) for op in sub] for sub in load_policy("fa_reduced_cifar10")], fh)
    candidate_b = os.path.join(roots["b"], "candidate.json")
    shutil.copy2(os.path.join(serial["save_dir"], "final_policy.json"), candidate_b)
    digests = {"baseline": policy_file_digest(baseline), "b": policy_file_digest(candidate_b)}
    fleets = {k: _control_fleet(roots[k], baseline, k) for k in ("a", "b")}
    arms: dict = {"a": {}, "b": {}}
    go = threading.Event()
    errors = {}

    def run(k, fn, *args):
        try:
            fn(*args)
        except (Exception, SystemExit) as e:  # an arm's failure (fail() included) is the phase's
            errors[k] = f"{type(e).__name__}: {e}"

    threads = [threading.Thread(target=run, args=("a", _control_arm_a, fleets["a"],
                                                     serial["save_dir"], baseline, go,
                                                     arms["a"]), daemon=True),
               threading.Thread(target=run, args=("b", _control_arm_b, fleets["b"], baseline,
                                                     candidate_b, go, arms["b"]), daemon=True)]
    try:
        for t in threads:
            t.start()
        for f in fleets.values():
            for p in f["replicas"] + [f["router"]]:
                p.wait_ready()
        for f in fleets.values():
            _wait_for(lambda f=f: json.loads(f["router"].request("/readyz")[2]).get(
                "in_rotation") == 3, 120, "three replicas in the router's rotation")
        t_ready = time.time()
        go.set()
        for t in threads:
            t.join(timeout=2 * CONTROL_DEADLINE_S + 240)
        if errors:
            fail(f"control_main_path: {errors}")
    finally:
        if not go.is_set():  # the fleets never came up: the arms stop their controllers
            for arm in arms.values():
                arm["abort"] = True
            go.set()
        for t in threads:
            t.join(timeout=120)
        procs = [p for f in fleets.values() for p in f["replicas"] + [f["router"]]]
        for p in procs:  # every drain at once, then the waits
            if p.proc.poll() is None:
                p.proc.send_signal(signal.SIGTERM)
        for p in procs:
            p.stop()
    problems = []

    # ---- (a)'s checks
    a, tel_a = arms["a"], fleets["a"]["telemetry"]
    events = _journal(tel_a)
    loop = [e for e in events if e["type"] in ("drift", "research", "promote", "rollback")
            or (e["type"] == "canary" and e.get("action") == "rollout")]
    chain = [e["type"] for e in sorted(loop, key=lambda e: e["t_wall"])]
    drift = next((e for e in events if e["type"] == "drift"), {})
    research = next((e for e in events if e["type"] == "research"), {})
    rollouts = [e for e in events if e["type"] == "canary" and e.get("action") == "rollout"]
    promote = next((e for e in events if e["type"] == "promote"), {})
    cand_dir = os.path.join(roots["a"], "research", "episode1")
    prov = _read_json(os.path.join(cand_dir, "final_policy.provenance.json")) \
        if os.path.exists(os.path.join(cand_dir, "final_policy.provenance.json")) else {}
    base_log = _read_json(os.path.join(serial["save_dir"], "search_trials.json"))
    cand_log = _read_json(os.path.join(cand_dir, "search_trials.json")) \
        if os.path.exists(os.path.join(cand_dir, "search_trials.json")) else {}
    n_base = {f: len(base_log[f]) for f in base_log}
    with open(a["ctl"].log_path, errors="replace") as fh:
        ctl_lines = fh.read().splitlines()
    research_launches = next((json.loads(ln.split("LAUNCHES ", 1)[1]) for ln in ctl_lines
                              if ln.startswith("LAUNCHES ")), None)
    research_want = _research_expected_launches(serial["save_dir"], cand_dir) \
        if cand_log else {"launches": None}
    detect = _shift_and_detection(events, drift) if drift else {}
    stats_a = a.get("stats", {})
    replicas_a = {}
    for tag, st in stats_a.items():
        got, want = _replica_launches(st, 1)
        replicas_a[tag] = {"launches": got, "expected": want, "reloads": st["reloads"],
                           "dispatches": st["dispatches"], "digest": st["policy_digest"],
                           "provenance_digest": (st.get("policy_provenance") or {}).get(
                               "policy_digest"), "traffic_samples": st["traffic"]["samples"]}
    loop_stats = _read_json(a["stats_file"]) if os.path.exists(a["stats_file"]) else {}
    canary_expected = select_canary_replicas(promote.get("digest", ""), list(stats_a), 1) \
        if promote else None
    checks_a = {
        "chain_in_order": chain == ["drift", "research", "canary", "promote"],
        "one_episode": len([e for e in events if e["type"] == "drift"]) == 1
        and loop_stats.get("promotes") == 1 and loop_stats.get("rollbacks") == 0,
        "drift_after_the_shift": bool(detect) and detect["detection_s"] is not None
        and detect["detection_s"] >= 0 and detect["replicas_shifted"] == 3,
        "promoted_is_candidate": bool(promote) and promote["digest"] == prov.get(
            "policy_digest") == research.get("digest") != digests["baseline"],
        "every_replica_on_it": bool(stats_a) and all(
            r["digest"] == r["provenance_digest"] == promote.get("digest")
            for r in replicas_a.values()),
        "canary_by_rendezvous": sorted({e["replica"] for e in rollouts}) == canary_expected,
        "no_failed_request": not a["traffic"].failures(),
        "base_trials_bitwise": bool(cand_log) and all(
            json.dumps(cand_log[f][:n]) == json.dumps(base_log[f])
            and len(cand_log[f]) == n + CONTROL_TOPUP for f, n in n_base.items()),
        "warm_start_stamped": (_read_json(os.path.join(cand_dir, "search_result.json"))
                               .get("warm_start") or {}).get("topup_trials") == CONTROL_TOPUP
        if cand_log else False,
        "replica_launches": bool(replicas_a) and all(
            r["launches"] == r["expected"] and r["reloads"] == 1 for r in replicas_a.values()),
        "research_launches": research_launches == research_want["launches"],
        "control_exit_0": a.get("ctl_rc") == 0,
    }
    tr = a["traffic"]
    t_shift = detect.get("shift_first_dispatch_wall") or tr.t0
    t_canary = rollouts[0]["t_wall"] if rollouts else None
    t_promote = promote.get("t_wall")
    out_a = {"phase": "control_main_path", "part": "loop", "card": card, "checks": checks_a,
             "chain": chain, "detection": detect,
             "research_wall_s": research.get("wall_sec"),
             "canary_to_verdict_s": t_promote - t_canary if t_promote and t_canary else None,
             "detect_to_promote_s": promote.get("detect_to_promote_sec"),
             "traffic": {"before_drift": tr.window(tr.t0, t_shift),
                         "drift_to_canary": tr.window(t_shift, t_canary or t_shift),
                         "canary": tr.window(t_canary, t_promote)
                         if t_canary and t_promote else None,
                         "after_promotion": tr.window(t_promote, tr.t1) if t_promote else None,
                         "failed": len(tr.failures()), "errors": tr.failures()[:3],
                         "clients": CONTROL_CLIENTS, "images_per_request": CONTROL_IMAGES},
             "promoted_digest": promote.get("digest"), "baseline_digest": digests["baseline"],
             "canary": sorted({e["replica"] for e in rollouts}),
             "gate_evidence": promote.get("evidence"),
             "research": {"launches": research_launches, **research_want,
                          "warm_start": _read_json(os.path.join(
                              cand_dir, "search_result.json")).get("warm_start")
                          if cand_log else None,
                          "trials_per_fold": {f: len(v) for f, v in cand_log.items()}},
             "replicas": replicas_a, "research_cmd": a.get("research_cmd")}
    emit(out_a)
    if not all(checks_a.values()):
        problems.append("(a) " + str({k: v for k, v in checks_a.items() if not v}) + " "
                        + "\n".join(ctl_lines[-40:]))

    # ---- (b)'s checks
    b, tel_b = arms["b"], fleets["b"]["telemetry"]
    events_b = _journal(tel_b)
    drift_b = next((e for e in events_b if e["type"] == "drift"), {})
    promote_b = next((e for e in events_b if e["type"] == "promote"), {})
    resumes = [e for e in events_b if e["type"] == "mark" and e.get("event") == "resume"]
    rollouts_b = [e for e in events_b if e["type"] == "canary" and e.get("action") == "rollout"]
    stats_b = b.get("stats", {})
    canary_b = sorted({e["replica"] for e in rollouts_b})
    replicas_b = {}
    for tag, st in stats_b.items():
        got, want = _replica_launches(st, 2 if tag in canary_b else 1)
        replicas_b[tag] = {"launches": got, "expected": want, "reloads": st["reloads"],
                           "dispatches": st["dispatches"], "digest": st["policy_digest"]}
    resume_stats = _read_json(b["stats_file"]) if os.path.exists(b["stats_file"]) else {}
    checks_b = {
        "dangling_split_after_kill": (b.get("dangling") or {}).get("digest") == digests["b"],
        "resumed_at_canary": bool(resumes) and resumes[0].get("stage") == "canary"
        and resumes[0].get("digest") == digests["b"],
        "promoted_after_resume": promote_b.get("digest") == digests["b"]
        and promote_b.get("drift_id") == drift_b.get("id")
        and promote_b.get("pid") != drift_b.get("pid"),
        "split_cleared": b.get("router_canary_after", "unread") is None,
        "every_replica_on_it": bool(stats_b) and all(r["digest"] == digests["b"]
                                                     for r in replicas_b.values()),
        "one_promote": resume_stats.get("promotes") == 1
        and resume_stats.get("rollbacks") == 0 and resume_stats.get("state") == "watching",
        "no_failed_request": not b["traffic"].failures(),
        "replica_launches": bool(replicas_b) and len(canary_b) == 1 and all(
            r["launches"] == r["expected"] for r in replicas_b.values()),
        "resumed_exit_0": (b.get("rcs") or [None, None])[1] == 0,
    }
    trb = b["traffic"]
    out_b = {"phase": "control_main_path", "part": "crash_drill", "card": card,
             "checks": checks_b, "candidate_digest": digests["b"],
             "kill_to_promote_s": promote_b["t_wall"] - b["killed_at"]
             if promote_b and b.get("killed_at") else None,
             "traffic": {"all": trb.window(trb.t0, trb.t1), "failed": len(trb.failures()),
                         "errors": trb.failures()[:3]},
             "canary": canary_b, "replicas": replicas_b, "rcs": b.get("rcs")}
    emit(out_b)
    if not all(checks_b.values()):
        problems.append("(b) " + str({k: v for k, v in checks_b.items() if not v}) + " "
                        + _tail(os.path.join(roots["b"], "control_resume.log"), 2000))
    if problems:
        fail("control_main_path: " + "; ".join(problems))
    replica_total = _sum_launches([r["launches"] for r in replicas_a.values()]
                                  + [r["launches"] for r in replicas_b.values()])
    out = {"phase": "control_main_path", "part": "summary", "card": card,
           "wall_s": time.time() - t_phase, "fleets_ready_s": t_ready - t_phase,
           "launches_replicas": replica_total, "launches_research": research_launches}
    emit(out)
    return {"launches": _sum_launches([replica_total, research_launches]), **out}


# ------------------------------------------------------------ game days

#: the device every game-day replica serves on (a CPU rehearsal puts "cpu")
GAMEDAY_DEVICE = "cuda"
#: the JAX package's smoke factor (``make gameday-smoke``)
GAMEDAY_SMOKE = 0.4
#: the longest the smoke suite may take (seconds)
GAMEDAY_TIMEOUT_S = 600


def _gameday_replica_launches(rep: dict) -> tuple[dict, dict, dict]:
    """A game-day replica's launch counters against the prediction: every
    graph build (the start, each reload, each tenant admit) is a warm-up
    call a padded shape, every dispatch one CUDA-graph replay of one K7 and
    ``augment_plan`` K1 launches; nothing else.  Returns ``(launches,
    expected launches, expected warm-up launches)``."""
    from fast_autoaugment_tpu_torch.ops import _kernels

    image = 8  # scenario.Plane.image of every registered scenario
    per_call = _kernels.augment_plan(image, image, int(rep["num_op"])).launches
    warm = len(rep["shapes"]) * (1 + int(rep["reloads"]) + int(rep["tenant_admits"]))
    want, want_warm = dict.fromkeys(ALL_KERNELS, 0), dict.fromkeys(ALL_KERNELS, 0)
    want.update(augment=per_call * (warm + int(rep["dispatches"])),
                sampler=warm + int(rep["dispatches"]))
    want_warm.update(augment=per_call * warm, sampler=warm)
    return rep["kernel_launches"], want, want_warm


def phase_gameday_main_path(workdir: str, card: str) -> dict:
    """``gameday_main_path``: the port's ``launch/gameday_cli.py --suite
    --smoke --device cuda --keep`` as a subprocess (every registered
    scenario at the JAX package's smoke factor, each over a live plane of
    the port's ``serve_cli`` replicas on the card behind ``router_cli``,
    with the autoscaler and ``control_cli`` where the scenario has them).
    Checks: exit 0 (the suite green); every ``expect="pass"`` scenario
    passes every predicate; ``flash-crowd-10x-noshed`` fails with
    ``shed_not_hang`` among its failing rows; each record's schedule digest
    is ``schedule_digest`` of ``scaled(scenario, 0.4)`` at its seed;
    ``no_shm_leak`` holds everywhere; every replica of every scenario
    reported (its ``serve_exit`` mark, or its ``/stats`` before a SIGKILL;
    a replica the autoscaler started too late to enter the router's
    rotation, and whose scale-down ended it by SIGTERM or SIGKILL before it
    could journal, served nothing and has no counters: it is listed as
    ``never_served`` with that exit; any other end fails) and ran on the card; its K7
    and K1 launches equal
    :func:`_gameday_replica_launches`' prediction, and no replica launched
    K5, K6 or K8.  Prints a line a scenario: elapsed and bring-up seconds,
    offered/completed/ok/shed/hung, p50/p99 of the answered requests,
    goodput, scale-ups and the control decision."""
    import glob

    from fast_autoaugment_tpu_torch.gameday import SCENARIOS, build_schedule, scaled
    from fast_autoaugment_tpu_torch.gameday import schedule_digest

    t_phase = time.time()
    root = os.path.join(workdir, "gameday")
    os.makedirs(root)
    out_json, log = os.path.join(root, "gameday.json"), os.path.join(root, "gameday.log")
    argv = [sys.executable, "-m", "fast_autoaugment_tpu_torch.launch.gameday_cli", "--suite",
            "--smoke", "--smoke-factor", str(GAMEDAY_SMOKE), "--device", GAMEDAY_DEVICE,
            "--out", out_json, "--keep"]
    # the runner's scenario dirs go under `root` (tempfile reads TMPDIR); its
    # own session, so that a timeout stops every process of the suite
    with open(log, "w") as fh:
        proc = subprocess.Popen(argv, cwd=REPO, env=dict(os.environ, TMPDIR=root), stdout=fh,
                                stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=GAMEDAY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            fail(f"gameday_main_path: the suite ran past {GAMEDAY_TIMEOUT_S} s: {_tail(log)}")
    wall = time.time() - t_phase
    if not os.path.exists(out_json):
        fail(f"gameday_main_path: exit {rc} and no suite JSON: {_tail(log)}")
    suite = _read_json(out_json)
    kept = glob.glob(os.path.join(root, "faa-gameday-*"))
    problems, rows = [], []
    totals = dict.fromkeys(ALL_KERNELS, 0)
    by_name = {r["scenario"]: r for r in suite["records"]}
    if sorted(by_name) != sorted(SCENARIOS) or len(kept) != 1:
        problems.append(f"records {sorted(by_name)} of {sorted(SCENARIOS)}, kept dirs {kept}")
    for name, rec in by_name.items():
        spec = scaled(SCENARIOS[name], GAMEDAY_SMOKE)
        failing = [r["predicate"] for r in rec["predicates"] if not r["ok"]]
        rep = rec.get("report") or {}
        journal = _journal(os.path.join(kept[0], name, "telemetry")) if kept else []
        terminal = [e for e in journal if e["type"] in ("promote", "rollback")]
        replicas = rec.get("replicas") or {}
        launch_rows = {}
        for tag, r in replicas.items():
            if r.get("source") == "never_served":  # stopped while it started
                launch_rows[tag] = r
                if r.get("cause") != "scale_down" or r.get("exit_code") not in (
                        -signal.SIGTERM, -signal.SIGKILL):
                    problems.append(f"{name}: {tag} never served and was not stopped ({r})")
                continue
            if r.get("source") not in ("serve_exit", "killed_stats"):
                problems.append(f"{name}: {tag} left no launch counters ({r})")
                continue
            got, want, want_warm = _gameday_replica_launches(r)
            launch_rows[tag] = {"source": r["source"], "device": r["device"],
                                "dispatches": r["dispatches"], "reloads": r["reloads"],
                                "tenant_admits": r["tenant_admits"], "launches": got,
                                "expected": want}
            for k in ALL_KERNELS:
                totals[k] += got.get(k, 0)
            if not str(r["device"]).startswith(GAMEDAY_DEVICE):
                problems.append(f"{name}: {tag} served on {r['device']}")
            if launches_differ(got, want) or launches_differ(r["kernel_launches_warmup"],
                                                             want_warm):
                problems.append(f"{name}: {tag} launches {got} (warm-up "
                                f"{r['kernel_launches_warmup']}) != {want} ({want_warm})")
        checks = {
            "no_harness_error": rec.get("error") is None,
            "verdict_as_expected": rec["ok_as_expected"]
            and (not failing if spec.expect == "pass" else "shed_not_hang" in failing),
            "schedule_digest": rec["schedule_digest"] == schedule_digest(
                build_schedule(spec.traffic, spec.seed)),
            "no_shm_leak": "no_shm_leak" not in failing and rep.get("shm_leftover") == [],
            "on_the_card": rec.get("device") == GAMEDAY_DEVICE and any(
                r.get("source") != "never_served" for r in replicas.values()),
        }
        line = {"phase": "gameday_main_path", "part": name, "card": card, "checks": checks,
                "expect": spec.expect, "pass": rec["pass"], "failing": failing,
                "elapsed_s": rec.get("elapsed_s"), "bring_up_s": rec.get("bring_up_s"),
                **{k: rep.get(k) for k in ("offered", "completed", "ok", "shed",
                                           "transport_errors", "p50_ms_ok", "p99_ms_ok",
                                           "goodput")},
                "scale_ups": sum(e["type"] == "scale_up" for e in journal),
                "scale_downs": sum(e["type"] == "scale_down" for e in journal),
                "control_decision": terminal[-1]["type"] if terminal else None,
                "killed": rec.get("killed"), "exit_codes": rec.get("exit_codes"),
                "replicas": launch_rows}
        emit(line)
        rows.append(line)
        if not all(checks.values()):
            problems.append(f"{name}: {[k for k, v in checks.items() if not v]}")
    if totals["train_noise"] or totals["cifar_stack"] or totals["imagenet_stack"]:
        problems.append(f"the game day launched K5, K6 or K8: {totals}")
    out = {"phase": "gameday_main_path", "part": "summary", "card": card, "rc": rc,
           "suite_green": suite.get("suite_green"), "wall_s": wall,
           "smoke_factor": suite.get("smoke_factor"), "launches": totals,
           "table": suite.get("table")}
    emit(out)
    if rc != 0 or not suite.get("suite_green"):
        problems.append(f"gameday_cli exited {rc}, suite_green {suite.get('suite_green')}")
    if problems:
        fail("gameday_main_path: " + "; ".join(problems) + "\n" + _tail(log, 4000))
    return out


# ------------------------------------------------------------ train path

TRAIN_STAGES = ("train.sampler", "train.augment", "train.model", "train.optimizer")
TRAIN_STEPS = 10
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
    """An augment_fn that keeps its outputs.  It carries the wrapped
    function's ``record`` where that has one, so a train step draws the
    record in its one launch and calls :meth:`apply`."""

    def __init__(self, fn):
        self.fn, self.out = fn, []
        if hasattr(fn, "record"):
            self.record = fn.record

    def _keep(self, x):
        self.out.append(x.detach().clone())
        return x

    def apply(self, images, policy, draws):
        return self._keep(self.fn.apply(images, policy, draws))

    def __call__(self, images, policy, key, src):
        return self._keep(self.fn(images, policy, key, src))


def _copy_state(state):
    """A separate copy of a train state: its own model, optimizer state and
    EMA shadow."""
    import copy

    from fast_autoaugment_tpu_torch.train import steps

    return steps.TrainState(step=state.step, model=copy.deepcopy(state.model),
                            opt_state=copy.deepcopy(state.opt_state),
                            ema=None if state.ema is None else
                            {k: v.clone() for k, v in state.ema.items()})


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
            "imagenet_stack": k6_f32 * calls + k6_u8,
            **_step_draw_launches(calls + 1)}
    if launches_differ(counts, want):
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
    every epoch, launch counts set to 0 just before and read just after; the
    default device cache replays one CUDA graph a step after one warm-up
    step."""
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
    # the default device cache: one CUDA graph (N = 1), one warm-up step
    want = _dispatch_expected_launches(512 // c["batch"], 2, 1, evals, True)
    out = {"phase": "train_flagship", "conf": conf, "result": result, "launches": counts,
           "expected_launches": want, "train_steps": steps, "eval_batches": evals}
    emit(out)
    if set(result) != TRAIN_RESULT_KEYS or not all(np.isfinite(list(result.values()))):
        fail(f"train_and_eval result is malformed: {sorted(result)}")
    if launches_differ(counts, want) or result["epoch"] != 2 or result["num_test"] != 256:
        fail(f"train_and_eval launch counts {counts} != {want}, or epochs/counts wrong")
    out["imported"] = _train_flagship_imported(dev, conf)
    return out


def _train_flagship_imported(dev, conf: dict) -> dict:
    """The flagship resumed from an imported checkpoint: a WRN-40-2
    checkpoint with the reference importer's record (``imported_from``,
    ``has_ema`` false; weights and BatchNorm statistics of a seeded model,
    no optimizer state, epoch 1) written on the card by the port's writer,
    then ``train_and_eval`` with an EMA of 0.999 resumed from it for the last
    epoch, and once more from the file at the last epoch (an evaluation).
    Checks: only epoch 2 trains, the step after it is 2 epochs' (the
    schedule placed at the resume epoch), the EMA is seeded from the imported
    weights (the evaluation's EMA metrics equal its raw ones), and K1, K5 and
    K8 launch as :func:`_dispatch_expected_launches` predicts (the EMA
    evaluates each test batch twice)."""
    import tempfile

    from fast_autoaugment_tpu_torch.core.checkpoint import read_metadata, save_checkpoint
    from fast_autoaugment_tpu_torch.models import get_model
    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
    from fast_autoaugment_tpu_torch.train.steps import create_train_state
    from fast_autoaugment_tpu_torch.train.trainer import train_and_eval
    from fast_autoaugment_tpu_torch.utils.interop import train_state_to_flax

    conf = dict(conf, optimizer=dict(conf["optimizer"], ema=0.999))
    spe, evals = 512 // conf["batch"], 2 * -(-256 // conf["batch"])
    model = get_model(dict(conf["model"], dataset="synthetic"), 10, device=dev, seed=7)
    opt = build_optimizer(conf["optimizer"], lambda c: 0.0)
    tree = train_state_to_flax(create_train_state(model, opt, use_ema=False), opt)
    meta = {"epoch": 1, "imported_from": "wrn40_2.pth", "has_ema": False}
    runs, counts = {}, dict.fromkeys(ALL_KERNELS, 0)
    with tempfile.TemporaryDirectory() as d:
        for name, epochs in (("train", 2), ("eval", 1)):
            path = os.path.join(d, f"{name}.msgpack")
            save_checkpoint(path, {k: tree[k] for k in ("step", "params", "batch_stats")},
                            meta)
            _kernels.reset_launch_counts()
            result = train_and_eval(dict(conf, epoch=epochs), "", save_path=path,
                                    evaluation_interval=1, device=dev)
            got = _kernels.launch_counts()
            counts = {k: counts[k] + got[k] for k in ALL_KERNELS}
            runs[name] = {"result": result, "launches": got, "meta": read_metadata(path)}
    want = {"train": _dispatch_expected_launches(spe, 1, 1, evals, True),
            "eval": {"cifar_stack": evals}}
    train, ev = runs["train"], runs["eval"]
    checks = {
        "only_epoch_2_trained": train["result"]["epoch"] == 2 and train["meta"]["epoch"] == 2
        and "imported_from" not in train["meta"],
        "step_at_resume_epoch": train["meta"]["step"] == 2 * spe,
        "ema_seeded_from_imported": ev["result"]["epoch"] == 1
        and "loss_train" not in ev["result"] and all(
            ev["result"][f"{m}_test_ema"] == ev["result"][f"{m}_test_raw"]
            for m in ("loss", "top1", "top5")),
        "finite": all(np.isfinite(v) for r in runs.values() for v in r["result"].values()),
        "launches": not any(launches_differ(runs[k]["launches"], want[k]) for k in runs),
    }
    out = {"phase": "train_flagship", "part": "imported_resume", "checks": checks,
           "launches": counts, "expected_launches": want, "runs": runs}
    emit(out)
    if not all(checks.values()):
        fail(f"train_flagship imported resume: {[k for k, v in checks.items() if not v]}")
    return out


def phase_train_times(dev, st: dict, card: str) -> dict:
    """K1 and K6 at the ResNet-50 step's shape (128x224x224, with a step's
    draws) against their bounds and plain versions.  The step itself is
    timed and traced on JPEG-fed batches by ``imagenet_main_path``."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as pi
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    c = RESNET50
    b, image = c["batch"], st["image"]
    plan = _kernels.augment_plan(image, image, int(st["policy"].shape[1]))

    # K1 and K6 at the step's shape, with the step's draws
    x, _ = st["batches"][0]
    pol = st["policy"]
    d = PhiloxDraws().imagenet_draws(torch.tensor([0, 5], device=dev), batch=b,
                                     policy_shape=tuple(pol.shape[:2]), height=image,
                                     width=image, dispatch="exact", groups=8, device=dev)
    xf = x.to(torch.float32).contiguous()
    call = lambda c=None: _kernels.augment(xf, pol, d.sub_idx, d.policy, cluster=c)  # noqa: E731
    y1 = call()
    elems = xf.numel()
    k1 = {"kernel": "augment", "shape": list(xf.shape), "num_op": int(pol.shape[1]),
          "launches_per_call": plan.launches, "cluster": plan.cluster,
          "kernel_ms": kernel_device_ms(call, kernel=plan.kernel, per_call=plan.launches),
          "kernel_event_ms": cuda_ms(call),
          "kernel_graph_ms": graph_ms(call),
          "by_op_graph_ms": k1_op_sweep(xf),
          # both cluster sizes that fit at 224x224, timed alike, and how many
          # clusters of each the card holds at once
          "by_cluster": {str(c): {
              "kernel_ms": kernel_device_ms(lambda c=c: call(c)),
              "kernel_event_ms": cuda_ms(lambda c=c: call(c)),
              "kernel_graph_ms": graph_ms(lambda c=c: call(c)),
              "smem_bytes": _kernels.augment_plan(image, image, 2, c).smem_bytes,
              "threads": _kernels.augment_plan(image, image, 2, c).threads,
              "max_active_clusters": _kernels.augment_max_active_clusters(
                  image, image, cluster=c, device=dev.index or 0)} for c in FORCED_CLUSTERS},
          "plain_ms": cuda_ms(lambda: aug.apply_subpolicy_draws_plain(xf, pol, d.sub_idx,
                                                                     d.policy),
                              iters=3, warmup=1),
          "bytes": k1_bytes(xf, pol)}
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
           "image": image, "k1": k1, "k6": k6,
           "timing": "kernel_ms: device time from torch.profiler over 20 calls; "
                     "kernel_graph_ms, by_op_graph_ms and by_cluster: CUDA-graph replay, as is "
                     "K6's copy_graph_ms (PyTorch copying the same bytes); *_event_ms and "
                     "plain_ms: CUDA events around back-to-back calls (K6's kernel_event_ms: "
                     "the launch alone, 50 calls)"}
    emit(out)
    return out


# -------------------------------------------------- the ImageNet data path

#: the JPEG listing the ImageNet phase writes: 10 classes, 1,280 train and 256
#: val images with sides drawn from 256-512 px (ImageNet photographs'
#: range), seeded smooth content (a small random image upscaled), quality 90
IMAGENET_LISTING = {"classes": 10, "train": 1280, "val": 256, "side": (256, 512),
                    "quality": 90, "seed": 11}
#: the steps of each train_and_eval arm that a profiler traces (after the
#: 6th step's end, through the 9th's)
IMAGENET_TRACE = (6, 9)
#: steps before the traced stretch through which the profiler runs with its
#: records discarded (``schedule`` warm-up): the device's tracing is on
#: before the stretch begins
IMAGENET_TRACE_WARMUP = 2
#: runs of an arm before its traced stretch's kernel records must have
#: equalled the launch counters
IMAGENET_TRACE_ATTEMPTS = 3
#: the search on the listing: 1 fold at cv_ratio 0.4, 1 phase-1 epoch, 2 TPE
#: trials, the top one kept, phases 1-2; the preset's step schedule is defined for 90 or 270
#: epochs only, so a 1-epoch run takes the cosine schedule (same lr and
#: warmup)
IMAGENET_SEARCH_FLAGS = ["--num-fold", "1", "--cv-ratio", "0.4", "--num-search", "2",
                         "--num-top", "1", "--until", "2", "--phase1-epochs", "1",
                         "--fold-quality-floor", "off", "lr_schedule.type=cosine"]


def _write_jpeg_listing(root: str, spec: dict) -> dict:
    """``train/`` and ``val/`` of seeded JPEGs, one ``n0000000c`` folder a
    class, and the Kaggle ``train_cls.txt``/``val_cls.txt`` written by the
    port's ``write_listfile``.  Each image is a random 6x6 image upscaled
    bicubically to a side drawn from ``spec["side"]``, so its content is
    smooth like a photograph's (white noise is unlike any photograph and
    makes the files 5-10x larger); PIL encodes, in threads."""
    from concurrent.futures import ThreadPoolExecutor

    import PIL.Image

    from fast_autoaugment_tpu_torch.data.imagenet_tools import write_listfile

    g = np.random.default_rng(spec["seed"])
    jobs = []
    for split in ("train", "val"):
        for c in range(spec["classes"]):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            per_class, extra = divmod(spec[split], spec["classes"])
            for i in range(per_class + (c < extra)):
                w, h = (int(v) for v in g.integers(spec["side"][0], spec["side"][1] + 1, 2))
                jobs.append((os.path.join(d, f"img{i:04d}.JPEG"), w, h,
                             g.integers(0, 256, (6, 6, 3), dtype=np.uint8)))

    def write(job):
        path, w, h, small = job
        PIL.Image.fromarray(small).resize((w, h), PIL.Image.BICUBIC).save(
            path, quality=spec["quality"])
        return os.path.getsize(path)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        sizes = list(pool.map(write, jobs))
    lines = {split: write_listfile(os.path.join(root, split),
                                   os.path.join(root, f"{split}_cls.txt"))
             for split in ("train", "val")}
    return {"images": len(jobs), "bytes": int(sum(sizes)), "listed": lines,
            "mean_kb": sum(sizes) / len(sizes) / 1024, "write_s": time.perf_counter() - t0}


def _decoder_vs_golden() -> dict:
    """The loader's decode of the golden JPEGs (``tests/data/jpeg_golden``)
    against what libjpeg makes of them, with the tolerance that
    ``data/jpeg_golden.py`` states (0 for the libjpeg build)."""
    from fast_autoaugment_tpu_torch.data import jpeg_golden, native_loader

    name = native_loader.loaded_backend()
    got = jpeg_golden.golden_arrays(native_loader._lib())
    want = dict(np.load(jpeg_golden.GOLDEN_DIR / "libjpeg.npz"))
    d = jpeg_golden.departure(got, want)
    tol = {k: v if name == "nvjpeg" else {"max_abs": 0, "mean_abs": 0.0}
           for k, v in jpeg_golden.NVJPEG_TOLERANCE.items()}
    if not d["sizes_equal"] or d["failures"]:
        fail(f"imagenet_main_path: the decoder misreads the golden JPEGs: {d}")
    return {"decoder": name, "departure": d, "tolerance": tol}


def _imagenet_kernels_vs_plain(dev, root: str) -> dict:
    """K1, K6 and K5 against their plain versions on this phase's own data:
    the first train batch as the trainer decodes it (the native loader,
    ``random_crop_box`` boxes at 224), with the ImageNet draws of one key;
    the train stack (K1 then K6) and the eval stack (K5)."""
    import torch

    from fast_autoaugment_tpu_torch.data.datasets import load_dataset
    from fast_autoaugment_tpu_torch.data.pipeline import BatchIterator, DecodeStats
    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess as pre
    from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as pi
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws
    from fast_autoaugment_tpu_torch.train.trainer import resolve_policy_tensor

    c = RESNET50
    image = int(c.get("imgsize", 0) or 0) or 224
    train, _ = load_dataset("imagenet", root)
    it = BatchIterator(train, None, train_box_fn=lambda rng, w, h: pi.random_crop_box(
        rng, w, h, image), imgsize=image, decoder="native", stats=DecodeStats())
    x, _ = next(iter(it.train_epoch(c["batch"], 1)))
    x = torch.from_numpy(x).to(dev)
    pol = torch.from_numpy(resolve_policy_tensor(c["aug"])).to(dev)
    d = PhiloxDraws().imagenet_draws(torch.tensor([3, 1], device=dev), batch=c["batch"],
                                     policy_shape=tuple(pol.shape[:2]), height=image,
                                     width=image, dispatch="exact", groups=8, device=dev)
    xf = x.to(torch.float32).contiguous()
    y1 = aug.apply_subpolicy_draws(xf, pol, d.sub_idx, d.policy)
    p1 = aug.apply_subpolicy_draws_plain(xf, pol, d.sub_idx, d.policy)
    y6, p6 = pi.imagenet_stack(y1, d), pi.imagenet_stack_plain(p1, d)
    y5 = pi.imagenet_eval_batch(x)
    p5 = pre.cifar_stack_plain(xf, pre.eval_draws(c["batch"], dev), cutout_length=0,
                               mean=pre.IMAGENET_MEAN, std=pre.IMAGENET_STD)
    torch.cuda.synchronize()
    out = {}
    for name, (got, want) in (("augment", (y1, p1)), ("imagenet_stack", (y6, p6)),
                              ("cifar_stack", (y5, p5))):
        diff = (got.float() - want.float()).abs()
        out[name] = {"shape": list(got.shape), "differing_elements": int((diff > 0).sum()),
                     "max_abs_err": float(diff.max()),
                     "finite": bool(torch.isfinite(got.float()).all())}
    out["decoded"] = it.stats.snapshot()
    return out


def _stream_busy(prof, after_ns=None) -> dict:
    """Device time by stream (µs) in a profile, from `after_ns` on the
    device's clock, and whether each is one of
    the decoder's (its kernels all nvJPEG's, or copies only; the training
    stream and cuDNN's and the graph's own streams run other kernels)."""
    from torch.autograd import DeviceType

    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0 \
                or e.is_user_annotation() or e.name().startswith(ANNOTATIONS) \
                or (after_ns is not None and e.start_ns() < after_ns):
            continue
        s = by.setdefault(int(e.device_resource_id()), {"us": 0.0, "activities": 0, "top": {}})
        s["us"] += e.duration_ns() / 1e3
        s["activities"] += 1
        s["top"][e.name()[:60]] = s["top"].get(e.name()[:60], 0.0) + e.duration_ns() / 1e3
    for s in by.values():
        s["decoder"] = all("nvjpeg" in name or name.startswith("Memcpy") for name in s["top"])
        s["top"] = dict(sorted(s["top"].items(), key=lambda kv: -kv[1])[:3])
    return by


def _imagenet_arm(dev, conf: dict, root: str, save: str, graphed: bool) -> dict:
    """One ``train_and_eval`` of `conf` on the listing at `root`, saving to
    `save`: host-fed, each step one CUDA-graph replay (`graphed`) or the
    eager step (``host_step="eager"``), under deterministic cuDNN.  Each
    step is followed by a synchronize (its wall runs from the previous
    step's end, so it holds the wait for the next decoded batch), and steps
    :data:`IMAGENET_TRACE` are profiled, after :data:`IMAGENET_TRACE_WARMUP`
    steps of the profiler's warm-up and the priming.  The idle share is given twice:
    over the union of all the device's work, the decoder's nvJPEG kernels
    and copies included, and over the training's streams alone, both from
    the last priming kernel on the device's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.train import trainer

    marks, window, priming = [], [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    # the builder that train_and_eval calls for this host_step, wrapped to
    # time each step (the eager step itself is picked by the argument)
    builder = "make_graphed_train_step" if graphed else "make_train_step"
    make = getattr(trainer, builder)

    def timed_make(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            out = step(*args)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if len(marks) == IMAGENET_TRACE[0] - IMAGENET_TRACE_WARMUP:
                prof.start()  # the warm-up: tracing on, its records discarded
            elif len(marks) == IMAGENET_TRACE[0]:
                prof.step()  # the recorded stretch
                priming.extend(prime_profiler(dev))
                window.append(time.perf_counter())
            elif len(marks) == IMAGENET_TRACE[1]:
                window.append(marks[-1])
                prof.step()
                prof.stop()
            return out

        return run

    setattr(trainer, builder, timed_make)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = trainer.train_and_eval(conf, root, save_path=save, evaluation_interval=1,
                                        device=dev, host_step="graph" if graphed else "eager")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _kernels.launch_counts()
    finally:
        setattr(trainer, builder, make)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    steps_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    n = IMAGENET_TRACE[1] - IMAGENET_TRACE[0]
    window_s = window[1] - window[0]
    # the decoder works on through the priming: the device's work is taken
    # from the last priming kernel, as the wall from the priming's end
    after = priming_end_ns(prof)
    busy = device_busy(prof, after_ns=after)
    by_stream = _stream_busy(prof, after_ns=after)
    decoder = frozenset(k for k, v in by_stream.items() if v["decoder"])
    training = device_busy(prof, skip_streams=decoder, after_ns=after)
    # every thread's: the decoder's threads launch nvJPEG's kernels and copies
    calls = _host_launches(prof)
    image = int(conf.get("imgsize", 0) or 0) or 224
    plan = _kernels.augment_plan(image, image, 2)
    rows = kernel_counts(prof, (plan.kernel,) + K6_KERNELS)
    seen = {"augment": rows[plan.kernel], "imagenet_stack": sum(rows[k] for k in K6_KERNELS)}
    with open(save, "rb") as fh:
        payload = fh.read()
    return {"result": result, "payload": payload, "wall_s": wall, "launches": counts,
            "steps": len(marks), "step_ms": steps_ms,
            "median_step_ms": float(np.median(steps_ms)) if steps_ms else None,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
            "trace": {"steps": n, "wall_ms_per_step": window_s * 1e3 / n,
                      "device_union_ms_per_step": busy["union_us"] / 1e3 / n,
                      "device_idle_share": 1 - busy["union_us"] / 1e6 / window_s,
                      "training_union_ms_per_step": training["union_us"] / 1e3 / n,
                      "training_idle_share": 1 - training["union_us"] / 1e6 / window_s,
                      "decoder_streams": len(decoder),
                      "decoder_ms_per_step": sum(by_stream[k]["us"] for k in decoder) / 1e3 / n,
                      "streams": busy["streams"], "by_stream": by_stream,
                      "host_runtime_calls_per_step": sum(calls.values()) / n,
                      "host_runtime_calls_per_step_by_name": {k: v / n
                                                              for k, v in calls.items()},
                      "kernel_records": seen, "priming": priming_kept(prof, priming),
                      "sampler_kernels_ms_per_step": device_us(
                          prof, SAMPLER_KERNELS + NOISE_KERNELS) / 1e3 / n}}


def phase_imagenet_main_path(dev, workdir: str, card: str) -> dict:
    """The ImageNet data path (``imagenet_main_path``): a JPEG listing
    written here (:data:`IMAGENET_LISTING`); K1, K6 and K5 against their
    plain versions on its first decoded batch; ``train_and_eval`` of
    ``confs/resnet50.yaml`` (:data:`RESNET50`, ``epoch=1``: 10 steps of 128
    at 224x224, then the 256 val images) twice from the same seed, the
    host-fed step replayed as a CUDA graph and run eagerly, under
    deterministic cuDNN, with the launch counts set to 0 just before each
    and read just after: equal results and checkpoint bytes, the native
    decoder by name, 0 decode failures, the launches the plans predict, the
    kernel records of a traced stretch against the counters; ms per step,
    the decode rate, runtime calls per step, the idle share and peak memory
    of both; then ``search_cli`` on the listing (:data:`IMAGENET_SEARCH_FLAGS`),
    which streams its fold through the same loader into the graphed TTA
    and audit steps.  Both runs are cut to 1 epoch, under the cosine
    schedule: the preset's step schedule is defined for 90 or 270 epochs
    only."""
    import torch

    from fast_autoaugment_tpu_torch.data import native_loader
    from fast_autoaugment_tpu_torch.launch import search_cli
    from fast_autoaugment_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    root = os.path.join(workdir, "imagenet")
    listing = _write_jpeg_listing(root, IMAGENET_LISTING)
    backend = native_loader.backend()
    t_build = time.perf_counter()
    if not native_loader.available():
        fail("imagenet_main_path: the native JPEG loader is not available on the card")
    build_s = time.perf_counter() - t_build
    golden = _decoder_vs_golden()
    checks = _imagenet_kernels_vs_plain(dev, root)
    # 1 epoch: the preset's step schedule exists for 90 or 270 epochs only
    conf = dict(RESNET50, epoch=1, lr_schedule=dict(RESNET50["lr_schedule"], type="cosine"))
    image = int(conf.get("imgsize", 0) or 0) or 224
    per_call = _kernels.augment_plan(image, image, 2).launches
    arms = {}
    for name in ("graphed", "eager"):
        # the profiler drops kernel records now and then (ROADMAP Queue 3): a
        # run whose traced stretch misses records is made again, and the run
        # kept must hold exactly the records its launch counters give
        runs = []
        for attempt in range(1, IMAGENET_TRACE_ATTEMPTS + 1):
            suffix = "" if attempt == 1 else f"_a{attempt}"
            arm = _imagenet_arm(dev, conf, root,
                                os.path.join(workdir, f"imagenet_{name}{suffix}.msgpack"),
                                name == "graphed")
            traced = arm["trace"]["steps"]
            arm["trace_attempts"] = attempt
            runs.append({k: arm["trace"][k] for k in ("kernel_records", "priming")})
            arm["trace_runs"] = runs
            if arm["trace"]["kernel_records"] == {"augment": per_call * traced,
                                                  "imagenet_stack": traced}:
                break
        arms[name] = arm
    steps_n = IMAGENET_LISTING["train"] // conf["batch"]
    evals = -(-IMAGENET_LISTING["val"] // conf["batch"])
    problems = []
    for name, arm in arms.items():
        n = steps_n + (1 if name == "graphed" else 0)  # the graph's warm-up step
        want = {"augment": per_call * n, "cifar_stack": evals, "imagenet_stack": n,
                **_step_draw_launches(n)}  # ResNet-50: no noise sites, no mixup
        arm["expected_launches"] = want
        if launches_differ(arm["launches"], want):
            problems.append(f"{name}: launches {arm['launches']} != {want}")
        loader = arm["result"]["loader"]
        if loader["decoder"] != backend or loader["failures"] or \
                loader["images"] != IMAGENET_LISTING["train"] + IMAGENET_LISTING["val"]:
            problems.append(f"{name}: the loader {loader} (want {backend}, 0 failures)")
        seen, traced = arm["trace"]["kernel_records"], arm["trace"]["steps"]
        if seen != {"augment": per_call * traced, "imagenet_stack": traced}:
            problems.append(f"{name}: the traced stretch holds {seen}, the counters "
                            f"{per_call * traced} K1 and {traced} K6, in each of "
                            f"{arm['trace_attempts']} runs (each run's records and "
                            f"priming: {arm['trace_runs']})")
        if not np.isfinite(arm["result"]["loss_train"]):
            problems.append(f"{name}: the train loss is not finite")
    drop = ("elapsed_sec", "loader")
    same = {k: v for k, v in arms["graphed"]["result"].items() if k not in drop} == \
        {k: v for k, v in arms["eager"]["result"].items() if k not in drop}
    same_bytes = arms["graphed"].pop("payload") == arms["eager"].pop("payload")
    if not (same and same_bytes):
        problems.append("the graphed host-fed run differs from the eager one "
                        f"(result equal {same}, checkpoint equal {same_bytes})")
    for kind, bound in golden["tolerance"].items():
        if golden["departure"][kind]["max_abs"] > bound["max_abs"] \
                or golden["departure"][kind]["mean_abs"] > bound["mean_abs"]:
            problems.append(f"the decoder departs from the libjpeg golden beyond the tolerance: "
                            f"{golden}")
    for name, r in checks.items():
        if name != "decoded" and (r["differing_elements"] or not r["finite"]):
            problems.append(f"{name} differs from its plain version on the listing: {r}")

    # ---- the search on the listing: phases 1-2 through the lazy fold stream
    save = os.path.join(workdir, "imagenet_search")
    _kernels.reset_launch_counts()
    ts = time.perf_counter()
    with _LogLines() as log:
        search = search_cli.main(["-c", os.path.join(REPO, "confs", "resnet50.yaml"),
                                  "--dataroot", root, "--save-dir", save,
                                  *IMAGENET_SEARCH_FLAGS])
    torch.cuda.synchronize()
    search_s = time.perf_counter() - ts
    search_counts = _kernels.launch_counts()
    trials = _read_json(os.path.join(save, "search_trials.json"))
    final = _read_json(os.path.join(save, "final_policy.json"))
    # a random model at chance may leave the audit nothing to keep: the
    # policy file is written, possibly empty
    if log.count("phase1: training fold") != 1 or sorted(trials) != ["0"] \
            or len(trials["0"]) != 2 or not isinstance(final, list):
        problems.append(f"the ImageNet search did not finish phases 1-2: trials {trials}, "
                        f"final policy {final}")
    if not all(search_counts[k] > 0 for k in ("augment", "cifar_stack", "imagenet_stack")):
        problems.append(f"the ImageNet search launched {search_counts}")

    decoded = {name: arm["result"]["loader"] for name, arm in arms.items()}
    g, e = arms["graphed"], arms["eager"]
    out = {"phase": "imagenet_main_path", "card": card, "listing": listing,
           "decoder": backend, "loader_build_s": build_s, "decoder_vs_libjpeg_golden": golden,
           "kernels_vs_plain": checks,
           "tolerance": "kernels bitwise: 0 differing elements; arms: equal results "
                        "and checkpoint bytes",
           "model": conf["model"]["type"], "batch": conf["batch"], "image": image,
           "steps": steps_n, "eval_batches": evals, "results_equal": same,
           "checkpoints_equal": same_bytes,
           "arms": {name: {k: v for k, v in arm.items() if k != "result"}
                    for name, arm in arms.items()},
           "result": {k: v for k, v in g["result"].items() if k != "loader"},
           "loader": decoded,
           "decode_images_per_s": {name: d["images"] / d["decode_s"] if d["decode_s"] else None
                                   for name, d in decoded.items()},
           "decode_ms_per_batch": {name: d["decode_s"] * 1e3 * conf["batch"] / d["images"]
                                   for name, d in decoded.items()},
           "graphed_over_eager_ms_per_step": g["median_step_ms"] / e["median_step_ms"],
           "idle_share": {name: {k: arm["trace"][k]
                                 for k in ("device_idle_share", "training_idle_share")}
                          for name, arm in arms.items()},
           "search": {"wall_s": search_s, "launches": search_counts,
                      "trials": {k: len(v) for k, v in trials.items()},
                      "final_policy_subs": len(final),
                      "device_secs_phase1": search.get("device_secs_phase1"),
                      "device_secs_phase2": search.get("device_secs_phase2")},
           "phase_s": time.perf_counter() - t0,
           "timing": "step_ms: the host clock between the ends of consecutive steps, each "
                     "ended by a synchronize (the first step, with the graph's capture, "
                     "excluded from the intervals); decode: the seconds inside the loader's "
                     "calls (the prefetch worker, overlapped with the steps); trace: steps "
                     f"{IMAGENET_TRACE[0] + 1}-{IMAGENET_TRACE[1]} profiled, device_idle_share = "
                     "1 - the union of all device activity (the decoder's nvJPEG kernels and "
                     "copies included) over their wall, training_idle_share = 1 - the union "
                     "over the streams that are not the decoder's; the profiler warms up "
                     f"over the {IMAGENET_TRACE_WARMUP} steps before, and the window opens "
                     f"with {PRIMING_LAUNCHES} empty kernels spread over ~0.33 s "
                     "(prime_profiler), counted in its runtime calls; the unions start at "
                     "the last of them on the device's clock"}
    emit(out)
    if problems:
        fail("imagenet_main_path: " + "; ".join(problems))
    return out


# ------------------------------------------------------------ the model zoo

#: the zoo's presets at full width: (name, config, overrides).  EfficientNet's
#: preset names the type ``efficientnet-b0``, which builds no CondConv in
#: either package (the registry reads ``condconv_num_expert`` only for a type
#: ending in ``-condconv``); the smoke asks for the CondConv model by that
#: type and keeps the rest of the preset (8 experts, mixup 0.2, RMSprop, EMA)
ZOO = (("shakeshake26_2x96d", "confs/shake26_2x96d_cifar.yaml", {}),
       ("pyramid272", "confs/pyramid272_cifar.yaml", {}),
       ("efficientnet_b0_condconv8", "confs/efficientnet_b0_condconv.yaml",
        {"model.type": "efficientnet-b0-condconv"}))
ZOO_EQUAL_STEPS = 3
#: the zoo's warm-up, timed and traced steps (3, 10 and 3 before the
#: ImageNet phase joined the script, 2, 6 and 3 before the game days)
ZOO_WARMUP_STEPS = 2
ZOO_TIMED_STEPS = 4
ZOO_TRACE_STEPS = 1
#: the train_cli run of the zoo: the paper's Shake-Shake preset, one epoch
ZOO_CLI_CONF = "confs/shake26_2x96d_cifar.yaml"


def zoo_setup(dev, name: str, path: str, overrides: dict) -> dict:
    """A zoo model of its preset at full width with seeded weights, its
    optimizer and schedule over the real run's steps per epoch (CIFAR-10's
    50,000 or ImageNet-1k's train images), its policy, and two seeded uint8
    batches on the card (standing in for host-cropped images on ImageNet)."""
    import torch

    from fast_autoaugment_tpu_torch.core.config import load_config
    from fast_autoaugment_tpu_torch.models import get_model, input_image_size, num_class
    from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
    from fast_autoaugment_tpu_torch.ops.schedules import build_schedule
    from fast_autoaugment_tpu_torch.train import steps
    from fast_autoaugment_tpu_torch.train.trainer import resolve_policy_tensor

    conf = load_config(os.path.join(REPO, path), overrides=overrides)
    dataset = conf["dataset"]
    classes, imagenet = num_class(dataset), dataset.endswith("imagenet")
    image = input_image_size(dataset, conf["model"]["type"])
    model = get_model(dict(conf["model"], dataset=dataset), classes, device=dev, seed=0)
    b = int(conf["batch"])
    steps_per_epoch = (IMAGENET_TRAIN_IMAGES if imagenet else 50_000) // b
    optimizer = build_optimizer(conf["optimizer"], build_schedule(conf, steps_per_epoch))
    ema = float(conf["optimizer"].get("ema", 0.0) or 0.0)
    state = steps.create_train_state(model, optimizer, use_ema=ema > 0)
    policy = torch.from_numpy(resolve_policy_tensor(conf["aug"])).to(dev)
    cutout = int(conf.get("cutout", 0) or 0)
    g = np.random.default_rng(9)
    batches = [(torch.from_numpy(g.integers(0, 256, (b, image, image, 3), dtype=np.uint8)).to(dev),
                torch.from_numpy(g.integers(0, classes, (b,))).to(dev)) for _ in range(2)]
    kernel_fn = (steps.imagenet_augment_fn if imagenet else steps.cifar_augment_fn)(
        cutout, True, "exact", 8)
    plain_fn = (_plain_imagenet_augment(cutout) if imagenet else _plain_cifar_augment(cutout))
    make = lambda model, fn: steps.make_train_step(  # noqa: E731
        model, optimizer, num_classes=classes, mixup_alpha=float(conf.get("mixup", 0) or 0),
        lb_smooth=float(conf.get("lb_smooth", 0) or 0), ema_mu=ema, cutout_length=cutout,
        augment_fn=fn)
    return {"name": name, "conf": conf, "model": model, "optimizer": optimizer, "state": state,
            "policy": policy, "batches": batches, "classes": classes, "image": image,
            "imagenet": imagenet, "batch": b, "kernel_fn": kernel_fn, "plain_fn": plain_fn,
            "make": make, "steps_per_epoch": steps_per_epoch}


def _plain_cifar_augment(cutout):
    """The CIFAR train stack with the plain versions of K1 and K5."""
    import torch

    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess as pre

    def fn(images, policy, key, src):
        b, h, w = (int(v) for v in images.shape[:3])
        d = src.draws(key, batch=b, num_sub=int(policy.shape[0]), num_op=int(policy.shape[1]),
                      height=h, width=w, dispatch="exact", groups=8, device=images.device)
        x = aug.apply_subpolicy_draws_plain(images.to(torch.float32).contiguous(), policy,
                                            d.sub_idx, d.policy)
        return pre.cifar_stack_plain(x, d.crop, cutout_length=cutout)
    return fn


def phase_zoo_noise_cpu_vs_card(dev) -> dict:
    """One step's model noise of each zoo model (every site at the preset's
    batch) and mixup's draws (also the Beta(0.2) draws of 4096 mixup keys in
    one launch, and 64 keys' mixup draws at a batch of 128), drawn by the
    train-noise kernel on the card (K8) and by the plain versions on the CPU
    from the same keys: bitwise."""
    import torch

    from fast_autoaugment_tpu_torch.core.config import load_config
    from fast_autoaugment_tpu_torch.models import get_model, num_class
    from fast_autoaugment_tpu_torch.ops import _kernels, rng
    from fast_autoaugment_tpu_torch.ops.shake import noise_sites
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    src, cpu = PhiloxDraws(), torch.device("cpu")
    out = {"phase": "zoo_noise_cpu_vs_card", "tolerance": "bitwise: 0 differing bits",
           "compares": "the train-noise kernel (csrc/sampler.cu noise_kernel) on the card with "
                       "the plain versions on the CPU",
           "models": {}, "bits_differing": 0}
    before = _kernels.launch_counts()["train_noise"]

    def differ(a, b) -> int:
        a, b = a.cpu(), b
        if a.dtype == torch.bool:
            return int((a != b).sum())
        bits = {torch.float32: torch.int32, torch.float64: torch.int64,
                torch.int64: torch.int64}[a.dtype]
        return int((a.view(bits) != b.view(bits)).sum())

    for name, path, overrides in ZOO:
        conf = load_config(os.path.join(REPO, path), overrides=overrides)
        model = get_model(dict(conf["model"], dataset=conf["dataset"]),
                          num_class(conf["dataset"]), device="meta")
        sites, b = noise_sites(model), int(conf["batch"])
        row = {"sites": len(sites), "kinds": sorted({s.kind for s in sites}), "tensors": 0,
               "bits_differing": 0}
        for k in range(2):
            ks, kd = torch.tensor([k, 101]), torch.tensor([k, 202])
            card = src.model_noise(sites, b, ks.to(dev), kd.to(dev), dev)
            host = src.model_noise(sites, b, ks, kd, cpu)
            for tc, th in zip(card.tensors, host.tensors):
                for a, h in zip(tc, th):
                    row["tensors"] += 1
                    row["bits_differing"] += differ(a, h)
            alpha = float(conf.get("mixup", 0) or 0)
            if alpha > 0:
                for a, h in zip(src.mixup_draws(torch.tensor([k, 303]), b, alpha, dev),
                                src.mixup_draws(torch.tensor([k, 303]), b, alpha, cpu)):
                    row["tensors"] += 1
                    row["bits_differing"] += differ(a, h)
        out["models"][name] = row
        out["bits_differing"] += row["bits_differing"]
    keys = rng.fold_in_range(torch.tensor([4, 4]), 4096)
    lam_card, lam_cpu = _mixup_draws(keys.to(dev), 0.2, 0)[0], _mixup_draws(keys, 0.2, 0)[0]
    perm_card = torch.stack([src.mixup_draws(k, 128, 0.2, dev)[1] for k in keys[:64].to(dev)])
    perm_cpu = torch.stack([src.mixup_draws(k, 128, 0.2, cpu)[1] for k in keys[:64]])
    out["beta_draws"] = {"draws": 4096, "bits_differing": differ(lam_card, lam_cpu),
                         "min": float(lam_cpu.min()), "max": float(lam_cpu.max())}
    out["permutations"] = {"draws": 64, "elements_differing": differ(perm_card, perm_cpu)}
    out["bits_differing"] += out["beta_draws"]["bits_differing"] \
        + out["permutations"]["elements_differing"]
    out["kernel_launches"] = _kernels.launch_counts()["train_noise"] - before
    emit(out)
    if out["bits_differing"]:
        fail("the model noise or mixup draws differ between the CPU and the card")
    return out


def _zoo_expected_launches(st: dict, steps: int) -> dict:
    """K1, K5 and K6 launches of `steps` train steps, from the plans, and
    their draws' K7 and K8 launches."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels

    img, num_op = st["image"], int(st["policy"].shape[1])
    k1 = _kernels.augment_plan(img, img, num_op).launches * steps
    draws = _step_draw_launches(steps)
    if st["imagenet"]:  # K6 reads K1's float32 output
        return {"augment": k1, "cifar_stack": 0,
                "imagenet_stack": _kernels.imagenet_plan(img, img, torch.float32).launches * steps,
                **draws}
    return {"augment": k1, "cifar_stack": steps, "imagenet_stack": 0, **draws}


def _is_condconv(name: str, shapes) -> bool:
    """Whether an operator is one of CondConv's grouped convolutions, forward
    or backward: a convolution whose first 4-D input has the batch folded
    into the channels (a batch of 1; every other convolution of the step has
    the step's batch)."""
    shapes = [s for s in (shapes or []) if isinstance(s, (list, tuple)) and len(s) == 4]
    return "conv" in name and bool(shapes) and shapes[0][0] == 1


def phase_zoo_train_main_path(dev, st: dict, card: str) -> dict:
    """One zoo model at the full width of its preset: 3 train steps through
    ``make_train_step`` with K1 and K5 (CIFAR) or K1 and K6 (ImageNet), the
    launch counts set to 0 just before and read just after, against 3 steps
    with the plain versions from the same state and keys under deterministic
    cuDNN (parameters, BatchNorm statistics, EMA and metric sums bitwise);
    then the median of :data:`ZOO_TIMED_STEPS` timed steps after
    :data:`ZOO_WARMUP_STEPS` warm-up steps, images/s, the peak device memory,
    and a profiled trace of :data:`ZOO_TRACE_STEPS` (idle share, device time
    by stage, CondConv's share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.ops import _kernels

    key = torch.tensor([0, 7], device=dev)
    x0, y0 = st["batches"][0]
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for which in ("kernel", "plain"):
            state = _copy_state(st["state"])
            step = st["make"](state.model, st[f"{which}_fn"])
            sums = []
            if which == "kernel":
                _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            for i in range(ZOO_EQUAL_STEPS):
                x, y = st["batches"][i % 2]
                state, m = step(state, x, y, st["policy"], key)
                sums.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            if which == "kernel":
                counts = _kernels.launch_counts()
                main_wall = time.perf_counter() - t0
            tensors = dict(state.model.state_dict())
            tensors.update({"ema." + k: v for k, v in (state.ema or {}).items()})
            runs[which] = (sums, tensors)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    (sk, tk), (sp, tp) = runs["kernel"], runs["plain"]
    differing = sorted(k for k in tk if not torch.equal(tk[k], tp[k]))
    want = _zoo_expected_launches(st, ZOO_EQUAL_STEPS)
    losses = [s["loss"] / s["num"] for s in sk]

    # timing: the preset's freshly initialized state (the equality runs
    # stepped copies of it), the default cuDNN settings; each step on the
    # host's clock and by CUDA events around it on the step's stream
    state = st["state"]
    step = st["make"](state.model, st["kernel_fn"])
    for i in range(ZOO_WARMUP_STEPS):
        state, _ = step(state, *st["batches"][i % 2], st["policy"], key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def timed(steps: int, state):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        host = []
        torch.cuda.synchronize()
        for i in range(steps):
            t0 = time.perf_counter()
            events[i].record()
            state, _ = step(state, *st["batches"][i % 2], st["policy"], key)
            events[i + 1].record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        return state, host, [events[i].elapsed_time(events[i + 1]) for i in range(steps)]

    state, times, event_times = timed(ZOO_TIMED_STEPS, state)
    clocks = card_clocks()
    step_ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=st["imagenet"]) as prof:
        state, traced_host, traced_events = timed(ZOO_TRACE_STEPS, state)
    wall_s = sum(traced_host) / 1e3
    n = ZOO_TRACE_STEPS
    by_name = {k: v for k, v in kernel_device_us(prof).items() if not k.startswith("train.")}
    busy_us = sum(by_name.values())
    union = device_busy(prof)
    stages = _stage_device_us(prof, TRAIN_STAGES)
    k1_us, k5_us, k6_us = (device_us(prof, K1_KERNELS), device_us(prof, "cifar_stack_kernel"),
                           device_us(prof, K6_KERNELS))
    # the sampler's kernels are launched through ctypes, outside any torch
    # operator, so the train.sampler range does not hold them: the stage is
    # the range's torch work and the K7 and K8 kernels by name
    k7k8_us = device_us(prof, SAMPLER_KERNELS + NOISE_KERNELS)
    split = {"sampler": stages["train.sampler"] + k7k8_us,
             "augment_kernels_K1_K5_K6": k1_us + k5_us + k6_us,
             "augment_other": stages["train.augment"],
             "optimizer_and_metrics": stages["train.optimizer"]}
    split["model_forward_backward"] = busy_us - sum(split.values())
    split["sampler_kernels_K7_K8"] = k7k8_us
    split = {k: v / 1e3 / n for k, v in split.items()}
    draw_records = sum(kernel_counts(prof, SAMPLER_KERNELS + NOISE_KERNELS).values())
    draw_launches = sum(_zoo_expected_launches(st, n)[k] for k in ("sampler", "train_noise"))
    condconv = device_busy(prof, _is_condconv) if st["imagenet"] else None
    # the traced device work against the unprofiled step: None where the
    # profiler made that work outlast the step it was not on
    idle_unprofiled = 1 - union["union_us"] / 1e3 / n / float(np.median(event_times))
    idle_unprofiled = idle_unprofiled if union["union_us"] and idle_unprofiled >= 0 else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"phase": "zoo_train_main_path", "card": card, "model": st["name"],
           "type": st["conf"]["model"]["type"], "dataset": st["conf"]["dataset"],
           "batch": st["batch"], "image": st["image"], "classes": st["classes"],
           "parameters": sum(p.numel() for p in st["model"].parameters()),
           "mixup": float(st["conf"].get("mixup", 0) or 0),
           "steps_per_epoch": st["steps_per_epoch"], "equal_steps": ZOO_EQUAL_STEPS,
           "losses": losses, "main_path_wall_s": main_wall, "launches": counts,
           "expected_launches": want, "plain_vs_kernel": {
               "metric_sums_equal": sk == sp, "state_tensors": len(tk),
               "state_tensors_differing": differing[:20],
               "state_tensors_differing_count": len(differing)},
           "median_step_ms": step_ms, "step_ms": times, "card_after_timed_steps": clocks,
           "median_step_event_ms": float(np.median(event_times)), "step_event_ms": event_times,
           "images_per_s": st["batch"] / step_ms * 1e3, "max_memory_allocated_bytes": peak,
           "trace": {"steps": n, "wall_ms_per_step": wall_s * 1e3 / n,
                     "step_ms": traced_host, "step_event_ms": traced_events,
                     "device_busy_ms_per_step": busy_us / 1e3 / n,
                     "device_busy_union_ms_per_step": union["union_us"] / 1e3 / n,
                     "device_activities_per_step": union["activities"] / n,
                     "device_streams": union["streams"],
                     "device_idle_share": 1 - union["union_us"] / 1e6 / wall_s
                     if union["union_us"] else None,
                     "device_idle_share_at_step_event_ms": idle_unprofiled,
                     "device_ms_per_step_by_stage": split,
                     "sampler_kernel_records": draw_records,
                     "sampler_launches": draw_launches,
                     # the profiler drops the first records of a window: the
                     # draws' ms a step over the steps whose records it kept
                     "sampler_kernels_ms_per_kept_step": k7k8_us / 1e3 * draw_launches
                     / n / draw_records if draw_records else None,
                     "condconv_ms_per_step": condconv["sum_us"] / 1e3 / n if condconv else None,
                     "condconv_union_ms_per_step": condconv["union_us"] / 1e3 / n
                     if condconv else None,
                     "condconv_streams": condconv["streams"] if condconv else None,
                     "condconv_share_of_busy_union": condconv["union_us"] / union["union_us"]
                     if condconv and union["union_us"] else None,
                     "stage_ranges_found": any(v > 0 for v in stages.values()),
                     "top_device_ms_per_step": {k[:90]: v / 1e3 / n for k, v in top}},
           "timing": f"median_step_ms: host clock around each of {ZOO_TIMED_STEPS} steps after "
                     f"{ZOO_WARMUP_STEPS} warm-up steps, synchronized; step_event_ms: CUDA events "
                     f"around the same steps; the trace runs the next {ZOO_TRACE_STEPS} steps with "
                     "the profiler on, timed the same way; busy: the "
                     "summed durations of the device's activities (by stage too), busy_union: "
                     "their union on the device's clock (streams overlap); idle shares: 1 - "
                     "busy_union over the traced steps' wall, and over step_event_ms"}
    emit(out)
    if launches_differ(counts, want):
        fail(f"{st['name']}: launch counts {counts} != {want} over {ZOO_EQUAL_STEPS} steps")
    if not all(np.isfinite(losses)):
        fail(f"{st['name']}: a train step's loss is not finite: {losses}")
    if differing or sk != sp:
        fail(f"{st['name']}: the steps with the kernels differ from the plain ones: "
             f"{differing[:5]}, sums {sk} vs {sp}")
    return out


def phase_zoo_train_cli(dev, workdir: str) -> dict:
    """``launch/train_cli.py`` on the Shake-Shake preset at full width on
    ``synthetic`` data for one epoch, saving its checkpoint; then again with
    ``--only-eval``: both return the JAX result keys, the checkpoint loads
    back with its digest, and the evaluation equals the first run's test
    metrics.  The CLI's ``main`` is called as ``python -m`` calls it."""
    from fast_autoaugment_tpu_torch.core.checkpoint import load_checkpoint, read_metadata
    from fast_autoaugment_tpu_torch.launch import train_cli
    from fast_autoaugment_tpu_torch.ops import _kernels

    from fast_autoaugment_tpu_torch.core.config import load_config
    from fast_autoaugment_tpu_torch.train.trainer import resolve_policy_tensor

    conf = load_config(os.path.join(REPO, ZOO_CLI_CONF))
    num_op = int(resolve_policy_tensor(conf["aug"]).shape[1])
    save = os.path.join(workdir, "shake.msgpack")
    argv = ["-c", os.path.join(REPO, ZOO_CLI_CONF), "--save", save, "dataset=synthetic", "epoch=1"]
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    first = train_cli.main(argv)
    wall = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    meta = read_metadata(save)
    tree = load_checkpoint(save)  # checks the digest
    again = train_cli.main(argv + ["--only-eval"])
    test_keys = ("loss_test", "top1_test", "top5_test", "num_test")
    steps, evals = 512 // int(conf["batch"]), -(-256 // int(conf["batch"]))
    # the default device cache: one CUDA graph (N = 1), one warm-up step
    want = {"augment": _kernels.augment_plan(32, 32, num_op).launches * (steps + 1),
            "cifar_stack": steps + 1 + evals, "imagenet_stack": 0,
            **_step_draw_launches(steps + 1)}
    out = {"phase": "zoo_train_cli", "argv": argv, "result": first, "only_eval": again,
           "wall_s": wall, "checkpoint_step": int(tree["step"]), "digest": meta.get("digest"),
           "launches": counts, "expected_launches": want}
    emit(out)
    if set(first) != TRAIN_RESULT_KEYS or not all(np.isfinite(list(first.values()))):
        fail(f"train_cli result is malformed: {sorted(first)}")
    if set(again) != {"epoch"} | set(test_keys):
        fail(f"train_cli --only-eval result is malformed: {sorted(again)}")
    if any(again[k] != first[k] for k in test_keys) or int(tree["step"]) != steps:
        fail("train_cli --only-eval does not reproduce the first run's test metrics")
    if launches_differ(counts, want):
        fail(f"train_cli launch counts {counts} != {want}")
    return out


def zoo_phases(dev, card: str) -> tuple[dict, dict]:
    """The zoo's phases: the noise on the CPU and the card, each model's
    train path, and train_cli."""
    import torch

    torch.cuda.empty_cache()
    phase_zoo_noise_cpu_vs_card(dev)
    zoo = {}
    for name, path, overrides in ZOO:
        st = zoo_setup(dev, name, path, overrides)
        zoo[name] = phase_zoo_train_main_path(dev, st, card)
        del st
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        cli = phase_zoo_train_cli(dev, workdir)
    return zoo, cli


# ---------------------------------------------- the device-resident path

#: the CIFAR-10 train set's size: 146 MiB of uint8 32x32 images resident,
#: 390 steps an epoch at batch 128 (390 % 8 = 6: a shorter last dispatch)
CIFAR10_TRAIN_IMAGES = 50_000
DISPATCH_N = 8
#: steps timed between the first dispatch and the epoch's remainder, and
#: steps traced: one dispatch of 8; 2 of the host feed, whose 3,300 runtime
#: calls a step cost the profiler's post-processing about 3 s a step
#: 96 before the ImageNet phase joined the script, 48 before the game days
DISPATCH_TIMED_STEPS = 32
DISPATCH_TRACE_STEPS = {"host_fed": 2, "n1": 8, "n8": 8}
#: K1 or K5 records the profiler may lose from a traced stretch
LOST_RECORDS = 1
#: PyramidNet-272's comparison: eager steps against replays of N = 8
PYRAMID_DISPATCH_STEPS = 16
#: the runtime calls that put work on the card from the host
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


def _dispatch_expected_launches(steps_per_epoch: int, epochs: int, n: int, evals: int,
                                graphed: bool, start: int = 0) -> dict:
    """K1, K5 and K7 launches of a ``train_and_eval`` run of the flagship on
    32x32 (2 ops): one K1 and one K5 a step and a K5 per eval batch, the
    step's draws (no noise sites, no mixup: no K8); a graphed run adds the
    warm-up step before its one capture (the graph's launches count at each
    replay).  `start`: the dispatch position the first epoch resumes from."""
    from fast_autoaugment_tpu_torch.data.pipeline import split_dispatch_chunks
    from fast_autoaugment_tpu_torch.ops import _kernels

    chunks = split_dispatch_chunks(steps_per_epoch - start, n)
    for _ in range(epochs - 1):
        chunks += split_dispatch_chunks(steps_per_epoch, n)
    steps = sum(chunks) + (1 if graphed else 0)
    return {"augment": _kernels.augment_plan(32, 32, 2).launches * steps,
            "cifar_stack": steps + evals, "imagenet_stack": 0, **_step_draw_launches(steps)}


def _host_launches(prof) -> dict:
    """Runtime calls that put work on the card, by name, from a profile."""
    return {e.key: e.count for e in prof.key_averages() if e.key in HOST_LAUNCH_CALLS}


def _state_tensors(state) -> dict:
    out = dict(state.model.state_dict())
    for name in ("trace", "ms", "mom"):
        out.update({f"opt.{name}.{i}": t for i, t in enumerate(getattr(state.opt_state, name))})
    out.update({"ema." + k: v for k, v in (state.ema or {}).items()})
    return out


def _dispatch_flagship_arms(dev, workdir: str) -> dict:
    """(a) ``train_and_eval`` of the flagship WRN-40-2 on ``synthetic_shapes``
    (600 train images: 4 steps an epoch; 2,000 test: 16 eval batches), 2
    epochs, evaluation every epoch, in nine arms under deterministic cuDNN:
    the eager host feed (``off_eager``: ``host_step="eager"``, the
    reference), the host feed replaying a CUDA graph of its step (``off``),
    the default (``auto``: N = 1, a graph replay a step), ``on`` at N = 8
    with a mid-epoch checkpoint every dispatch (one dispatch of 4 an epoch),
    N = 3 (dispatches of 3 and 1, a mid-epoch checkpoint each epoch) and
    that run resumed from its epoch-1 mid-epoch link; and, with an EMA of
    0.999 (its update inside the graphs), the eager host feed
    (``off_ema_eager``), the graphed one and N = 3.  Every arm's final
    checkpoint bytes and result dict must equal its eager host feed's, and
    its launches the prediction."""
    import shutil

    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.train.trainer import train_and_eval

    c = FLAGSHIP
    conf = {"model": {"type": c["model"], "precision": c["precision"]},
            "dataset": "synthetic_shapes", "aug": c["aug"], "cutout": c["cutout"],
            "batch": c["batch"], "epoch": 2, "lr": c["lr"], "lr_schedule": c["lr_schedule"],
            "optimizer": c["optimizer"]}
    spe, evals = 600 // c["batch"], 2 * -(-2000 // c["batch"])
    n3 = dict(device_cache="on", steps_per_dispatch=3, checkpoint_every_dispatch=1,
              ckpt_keep=4)
    # (train_and_eval arguments, N, graphed, resume position, the arm it must
    # equal): every graph is held against the eager host feed
    eager = dict(device_cache="off", host_step="eager")
    arms = {"off_eager": (eager, 1, False, 0, "off_eager"),
            "off": (dict(device_cache="off"), 1, True, 0, "off_eager"),
            "auto": ({}, 1, True, 0, "off_eager"),
            "on_n8": (dict(device_cache="on", steps_per_dispatch=8,
                           checkpoint_every_dispatch=1), 8, True, 0, "off_eager"),
            "on_n3": (n3, 3, True, 0, "off_eager"),
            "on_n3_resumed": (n3, 3, True, 3, "off_eager"),
            # the EMA's update inside the graph: the preset's optimizer with ema 0.999
            "off_ema_eager": (eager, 1, False, 0, "off_ema_eager"),
            "off_ema": (dict(device_cache="off"), 1, True, 0, "off_ema_eager"),
            "on_n3_ema": (n3, 3, True, 0, "off_ema_eager")}
    ema_conf = dict(conf, optimizer=dict(c["optimizer"], ema=0.999))
    out, problems = {}, []
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for name, (kw, n, graphed, start, _) in arms.items():
            path = os.path.join(workdir, name, "m.msgpack")
            os.makedirs(os.path.dirname(path))
            if start:  # the N = 3 run's link after epoch 1's first dispatch
                src = os.path.join(workdir, "on_n3", "m.msgpack.prev3")
                for suffix in ("", ".meta.json"):
                    shutil.copy(src + suffix, path + suffix)
                meta = _read_json(path + ".meta.json")
                if meta.get("in_epoch", {}).get("pos") != start or meta["epoch"] != 0:
                    problems.append(f"the N = 3 run's .prev3 link is not epoch 1's mid-epoch "
                                    f"link at {start}: {meta}")
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            ema = "_ema" in name
            result = train_and_eval(ema_conf if ema else conf, "",
                                    save_path=path, evaluation_interval=1, device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _kernels.launch_counts()
            with open(path, "rb") as fh:
                payload = fh.read()
            # with an EMA each split is evaluated twice: the raw and the EMA weights
            want = _dispatch_expected_launches(spe, 2, n, evals * (2 if ema else 1), graphed,
                                               start)
            out[name] = {"result": result, "wall_s": wall, "launches": counts,
                         "expected_launches": want, "payload": payload}
            if launches_differ(counts, want):
                problems.append(f"{name}: launches {counts} != {want}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    payloads = {name: arm.pop("payload") for name, arm in out.items()}
    for name, arm in out.items():
        ref = arms[name][-1]
        arm["equal_to"] = ref
        arm["checkpoint_equal"] = payloads[name] == payloads[ref]
        arm["result_equal"] = {k: v for k, v in arm["result"].items() if k != "elapsed_sec"} \
            == {k: v for k, v in out[ref]["result"].items() if k != "elapsed_sec"}
        if not arm["checkpoint_equal"] or not arm["result_equal"]:
            problems.append(f"{name}: the final state or the result differs from {ref}")
    return {"conf": conf, "ema_conf_optimizer": ema_conf["optimizer"], "steps_per_epoch": spe,
            "eval_batches": evals, "arms": out, "problems": problems}


def _cifar10_sized(dev, g) -> tuple:
    """A seeded in-memory set of CIFAR-10's train size: uint8 images and
    int64 labels on the host, and the same resident on the card."""
    from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset
    from fast_autoaugment_tpu_torch.data.pipeline import DeviceCache

    images = g.integers(0, 256, (CIFAR10_TRAIN_IMAGES, 32, 32, 3), dtype=np.uint8)
    labels = g.integers(0, 10, (CIFAR10_TRAIN_IMAGES,)).astype(np.int64)
    return images, labels, DeviceCache(ArrayDataset(images, labels, 10), dev)


def _flagship_state(dev, steps_per_epoch: int):
    """The flagship WRN-40-2 (seeded weights), its optimizer over
    `steps_per_epoch` and the keyword arguments of its steps."""
    import torch

    from fast_autoaugment_tpu_torch.models import get_model
    from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
    from fast_autoaugment_tpu_torch.ops.schedules import build_schedule
    from fast_autoaugment_tpu_torch.train import steps
    from fast_autoaugment_tpu_torch.train.trainer import resolve_policy_tensor

    c = FLAGSHIP
    model = get_model({"type": c["model"], "dataset": "cifar10"}, 10, device=dev, seed=0)
    optimizer = build_optimizer(c["optimizer"], build_schedule(
        {"lr": c["lr"], "epoch": c["epoch"], "lr_schedule": c["lr_schedule"]}, steps_per_epoch))
    state = steps.create_train_state(model, optimizer, use_ema=False)
    policy = torch.from_numpy(resolve_policy_tensor(c["aug"])).to(dev)
    kw = dict(num_classes=10, cutout_length=c["cutout"])
    return state, optimizer, policy, kw


def _dispatch_times(dev, card: str) -> dict:
    """(b) WRN-40-2 (the flagship) over a seeded CIFAR-10-sized set, batch
    128, 390 steps an epoch, in three arms: the eager host feed (gather on
    the host, upload, one eager step; the trainer's host feed replays a
    graph of the step), the cache at N = 1 and at
    N = 8 (dispatches of 8 and the epoch's remainder of 6; both replay one
    graph of a step).  Each arm runs the first 8 steps of an epoch (the
    graph's capture), then 32 steps timed on the host's clock, synchronized
    at the ends, then the epoch's last 6; then 8 steps of the next epoch (2
    of the host feed) are traced for the device's idle share and the
    runtime calls that put work on the card per step; the peak memory is
    the arm's.  The trace's records of K1 and K5 are held against the
    launch counters, which under replay count the capture's launches once
    per replay: more records than counts, or fewer by more than
    :data:`LOST_RECORDS` (the profiler drops records), is a problem."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_autoaugment_tpu_torch.data.pipeline import train_index_matrix
    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.train import steps

    g = np.random.default_rng(31)
    images, labels, cache = _cifar10_sized(dev, g)
    b = FLAGSHIP["batch"]
    spe = CIFAR10_TRAIN_IMAGES // b
    key = torch.tensor([0, 42], device=dev)
    head, tail = DISPATCH_N, spe % DISPATCH_N
    k1_name, problems = _kernels.augment_plan(32, 32, 2).kernel, []
    out = {"images": CIFAR10_TRAIN_IMAGES, "cache_mib": cache.nbytes / 2**20, "batch": b,
           "steps_per_epoch": spe, "timed_steps": DISPATCH_TIMED_STEPS}
    for arm in ("host_fed", "n1", "n8"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state, optimizer, policy, kw = _flagship_state(dev, spe)
        n = {"host_fed": 1, "n1": 1, "n8": DISPATCH_N}[arm]
        if arm == "host_fed":
            step = steps.make_train_step(state.model, optimizer, **kw)

            def run(mat):
                nonlocal state
                for row in mat:
                    x = torch.from_numpy(images[row]).to(dev, non_blocking=True)
                    y = torch.from_numpy(labels[row]).to(dev, non_blocking=True)
                    state, _ = step(state, x, y, policy, key)
        else:
            fn = steps.make_multistep_train_step(
                steps.make_train_step_body(state.model, optimizer, **kw), steps_per_dispatch=n)
            sums = torch.zeros(len(steps.METRIC_KEYS), device=dev)

            def run(mat):
                for s in range(0, len(mat), n):
                    fn(state, cache.images, cache.labels, mat[s:s + n], policy, key, sums)
        mat = train_index_matrix(np.arange(CIFAR10_TRAIN_IMAGES), b, 1, seed=0)
        t0 = time.perf_counter()
        run(mat[:head])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(mat[head:head + DISPATCH_TIMED_STEPS])
        torch.cuda.synchronize()
        timed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(mat[spe - tail:])
        torch.cuda.synchronize()
        last_s = time.perf_counter() - t0
        mat2 = train_index_matrix(np.arange(CIFAR10_TRAIN_IMAGES), b, 2, seed=0)
        traced = DISPATCH_TRACE_STEPS[arm]
        _kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(mat2[:traced])
            torch.cuda.synchronize()
            trace_s = time.perf_counter() - t0
        t_post = time.perf_counter()
        counts = _kernels.launch_counts()
        records, found = records_vs_counters(prof, counts, k1_name, arm)
        problems += found
        busy = device_busy(prof)
        host = _host_launches(prof)
        # a replay has no host ranges: its device time is split by kernel name
        by_name = {k: v for k, v in kernel_device_us(prof).items()
                   if not k.startswith(ANNOTATIONS)}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        ms = timed_s * 1e3 / out["timed_steps"]
        out[arm] = {"ms_per_step": ms, "images_per_s": b / ms * 1e3,
                    "first_8_steps_s": first_s, "last_6_steps_s": last_s,
                    "peak_bytes": torch.cuda.max_memory_allocated(dev),
                    "trace": {"steps": traced, "wall_s": trace_s,
                              "device_busy_union_ms_per_step": busy["union_us"] / 1e3 / traced,
                              "device_activities_per_step": busy["activities"] / traced,
                              "device_idle_share": 1 - busy["union_us"] / 1e6 / trace_s
                              if busy["union_us"] else None,
                              "host_launches_per_step": sum(host.values()) / traced,
                              "host_launches_by_call": host, "kernel_launches": counts,
                              "kernel_records": records,
                              "top_device_ms_per_step": {
                                  k[:80]: v / 1e3 / traced for k, v in top},
                              "profile_postprocess_s": time.perf_counter() - t_post}}
        del state, optimizer
    out["card"] = card
    out["timing"] = (f"host clock, synchronized at the ends of {DISPATCH_TIMED_STEPS} steps of "
                     "an epoch (after its first 8, before its last 6); idle share = 1 - the "
                     "union of the device's activities over the wall of 8 (host feed: 2) "
                     "profiled steps of the next epoch; host launches = the runtime calls of "
                     "HOST_LAUNCH_CALLS in that trace per step")
    out["problems"] = problems
    return out


def _pyramid_dispatch(dev) -> dict:
    """(c) PyramidNet-272 (``confs/pyramid272_cifar.yaml``, batch 64, seeded
    weights) from one state, under deterministic cuDNN: 16 eager host-fed
    steps against 2 dispatches of N = 8 (graph replays) over the same batches
    held on the card: every state tensor and the metric sums bitwise; ms per
    step of the last 8 steps of each (the first 8 include the capture)."""
    import torch

    from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset
    from fast_autoaugment_tpu_torch.data.pipeline import DeviceCache
    from fast_autoaugment_tpu_torch.train import steps

    st = zoo_setup(dev, "pyramid272", "confs/pyramid272_cifar.yaml", {})
    conf, b = st["conf"], st["batch"]
    n = PYRAMID_DISPATCH_STEPS
    g = np.random.default_rng(13)
    images = g.integers(0, 256, (n * b, 32, 32, 3), dtype=np.uint8)
    labels = g.integers(0, st["classes"], (n * b,)).astype(np.int64)
    cache = DeviceCache(ArrayDataset(images, labels, st["classes"]), dev)
    idx = g.permutation(n * b).reshape(n, b)
    key = torch.tensor([0, 9], device=dev)
    kw = dict(num_classes=st["classes"], mixup_alpha=float(conf.get("mixup", 0) or 0),
              lb_smooth=float(conf.get("lb_smooth", 0) or 0),
              ema_mu=float(conf["optimizer"].get("ema", 0) or 0),
              cutout_length=int(conf.get("cutout", 0) or 0))
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        eager = _copy_state(st["state"])
        step = steps.make_train_step(eager.model, st["optimizer"], **kw)
        host, times = None, []
        for half in (idx[:n // 2], idx[n // 2:]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for row in half:
                eager, m = step(eager, torch.from_numpy(images[row]).to(dev),
                                torch.from_numpy(labels[row]).to(dev), st["policy"], key)
                host = m if host is None else {k: host[k] + m[k] for k in m}
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / len(half))
        graphed = _copy_state(st["state"])
        fn = steps.make_multistep_train_step(
            steps.make_train_step_body(graphed.model, st["optimizer"], **kw),
            steps_per_dispatch=n // 2)
        sums = torch.zeros(len(steps.METRIC_KEYS), device=dev)
        gtimes = []
        for half in (idx[:n // 2], idx[n // 2:]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(graphed, cache.images, cache.labels, half, st["policy"], key, sums)
            torch.cuda.synchronize()
            gtimes.append((time.perf_counter() - t0) * 1e3 / len(half))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    te, tg = _state_tensors(eager), _state_tensors(graphed)
    differing = sorted(k for k in te if not torch.equal(te[k], tg[k]))
    sums_equal = [float(host[k]) for k in steps.METRIC_KEYS] == sums.tolist()
    return {"model": "pyramid272", "batch": b, "steps": n, "state_tensors": len(te),
            "state_tensors_differing": differing[:20],
            "state_tensors_differing_count": len(differing), "metric_sums_equal": sums_equal,
            "eager_ms_per_step": times[1], "graph_ms_per_step": gtimes[1],
            "eager_first_8_ms_per_step": times[0], "graph_first_8_with_capture_ms_per_step":
            gtimes[0], "steps_equal": eager.step == graphed.step == n}


def phase_dispatch_main_path(dev, card: str) -> dict:
    """The device-resident data path on the card: (a) the flagship through
    ``train_and_eval`` in nine arms, (b) ms per step, images/s, host launches
    per step, idle share and peak memory of the host feed, N = 1 and N = 8
    over a CIFAR-10-sized set, (c) PyramidNet-272 eager against graph
    replays.  A capture that fails raises, and fails the run."""
    import torch

    seconds = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        arms = _dispatch_flagship_arms(dev, workdir)
    torch.cuda.empty_cache()
    seconds["flagship_arms"] = time.perf_counter() - t0
    times = _dispatch_times(dev, card)
    torch.cuda.empty_cache()
    seconds["times"] = time.perf_counter() - t0 - sum(seconds.values())
    pyramid = _pyramid_dispatch(dev)
    torch.cuda.empty_cache()
    seconds["pyramid272"] = time.perf_counter() - t0 - sum(seconds.values())
    launches = {k: sum(a["launches"][k] for a in arms["arms"].values()) for k in ALL_KERNELS}
    out = {"phase": "dispatch_main_path", "card": card, "launches": launches,
           "flagship": {k: v for k, v in arms.items() if k != "problems"},
           "times": times, "pyramid272": pyramid, "seconds": seconds}
    emit(out)
    problems = arms["problems"] + times["problems"]
    if pyramid["state_tensors_differing_count"] or not pyramid["metric_sums_equal"] \
            or not pyramid["steps_equal"]:
        problems.append(f"PyramidNet-272: graph replays differ from eager steps: {pyramid}")
    if problems:
        fail("dispatch_main_path: " + "; ".join(problems))
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
    has (the samplers, ``_kernels.augment`` on records (``slot_records``) before
    the kernel built them, on the policy and the draws since,
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
        if list(inspect.signature(_kernels.augment).parameters)[1] == "records":  # K1 on records
            rec = aug.slot_records(pol, sub, draws, img, img)
            k1 = lambda: _kernels.augment(x, rec)  # noqa: E731
        else:
            k1 = lambda: _kernels.augment(x, pol, sub, draws)  # noqa: E731
        if name.startswith("k1"):
            fn = k1
        else:
            y, crop = k1(), aug.sample_crop(keys, img, img)
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


def _draw_row(name: str, draws: dict, at: str, paths: dict, shape) -> dict:
    """The ``kernels`` line's row of K7 (``sampler``) or K8 (``train_noise``)."""
    t = draws["times"][at]
    return {"name": name, "route": "cuda", "source": "fast_autoaugment_tpu_torch/csrc/sampler.cu",
            "replaces": DRAWS_REPLACE[name],
            "launches": sum(paths.values()),
            "launches_by_path": {k: v for k, v in paths.items() if v},
            "launches_per_call": 1,
            "max_abs_err": draws[name]["max_abs_err"],
            "differing_elements": draws[name]["differing_vs_plain"],
            "differing_elements_vs_cpu": draws[name]["differing_vs_cpu"],
            "ms": t["ms"], "ms_source": t["ms_source"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "empty_kernel_graph_ms": draws["empty_kernel_graph_ms"],
            "shape": shape,
            "at_other_shapes": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")}
                                for k, v in draws["times"].items()
                                if v["kernel"] == name and k != at and "bound_ms" in v},
            **({"train_step_draws": {k[len("train_step_draws_"):]: {
                f: v[f] for f in ("ms", "chain_ms", "plain_ms", "bound_ms", "launches_per_call",
                                  "chain_launches_per_call")}
                for k, v in draws["times"].items() if k.startswith("train_step_draws_")}}
               if name == "train_noise" else {})}


#: the JAX lines each draw kernel stands for (XLA fuses these jax.random
#: draws into the compiled programs)
DRAWS_REPLACE = {
    "sampler": "fast_autoaugment_tpu/ops/augment.py:416, :444, :462-463, :476, :515, "
               ":554-567; ops/preprocess.py:93; ops/preprocess_imagenet.py:139-171; "
               "search/tta.py:120, :225",
    "train_noise": "fast_autoaugment_tpu/core/metrics.py:66-68; ops/shake.py:59-62, "
                   ":105-109; models/efficientnet.py:160, :354; train/steps.py:137, :155 "
                   "(and, as a train step's draws, the augment record of "
                   "ops/preprocess.py:93, ops/preprocess_imagenet.py:139-171)"}


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
    if sys.argv[1:2] == ["--dispatch-only"]:  # the device-resident path's phase alone
        _kernels.load_libraries()
        print(card, flush=True)
        phase_dispatch_main_path(dev, card)
        return 0
    if sys.argv[1:2] == ["--serve-only"]:  # the serving phases alone
        _kernels.load_libraries()
        print(card, flush=True)
        with tempfile.TemporaryDirectory() as workdir:
            phase_main_path(dev, workdir)
            phase_serve_plane(dev, workdir, card)
        return 0
    if sys.argv[1:2] == ["--imagenet-only"]:  # the ImageNet data path's phase alone
        _kernels.load_libraries()
        print(card, flush=True)
        with tempfile.TemporaryDirectory() as workdir:
            phase_imagenet_main_path(dev, workdir, card)
        return 0
    if sys.argv[1:2] == ["--sampler-only"]:  # K7 and K8 against their plain versions
        _kernels.load_libraries()
        print(card, flush=True)
        phase_lighting_cpu_vs_card(dev)
        phase_sampler_vs_plain(dev)
        phase_step_draws_census(dev)
        phase_zoo_noise_cpu_vs_card(dev)
        return 0
    if sys.argv[1:2] == ["--runtime-only"]:  # the search runtime's phases alone
        _kernels.load_libraries()
        print(card, flush=True)
        st = tta_setup(dev)
        phase_tta_main_path(dev, st)
        phase_tta_graphs(dev, st, card)
        del st
        with tempfile.TemporaryDirectory() as workdir:
            search = phase_search_main_path(dev, workdir, card)
            phase_search_runtime(dev, workdir, card, search)
            phase_fleet_search(workdir, card, search)
        return 0
    if sys.argv[1:2] == ["--fleet-only"]:  # the search and its fleet tier alone
        _kernels.load_libraries()
        print(card, flush=True)
        with tempfile.TemporaryDirectory() as workdir:
            phase_fleet_search(workdir, card, phase_search_main_path(dev, workdir, card))
        return 0
    if sys.argv[1:2] == ["--control-only"]:  # the search and the control loop alone
        _kernels.load_libraries()
        print(card, flush=True)
        with tempfile.TemporaryDirectory() as workdir:
            phase_control_main_path(workdir, card, phase_search_main_path(dev, workdir, card))
        return 0
    if sys.argv[1:2] == ["--gameday-only"]:  # the game days alone
        _kernels.load_libraries()
        print(card, flush=True)
        with tempfile.TemporaryDirectory() as workdir:
            phase_gameday_main_path(workdir, card)
        return 0

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
    draws = phase_sampler_vs_plain(dev)
    phase_step_draws_census(dev)
    with tempfile.TemporaryDirectory() as workdir:
        main_path = phase_main_path(dev, workdir)
        plane = phase_serve_plane(dev, workdir, card)
    st = tta_setup(dev)
    tta_path = phase_tta_main_path(dev, st)
    graphs = phase_tta_graphs(dev, st, card)
    rows = phase_times(dev, card)
    phase_trace(dev, card)
    tta_t = phase_tta_times(dev, st, card, graphs)
    graph_launches = graphs["launches"]
    del graphs
    del st
    torch.cuda.empty_cache()
    rn = resnet50_setup(dev)
    train_path = phase_train_main_path(dev, rn)
    flagship = phase_train_flagship(dev)
    with tempfile.TemporaryDirectory() as workdir:
        search = phase_search_main_path(dev, workdir, card)
        phase_search_runtime(dev, workdir, card, search)
        fleet = phase_fleet_search(workdir, card, search)
        control = phase_control_main_path(workdir, card, search)
        gameday = phase_gameday_main_path(workdir, card)
    train_t = phase_train_times(dev, rn, card)
    del rn
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        imagenet = phase_imagenet_main_path(dev, workdir, card)
    imagenet_launches = {k: sum(imagenet["arms"][a]["launches"][k] for a in imagenet["arms"])
                         + imagenet["search"]["launches"][k] for k in ALL_KERNELS}
    zoo, zoo_cli = zoo_phases(dev, card)
    dispatch = phase_dispatch_main_path(dev, card)
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

    def zoo_by_path(kernel):
        """The zoo paths' launches of `kernel`, by path, where it ran."""
        paths = {f"train_{name}": r["launches"][kernel] for name, r in zoo.items()}
        paths["train_cli_shakeshake26_2x96d"] = zoo_cli["launches"][kernel]
        return {k: v for k, v in paths.items() if v}

    zoo_launches = {k: sum(zoo_by_path(k).values()) for k in ALL_KERNELS}
    cached = dispatch["launches"]  # the seven train_and_eval arms of the cache path
    imported = flagship["imported"]["launches"]  # the resume from an imported checkpoint

    def by_path(kernel):
        return {"serve": main_path["sampler_launches"] if kernel == "sampler" else 0,
                "serve_plane": plane["sampler_launches"] if kernel == "sampler" else 0,
                "tta": tta_path["launches"][kernel],
                "tta_graphed_vs_eager": graph_launches[kernel],
                "train_resnet50": train_path["launches"][kernel],
                "train_and_eval_wrn40_2": flagship["launches"][kernel],
                "search_wrn40_2": search["launches"][kernel],
                "fleet_search_workqueue": fleet["workqueue"][kernel],
                "fleet_search_transport": fleet["transport"][kernel],
                "control_loop": control["launches"][kernel],
                "gameday": gameday["launches"][kernel],
                "train_and_eval_wrn40_2_imported": imported[kernel], **zoo_by_path(kernel),
                "device_cache_wrn40_2_arms": cached[kernel],
                "imagenet_resnet50_jpeg": imagenet_launches[kernel]}

    sampler_paths, noise_paths = by_path("sampler"), by_path("train_noise")
    silent = [p for p in ("serve", "serve_plane", "tta", "search_wrn40_2",
                          "fleet_search_workqueue", "fleet_search_transport", "control_loop",
                          "gameday", "imagenet_resnet50_jpeg") if not sampler_paths[p]]
    silent += [p for p in ("train_resnet50", "train_and_eval_wrn40_2", "search_wrn40_2",
                           "fleet_search_workqueue", "device_cache_wrn40_2_arms",
                           "train_and_eval_wrn40_2_imported", "imagenet_resnet50_jpeg",
                           *zoo_by_path("augment"))
               if not noise_paths.get(p)]
    silent += [f"{p} ({k})" for p in ("workqueue", "transport") for k in ("augment", "cifar_stack")
               if not fleet[p][k]]
    silent += [f"control_loop ({k})" for k in ("augment", "cifar_stack")
               if not control["launches"][k]]
    silent += [f"gameday ({k})" for k in ("augment",) if not gameday["launches"][k]]
    silent += [f"train_and_eval_wrn40_2_imported ({k})" for k in ("augment", "cifar_stack")
               if not imported[k]]
    if silent:
        fail(f"paths that never launched the sampler or the train noise: {silent}")
    print(card, flush=True)
    emit({"kernels": [{
        "name": "augment", "route": "cuda",
        "source": "fast_autoaugment_tpu_torch/csrc/augment.cu",
        "replaces": "fast_autoaugment_tpu/ops/augment.py:409",
        "launches": main_path["launches"] + plane["launches"] + tta_path["launches"]["augment"]
        + graph_launches["augment"]
        + train_path["launches"]["augment"] + flagship["launches"]["augment"]
        + search["launches"]["augment"] + fleet["workqueue"]["augment"]
        + fleet["transport"]["augment"] + control["launches"]["augment"]
        + gameday["launches"]["augment"] + imported["augment"]
        + zoo_launches["augment"] + cached["augment"] + imagenet_launches["augment"],
        "launches_by_path": {"serve": main_path["launches"],
                             "serve_plane": plane["launches"],
                             "tta": tta_path["launches"]["augment"],
                             "tta_graphed_vs_eager": graph_launches["augment"],
                             "train_resnet50": train_path["launches"]["augment"],
                             "train_and_eval_wrn40_2": flagship["launches"]["augment"],
                             "search_wrn40_2": search["launches"]["augment"],
                             "fleet_search_workqueue": fleet["workqueue"]["augment"],
                             "fleet_search_transport": fleet["transport"]["augment"],
                             "control_loop": control["launches"]["augment"],
                             "gameday": gameday["launches"]["augment"],
                             "train_and_eval_wrn40_2_imported": imported["augment"],
                             **zoo_by_path("augment"),
                             "device_cache_wrn40_2_arms": cached["augment"],
                             "imagenet_resnet50_jpeg": imagenet_launches["augment"]},
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
        "launches": tta_path["launches"]["cifar_stack"] + graph_launches["cifar_stack"]
        + flagship["launches"]["cifar_stack"]
        + search["launches"]["cifar_stack"] + fleet["workqueue"]["cifar_stack"]
        + fleet["transport"]["cifar_stack"] + control["launches"]["cifar_stack"]
        + imported["cifar_stack"]
        + zoo_launches["cifar_stack"] + cached["cifar_stack"] + imagenet_launches["cifar_stack"],
        "launches_by_path": {"tta": tta_path["launches"]["cifar_stack"],
                             "tta_graphed_vs_eager": graph_launches["cifar_stack"],
                             "train_and_eval_wrn40_2": flagship["launches"]["cifar_stack"],
                             "search_wrn40_2": search["launches"]["cifar_stack"],
                             "fleet_search_workqueue": fleet["workqueue"]["cifar_stack"],
                             "fleet_search_transport": fleet["transport"]["cifar_stack"],
                             "control_loop": control["launches"]["cifar_stack"],
                             "train_and_eval_wrn40_2_imported": imported["cifar_stack"],
                             **zoo_by_path("cifar_stack"),
                             "device_cache_wrn40_2_arms": cached["cifar_stack"],
                             "imagenet_resnet50_jpeg_eval": imagenet_launches["cifar_stack"]},
        "train_and_eval_launches_are": f"{flagship['train_steps']} train steps + 1 warm-up "
                                       f"step of the graph + {flagship['eval_batches']} eval "
                                       "batches",
        "max_abs_err": check5["max_abs_err"],
        "differing_elements": check5["differing_elements"],
        **ms(k5),
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": None, "shape": k5["shape"]}, {
        "name": "imagenet_stack", "route": "cuda",
        "source": "fast_autoaugment_tpu_torch/csrc/imagenet.cu",
        "replaces": "fast_autoaugment_tpu/ops/preprocess_imagenet.py:191",
        "launches": train_path["launches"]["imagenet_stack"] + zoo_launches["imagenet_stack"]
        + imagenet_launches["imagenet_stack"],
        "launches_by_path": {"train_resnet50": train_path["launches"]["imagenet_stack"],
                             **zoo_by_path("imagenet_stack"),
                             "imagenet_resnet50_jpeg": imagenet_launches["imagenet_stack"]},
        "launches_per_call": {"train_224_float32": k6["launches_per_call"],
                              "train_224_uint8": train_t["k6"]["uint8"]["launches_per_call"]},
        "max_abs_err": check6["max_abs_err"],
        "differing_elements": check6["differing_elements"],
        "draws_bits_differing_cpu_vs_card": lighting["float_bits_differing"]
        + lighting["ints_differing"],
        **ms(k6),
        "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        "library_ms": None, "shape": k6["shape"], "input": k6["input"],
        "at_uint8_input": {k: train_t["k6"]["uint8"].get(k) for k in timing_keys}},
        _draw_row("sampler", draws, "serve_grouped_128x32", sampler_paths, [128, 32, 32, 3]),
        _draw_row("train_noise", draws, "train_step_draws_shakeshake26_2x96d", noise_paths,
                  "one train step's draws of shakeshake26_2x96d, batch 128 at 32x32")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
