#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and ``nvcc``.  The
phases, each printing one JSON line:

1. environment: the card (``nvidia-smi``), torch and CUDA versions, and the
   seconds it took to build the kernels (``fast_autoaugment_tpu_torch/csrc/
   augment.cu``, ``preprocess.cu`` and ``imagenet.cu``, one ``nvcc`` each,
   in parallel);
2. kernel vs plain version on the card, bitwise with the count of
   differing elements: the augmentation kernel (all 19 ops forced on with
   both mirror signs over a sweep of levels, then random draws under all
   six policy archives, at 128x32x32, 4x17x23 and 8x224x224) and the CIFAR
   stack kernel (``k5_vs_plain``: every crop offset and flip bit, cutout
   lengths 0 and 16 centred at corners, edges and random places, at
   640x32x32 and 4x17x23, and the eval stack) and the ImageNet stack kernel
   (``k6_vs_plain``: the six ColorJitter orders x both flip bits x cutout 0
   and 16, uint8 and float32 inputs, at 128x224x224 and 4x17x23); and every
   sampler's draws on the card against the CPU from the same keys;
3. the serving path: two ``serve_cli`` processes on the card (the shipped
   ``fa_reduced_cifar10`` archive at 32x32, grouped dispatch; one ImageNet
   sub-policy at 224x224, shapes 1,8, exact dispatch) answer npz, raw and
   concurrent requests; every answer is checked against the plain version
   applied on the card to the same draws; the kernel's launch count in
   ``/stats`` must equal dispatches x op slots; SIGTERM must drain to exit 0;
4. the TTA policy-scoring path (``tta_main_path``): WRN-40-2 from the
   flagship config (:data:`FLAGSHIP`) with seeded weights, a seeded 20,000
   image uint8 fold uploaded once (157 batches of 128, the last with 32
   real images), then ``eval_tta`` of a 5-sub-policy candidate, the
   identity baseline, ``eval_tta_batched`` of 4 candidates, one audit step
   and ``eval_tta`` under grouped dispatch; the launch counts must be
   ``num_op`` augmentation launches and 1 CIFAR stack launch per step
   call; then the same steps with the plain versions of both kernels on the
   card (augmented lanes bitwise, fields equal under
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
   function, on seeded uint8 batches: 10 exact steps and one grouped step
   with finite losses and ``num_op`` K1 and 2 K6 launches per step; then one
   step with both kernels against one with both plain versions from the
   same state under deterministic cuDNN (augmented batch, loss and every
   tensor of the model bitwise).  ``train_flagship`` runs ``train_and_eval``
   with the flagship WRN-40-2 config on ``synthetic`` (2 epochs of 4 steps,
   evaluation every epoch) and checks its result dict and launch counts;
7. ``train_times``: the ResNet-50 step's median time and images/s, a
   profiler trace split by stage (sampler, K1, K6, model forward and
   backward with the convolutions' TFLOP/s, optimizer) with the device's
   idle share, K1 and K6 at 128x224x224 against their bounds and plain
   versions, and the peak device memory.

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
SHAPES = ((128, 32, 32), (4, 17, 23), (8, 224, 224))
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


def kernel_device_ms(fn, iters: int = 20, kernel="augment_slot_kernel",
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


def _compare(aug, imgs, pol, sub, draws) -> tuple[int, float]:
    """(differing elements, max |diff|) of kernel vs plain version."""
    import torch

    got = aug.apply_subpolicy_draws(imgs, pol, sub, draws)
    want = aug.apply_subpolicy_draws_plain(imgs, pol, sub, draws)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()) or got.shape != imgs.shape:
        fail("kernel output is not finite or has the wrong shape")
    if not bool(((got >= 0) & (got <= 255) & (got == torch.trunc(got))).all()):
        fail("kernel output is not integral in [0, 255]")
    diff = (got - want).abs()
    return int((diff > 0).sum()), float(diff.max())


def phase_kernel_vs_plain(dev) -> dict:
    import torch

    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.policies.archive import ARCHIVES, load_policy, policy_to_tensor

    g = np.random.default_rng(0)
    report = {"phase": "kernel_vs_plain", "tolerance": "bitwise: 0 differing elements",
              "shapes": {}, "differing_elements": 0, "max_abs_err": 0.0}
    for b, h, w in SHAPES:
        imgs = _rand_images(g, b, h, w, dev)
        imgs[: max(1, b // 4)] = torch.floor(imgs[: max(1, b // 4)] / 4 + 64)  # low range
        per_op = {}
        for op in range(aug.NUM_OPS):
            levels = np.linspace(0.0, 1.0, 5)
            pol = torch.tensor([[[op, 1.0, lv]] for lv in levels], dtype=torch.float32, device=dev)
            sub = torch.arange(b, device=dev, dtype=torch.int32) % 5
            mirror = np.where(np.arange(b) % 2 == 0, 0.25, 0.75)  # both signs
            draws = np.stack([np.zeros(b), mirror, g.uniform(0, w, b), g.uniform(0, h, b)], -1)
            draws = torch.from_numpy(draws.astype(np.float32)[:, None, :]).to(dev)
            per_op[aug.OP_NAMES[op]] = _compare(aug, imgs, pol, sub, draws)
        per_archive = {}
        for name in ARCHIVES:
            pol = torch.from_numpy(policy_to_tensor(load_policy(name))).to(dev)
            keys = torch.from_numpy(g.integers(0, 2**32, (b, 2), dtype=np.int64)).to(dev)
            sub, draws = aug.sample_exact(keys, pol.shape[0], pol.shape[1], h, w)
            per_archive[name] = _compare(aug, imgs, pol, sub, draws)
        results = list(per_op.values()) + list(per_archive.values())
        n_diff = sum(r[0] for r in results)
        report["shapes"][f"{b}x{h}x{w}"] = {
            "ops_differing": {k: v[0] for k, v in per_op.items() if v[0]},
            "archives_differing": {k: v[0] for k, v in per_archive.items() if v[0]},
            "differing_elements": n_diff, "comparisons": len(results)}
        report["differing_elements"] += n_diff
        report["max_abs_err"] = max(report["max_abs_err"], max(r[1] for r in results))
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

    for b, h, w in ((640, 32, 32), (4, 17, 23)):
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
            if before[id(r)]["kernel_launches"]["augment_slot"] != 0 or before[id(r)]["dispatches"]:
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
        for r in replicas:
            st = after[id(r)]
            n_launch = st["kernel_launches"]["augment_slot"]
            if n_launch <= 0 or n_launch != st["dispatches"] * st["num_op"]:
                fail(f"launch count {n_launch} != dispatches {st['dispatches']} x "
                     f"num_op {st['num_op']}")
            launches += n_launch
            dispatches += st["dispatches"]
        if _kernels.launch_counts()["augment_slot"] != 0:
            fail("the smoke process itself launched the kernel during the main path")
        served = sum(after[id(r)]["requests"] for r in replicas)
        if served != requests or requests < 16:
            fail(f"replicas served {served} requests, sent {requests}")
        emit({"phase": "main_path", "requests": requests, "dispatches": dispatches,
              "kernel_launches": launches, "burst_requests": burst_n,
              "burst_dispatches": burst_dispatches,
              "grouped_stats": {k: after[id(grouped)][k] for k in
                                ("dispatches", "requests", "images_served", "mean_batch")},
              "exact_stats": {k: after[id(exact)][k] for k in
                              ("dispatches", "requests", "images_served", "mean_batch")}})
        serve = phase_serve_burst(grouped)
        final = grouped.get("/stats")
        if final["kernel_launches"]["augment_slot"] != final["dispatches"] * final["num_op"]:
            fail("launch count drifted from dispatches x num_op during the burst")
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
        kernel_event_ms = cuda_ms(lambda: _kernels.augment(x, rec))
        kernel_ms = kernel_device_ms(lambda: _kernels.augment(x, rec),
                                     per_call=int(policy.shape[1]))
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
                     "num_op": int(policy.shape[1]), "kernel_ms": kernel_ms,
                     "kernel_event_ms": kernel_event_ms,
                     "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "bytes": nbytes, "ops": ops, "library_ms": None})
    emit({"phase": "times", "card": card, "rows": rows,
          "timing": "kernel_ms: the kernel's device time per dispatch (all op slots) from "
                    "torch.profiler over 20 calls; *_event_ms, wrapper_ms, plain_ms: CUDA "
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
           "augment_kernel_us_per_call": device_us(prof, "augment_slot_kernel") / 20,
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
    want = {"augment_slot": c["num_op"] * calls, "cifar_stack": calls, "imagenet_stack": 0}
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
    k1 = {"kernel": "augment_slot", "shape": list(x.shape), "num_op": int(pol.shape[1]),
          "kernel_ms": kernel_device_ms(lambda: _kernels.augment(x, rec),
                                        per_call=int(pol.shape[1])),
          "kernel_event_ms": cuda_ms(lambda: _kernels.augment(x, rec)),
          "plain_ms": cuda_ms(lambda: aug.apply_subpolicy_draws_plain(x, pol, d.sub_idx, d.policy),
                              iters=5, warmup=1),
          "bytes": 2 * elems * 4 + rec.numel() * 4}
    k5 = {"kernel": "cifar_stack", "shape": list(x.shape),
          "kernel_ms": kernel_device_ms(lambda: pre.cifar_stack(y, d.crop, cutout_length=16),
                                        kernel="cifar_stack_kernel"),
          "kernel_event_ms": cuda_ms(lambda: pre.cifar_stack(y, d.crop, cutout_length=16)),
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
    k1_us, k5_us = device_us(prof, "augment_slot_kernel"), device_us(prof, "cifar_stack_kernel")
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
                     "*_event_ms and plain_ms: CUDA events around back-to-back calls, host "
                     "gaps included; the trace runs with the profiler on (host time inflated), "
                     "device_idle_share_at_trial_wall sets its device time per batch against "
                     "the unprofiled trial's wall per batch"}
    emit(out)
    return out


# ------------------------------------------------------------ train path

TRAIN_STAGES = ("train.sampler", "train.augment", "train.model", "train.optimizer")
TRAIN_STEPS = 10
TIMED_STEPS = 20
TRACE_STEPS = 3
K6_KERNELS = ("grey_sum_kernel", "imagenet_stack_kernel")
K6_SHAPES = ((128, 224, 224), (4, 17, 23))


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


def phase_k6_vs_plain(dev) -> dict:
    """The ImageNet stack kernel against its plain version on the card:
    the six jitter orders x both flip bits x cutout 0 and 16, uint8 and
    float32 inputs, at 128x224x224 and 4x17x23; and the stack's draws on the
    card against the CPU."""
    import torch

    from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as pi
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    g = np.random.default_rng(6)
    report = {"phase": "k6_vs_plain", "tolerance": "bitwise: 0 differing elements",
              "cases": {}, "differing_elements": 0, "max_abs_err": 0.0}
    for b, h, w in K6_SHAPES:
        u8 = torch.from_numpy(g.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
        for length in (0, 16):
            d = _imagenet_k6_draws(g, b, h, w, dev)
            for name, imgs in (("uint8", u8), ("float32", u8.to(torch.float32))):
                got = pi.imagenet_stack(imgs, d, cutout_length=length)
                want = pi.imagenet_stack_plain(imgs, d, cutout_length=length)
                torch.cuda.synchronize()
                if got.shape != (b, 3, h, w) or not got.is_contiguous(
                        memory_format=torch.channels_last) or not bool(torch.isfinite(got).all()):
                    fail(f"k6 {b}x{h}x{w}: shape, layout or finiteness is wrong")
                diff = (got - want).abs()
                tag = f"{b}x{h}x{w}_cutout{length}_{name}"
                report["cases"][tag] = int((diff > 0).sum())
                report["differing_elements"] += report["cases"][tag]
                report["max_abs_err"] = max(report["max_abs_err"], float(diff.max()))
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


def _plain_imagenet_augment(cutout):
    """The ImageNet train stack with the plain versions of K1 and K6."""
    import torch

    from fast_autoaugment_tpu_torch.ops import augment as aug
    from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as pi

    def fn(images, policy, key, src):
        b, h, w = (int(v) for v in images.shape[:3])
        d = src.imagenet_draws(key, batch=b, policy_shape=tuple(policy.shape[:2]), height=h,
                               width=w, dispatch="exact", groups=8, device=images.device)
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
    (K1, then K6) as its augment_fn, wired as train_and_eval wires it; the
    launch counts set to 0 just before and read just after; then one step
    with both kernels against one with both plain versions."""
    import torch

    from fast_autoaugment_tpu_torch.ops import _kernels
    from fast_autoaugment_tpu_torch.train import steps

    c = RESNET50
    num_op = int(st["policy"].shape[1])
    step = st["make"]("exact")
    step_g = st["make"]("grouped")
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
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    losses = [float(v) for v in losses]
    calls = TRAIN_STEPS + 1
    want = {"augment_slot": num_op * calls, "cifar_stack": 0, "imagenet_stack": 2 * calls}
    if counts != want:
        fail(f"train launch counts {counts} != {want} ({calls} steps)")
    grouped_loss = float(mg["loss"] / mg["num"])
    if not all(np.isfinite(losses + [grouped_loss])):
        fail(f"a train step's loss is not finite: {losses} {grouped_loss}")

    # one step with both kernels against one with both plain versions, from
    # the same state, batch and key, under deterministic cuDNN
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {}
        for name, fn in (("kernel", steps.imagenet_augment_fn(c["cutout"], True, "exact", 8)),
                         ("plain", _plain_imagenet_augment(c["cutout"]))):
            state = _copy_state(st["state"])
            cap = _CaptureAugment(fn)
            make = steps.make_train_step(state.model, st["optimizer"], num_classes=st["classes"],
                                         cutout_length=c["cutout"], augment_fn=cap)
            state, m = make(state, x, y, st["policy"], key)
            torch.cuda.synchronize()
            runs[name] = (cap.out[0], float(m["loss"]), state.model.state_dict())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    (xk, lk, sk), (xp, lp, sp) = runs["kernel"], runs["plain"]
    batch_diff = int((xk != xp).sum())
    bn_err = _batchnorm_rule_error(dev)
    tensors_diff = sorted(k for k in sk if not torch.equal(sk[k], sp[k]))
    out = {"phase": "train_main_path", "model": c["model"]["type"], "dataset": c["dataset"],
           "batch": c["batch"], "image": st["image"], "classes": st["classes"],
           "policy": c["aug"], "num_sub": int(st["policy"].shape[0]), "num_op": num_op,
           "steps_per_epoch": st["steps_per_epoch"], "steps": TRAIN_STEPS,
           "grouped_steps": 1, "losses": losses, "grouped_loss": grouped_loss,
           "main_path_wall_s": wall, "launches": counts, "expected_launches": want,
           "launches_per_step": {"augment_slot": num_op, "imagenet_stack": 2},
           "plain_vs_kernel": {"augmented_elements_differing": batch_diff,
                               "augmented_max_abs_err": float((xk - xp).abs().max()),
                               "loss_kernel": lk, "loss_plain": lp,
                               "state_tensors": len(sk), "state_tensors_differing": tensors_diff},
           "batchnorm_running_stats_rel_err": bn_err, "batchnorm_running_stats_tol": 1e-5}
    emit(out)
    if batch_diff or lk != lp or tensors_diff:
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
    want = {"augment_slot": c["num_op"] * steps, "cifar_stack": steps + evals,
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
    rows_seen = kernel_counts(prof, ("augment_slot_kernel",) + K6_KERNELS)
    rows_want = {"augment_slot_kernel": int(st["policy"].shape[1]) * TRACE_STEPS,
                 K6_KERNELS[0]: TRACE_STEPS, K6_KERNELS[1]: TRACE_STEPS}
    # a range's device time counts the PyTorch operators launched inside it:
    # not the kernels launched through ctypes (K1, K6), and not the backward,
    # which autograd runs on a thread of its own; so the model's share is
    # what remains of the busy time
    stages = _stage_device_us(prof, TRAIN_STAGES)
    k1_us, k6_us = device_us(prof, "augment_slot_kernel"), device_us(prof, K6_KERNELS)
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
    k1 = {"kernel": "augment_slot", "shape": list(xf.shape), "num_op": int(pol.shape[1]),
          "kernel_ms": kernel_device_ms(lambda: _kernels.augment(xf, rec),
                                        per_call=int(pol.shape[1])),
          "kernel_event_ms": cuda_ms(lambda: _kernels.augment(xf, rec)),
          "plain_ms": cuda_ms(lambda: aug.apply_subpolicy_draws_plain(xf, pol, d.sub_idx,
                                                                     d.policy),
                              iters=3, warmup=1),
          "bytes": 2 * elems * 4 + rec.numel() * 4}  # images in + out once, records in
    k6 = {}
    ints = torch.stack([d.flip, d.order, d.centre[:, 0], d.centre[:, 1]], dim=-1).contiguous()
    floats = torch.cat([d.factors, pi.lighting_rgb(d.alpha)], dim=-1).contiguous()
    mean, rstd = (v.tolist() for v in pi.norm_constants(pi.IMAGENET_MEAN, pi.IMAGENET_STD))
    for name, inp in (("float32", y1), ("uint8", x)):
        raw = lambda: _kernels.imagenet_stack(  # noqa: E731  (the two launches alone)
            inp, ints, floats, cutout_length=0, scale=1 / 255, mean=mean, rstd=rstd)
        k6[name] = {
            "kernel": "imagenet_stack", "input": name, "shape": list(inp.shape),
            "kernel_ms": kernel_device_ms(lambda: pi.imagenet_stack(inp, d), kernel=K6_KERNELS),
            "grey_sum_kernel_ms": kernel_device_ms(raw, iters=50, kernel=K6_KERNELS[0]),
            "stack_kernel_ms": kernel_device_ms(raw, iters=50, kernel=K6_KERNELS[1]),
            "kernel_event_ms": cuda_ms(raw, iters=50),
            "wrapper_event_ms": cuda_ms(lambda: pi.imagenet_stack(inp, d)),
            "plain_ms": cuda_ms(lambda: pi.imagenet_stack_plain(inp, d), iters=5, warmup=1),
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
                     "calls (K6's per-kernel times over 50 calls of the two launches alone); "
                     "*_event_ms and plain_ms: CUDA events around back-to-back calls "
                     "(K6's kernel_event_ms: the two launches alone, 50 calls); "
                     "the trace runs with the profiler on (host time inflated); "
                     "convolution TFLOP/s counts 3x the forward's convolution and dense "
                     "FLOPs against the convolution kernels' device time"}
    emit(out)
    return out


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
    sys.path.insert(0, REPO)
    try:
        from fast_autoaugment_tpu_torch.ops import _kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
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
    train_t = phase_train_times(dev, rn, card)
    at = next(r for r in rows if r["batch"] == 128)  # the largest serving shape
    k1, k5 = tta_t["k1"], tta_t["k5"]
    k1_train, k6 = train_t["k1"], train_t["k6"]["float32"]
    timing_keys = ("shape", "kernel_ms", "kernel_event_ms", "plain_ms", "bound_ms", "bound_by")
    print(card, flush=True)
    emit({"kernels": [{
        "name": "augment_slot", "route": "cuda",
        "source": "fast_autoaugment_tpu_torch/csrc/augment.cu",
        "replaces": "fast_autoaugment_tpu/ops/augment.py:409",
        "launches": main_path["launches"] + tta_path["launches"]["augment_slot"]
        + train_path["launches"]["augment_slot"] + flagship["launches"]["augment_slot"],
        "launches_by_path": {"serve": main_path["launches"],
                             "tta": tta_path["launches"]["augment_slot"],
                             "train_resnet50": train_path["launches"]["augment_slot"],
                             "train_and_eval_wrn40_2": flagship["launches"]["augment_slot"]},
        "max_abs_err": check["max_abs_err"],
        "differing_elements": check["differing_elements"],
        "ms": at["kernel_ms"] if at["kernel_ms"] is not None else at["kernel_event_ms"],
        "ms_source": "device" if at["kernel_ms"] is not None else "events",
        "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"], "library_ms": None,
        "shape": [at["batch"], at["image"], at["image"], 3],
        "at_tta_shape": {k: k1[k] for k in timing_keys},
        "at_train_shape": {k: k1_train[k] for k in timing_keys}}, {
        "name": "cifar_stack", "route": "cuda",
        "source": "fast_autoaugment_tpu_torch/csrc/preprocess.cu",
        "replaces": "fast_autoaugment_tpu/ops/preprocess.py:109",
        "launches": tta_path["launches"]["cifar_stack"] + flagship["launches"]["cifar_stack"],
        "launches_by_path": {"tta": tta_path["launches"]["cifar_stack"],
                             "train_and_eval_wrn40_2": flagship["launches"]["cifar_stack"]},
        "train_and_eval_launches_are": f"{flagship['train_steps']} train steps + "
                                       f"{flagship['eval_batches']} eval batches",
        "max_abs_err": check5["max_abs_err"],
        "differing_elements": check5["differing_elements"],
        "ms": k5["kernel_ms"] if k5["kernel_ms"] is not None else k5["kernel_event_ms"],
        "ms_source": "device" if k5["kernel_ms"] is not None else "events",
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": None, "shape": k5["shape"]}, {
        "name": "imagenet_stack", "route": "cuda",
        "source": "fast_autoaugment_tpu_torch/csrc/imagenet.cu",
        "replaces": "fast_autoaugment_tpu/ops/preprocess_imagenet.py:191",
        "launches": train_path["launches"]["imagenet_stack"],
        "launches_by_path": {"train_resnet50": train_path["launches"]["imagenet_stack"]},
        "launches_per_call": 2,
        "max_abs_err": check6["max_abs_err"],
        "differing_elements": check6["differing_elements"],
        "ms": k6["kernel_ms"] if k6["kernel_ms"] is not None else k6["kernel_event_ms"],
        "ms_source": "device" if k6["kernel_ms"] is not None else "events",
        "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        "library_ms": None, "shape": k6["shape"], "input": k6["input"],
        "at_uint8_input": {k: train_t["k6"]["uint8"][k] for k in timing_keys}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
