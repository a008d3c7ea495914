#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and ``nvcc``.  The
phases, each printing one JSON line:

1. environment: the card (``nvidia-smi``), torch and CUDA versions, and the
   seconds it took to build ``fast_autoaugment_tpu_torch/csrc/augment.cu``;
2. kernel vs plain version on the card: all 19 ops forced on with both
   mirror signs over a sweep of levels, then random draws under all six
   policy archives, at 128x32x32, 4x17x23 and 8x224x224 -- bitwise, with
   the count of differing elements; and the samplers' draws on the card
   against the CPU from the same keys -- bitwise;
3. main path: two ``serve_cli`` processes on the card (the shipped
   ``fa_reduced_cifar10`` archive at 32x32, grouped dispatch; one ImageNet
   sub-policy at 224x224, shapes 1,8, exact dispatch) answer npz, raw and
   concurrent requests; every answer is checked against the plain version
   applied on the card to the same draws; the kernel's launch count in
   ``/stats`` must equal dispatches x op slots; SIGTERM must drain to exit 0;
4. times beside the card's name and power limit: requests/s and p50/p99
   latency of a closed-loop burst (inside phase 3, before the drain); the
   kernel per dispatch at each serving shape with CUDA events, its bound,
   the plain version; a ``torch.profiler`` trace of the applier at the
   largest serving shape (device time by kernel, device idle share).

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


def device_us(prof, name_part: str) -> float:
    """Summed device (CUPTI) time in µs of the profiled kernels whose name
    contains `name_part`."""
    return sum(device_us_of(e) for e in prof.key_averages() if name_part in e.key)


def kernel_device_ms(fn, iters: int = 20) -> float | None:
    """Device time of ``augment_slot_kernel`` per call of `fn`, from the
    profiler: the kernel's own execution, without the host's launch gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = device_us(prof, "augment_slot_kernel")
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
        kernel_ms = kernel_device_ms(lambda: _kernels.augment(x, rec))
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
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        us = device_us_of(e)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us
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
    _kernels.load_library()
    emit({"phase": "environment", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "build_s": time.perf_counter() - t0, "nvcc_s": _kernels.build_seconds,
          "nvcc_flags": list(_kernels.NVCC_FLAGS)})
    check = phase_kernel_vs_plain(dev)
    with tempfile.TemporaryDirectory() as workdir:
        main_path = phase_main_path(dev, workdir)
    rows = phase_times(dev, card)
    phase_trace(dev, card)
    at = next(r for r in rows if r["batch"] == 128)  # the largest serving shape
    print(card, flush=True)
    emit({"kernels": [{
        "name": "augment_slot", "route": "cuda",
        "source": "fast_autoaugment_tpu_torch/csrc/augment.cu",
        "replaces": "fast_autoaugment_tpu/ops/augment.py:409",
        "launches": main_path["launches"], "max_abs_err": check["max_abs_err"],
        "differing_elements": check["differing_elements"],
        "ms": at["kernel_ms"] if at["kernel_ms"] is not None else at["kernel_event_ms"],
        "ms_source": "device" if at["kernel_ms"] is not None else "events",
        "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"], "library_ms": None,
        "shape": [at["batch"], at["image"], at["image"], 3]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
