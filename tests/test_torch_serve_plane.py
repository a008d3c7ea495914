"""The port's serving plane on the CPU (``fast_autoaugment_tpu_torch/serve/
policy_server.py`` and ``serve_cli.py``).

- The donated, double-buffered and async applier, and the exported
  program, are held bitwise against the eager dispatch
  (``PolicyApplier.apply_eager``), which ``tests/test_torch_serve.py``
  holds bitwise against the JAX package's ``AotPolicyApplier``.
- The request queue's drain order and the tenancy LRU's evictions are
  held against the JAX package's ``_RequestQueue`` and ``TenantPool``
  over seeded operation sequences (host code: no JAX computation runs).
- The breaker driven by ``FAA_FAULT``, the drift seam and the traffic
  gauges are held against the JAX ``PolicyServer`` driving the same
  host-only stand-in applier.
- ``serve_cli --device cpu`` answers each endpoint, in one subprocess.

Bound: equality (bitwise for images, exact for counters and orders).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

from fast_autoaugment_tpu.serve import policy_server as jax_ps
from fast_autoaugment_tpu.serve import serve_cli as jax_cli
from fast_autoaugment_tpu.utils import faultinject as jax_faultinject
from fast_autoaugment_tpu_torch.core.resilience import PREEMPTED_EXIT_CODE, CircuitOpenError
from fast_autoaugment_tpu_torch.policies import archive
from fast_autoaugment_tpu_torch.serve import policy_server as ps
from fast_autoaugment_tpu_torch.serve import serve_cli, wire
from fast_autoaugment_tpu_torch.utils import faultinject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 8
SINGLE_SUB = np.array([[[13, 0.8, 0.7], [10, 0.9, 0.3]]], np.float32)
SINGLE_SUB_2 = np.array([[[4, 0.9, 0.6], [14, 0.8, 0.5]]], np.float32)
SINGLE_SUB_3 = np.array([[[0, 1.0, 0.9], [11, 0.7, 0.4]]], np.float32)
MULTI_SUB = np.array([
    [[4, 0.8, 0.7], [10, 0.5, 0.3]],
    [[0, 0.5, 0.5], [11, 0.9, 0.5]],
    [[8, 0.9, 0.2], [14, 0.9, 0.6]],
], np.float32)


def _images(n, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3)).astype(dtype)


def _keys(n, base=0):
    return np.stack([np.uint32([0, base + i]) for i in range(n)])


@pytest.fixture(autouse=True)
def _clean_fault_env():
    saved = os.environ.pop("FAA_FAULT", None)
    faultinject.reset()
    jax_faultinject.reset()
    yield
    os.environ.pop("FAA_FAULT", None)
    if saved is not None:
        os.environ["FAA_FAULT"] = saved
    faultinject.reset()
    jax_faultinject.reset()


# ------------------------------------------------------------ the applier


@pytest.mark.parametrize("policy,dispatch", [(SINGLE_SUB, "exact"), (MULTI_SUB, "exact"),
                                             (MULTI_SUB, "grouped")])
def test_donated_async_applier_bitwise_vs_eager(policy, dispatch):
    """Staged through the two standing slots (pad rows zeroed, the slot
    flipping every chunk), dispatched two at a time before either is read
    back, and chunked past the largest shape: every output equals the
    eager dispatch's."""
    ap = ps.PolicyApplier(policy, image=IMG, shapes=(1, 4), dispatch=dispatch,
                          groups=2, device="cpu", donate=True)
    ref = ps.PolicyApplier(policy, image=IMG, shapes=(1, 4), dispatch=dispatch,
                           groups=2, device="cpu")
    slots = []
    for i, n in enumerate((4, 2, 3, 1, 4, 2, 7, 9)):
        imgs = _images(n, seed=i, dtype=np.uint8 if i % 2 else np.float32)
        keys = _keys(n, base=10 * i) if dispatch == "exact" else np.uint32([0, i])
        slot = ap._slot
        assert np.array_equal(ap.apply(imgs, keys), ref.apply_eager(imgs, keys))
        slots.append(slot)
        if n <= 4:  # the slot this chunk staged into: real rows in, pad rows zero
            s = ps.pick_shape(ap.shapes, n)
            buf = ap._staging[s][slot]
            assert np.array_equal(buf[:n], imgs.astype(np.float32)) and not buf[n:].any()
            if dispatch == "exact":
                kbuf = ap._staging_keys[s][slot]
                assert np.array_equal(kbuf[:n], keys) and not kbuf[n:].any()
    assert slots[:6] == [0, 1, 0, 1, 0, 1]
    a, b = _images(3, seed=40), _images(4, seed=41)
    ka = _keys(3, 100) if dispatch == "exact" else np.uint32([0, 100])
    kb = _keys(4, 200) if dispatch == "exact" else np.uint32([0, 200])
    ha, hb = ap.apply_async(a, ka), ap.apply_async(b, kb)
    assert np.array_equal(hb.materialize(), ref.apply_eager(b, kb))
    assert np.array_equal(ha.materialize(), ref.apply_eager(a, ka))
    assert ap._staging[4][0] is not ap._staging[4][1]


@pytest.mark.parametrize("policy,dispatch,shape", [(SINGLE_SUB, "exact", 4),
                                                   (MULTI_SUB, "grouped", 4),
                                                   (MULTI_SUB, "exact", 1)])
def test_export_round_trip_bitwise(policy, dispatch, shape):
    ap = ps.PolicyApplier(policy, image=IMG, shapes=(1, 4), dispatch=dispatch, groups=2,
                          device="cpu")
    blob = ap.export_serialized(shape)
    assert blob.startswith(ps.EXPORT_MAGIC)
    fn = ps.deserialize_apply(blob, device="cpu")
    imgs = _images(shape, seed=7)
    keys = _keys(shape, 5) if dispatch == "exact" else np.uint32([3, 9])
    assert np.array_equal(fn(imgs, keys), ap.apply(imgs, keys))
    assert fn.applier.digest == ap.digest and fn.applier.shapes == (shape,)
    with pytest.raises(ValueError):
        fn(_images(shape + 1), _keys(shape + 1) if dispatch == "exact" else keys)
    with pytest.raises(ValueError):
        ps.deserialize_apply(b"FAAX9\n{}\n")
    tampered = bytearray(blob)
    tampered[-1] ^= 0x01
    with pytest.raises(ValueError, match="digest"):
        ps.deserialize_apply(bytes(tampered), device="cpu")
    with pytest.raises(KeyError):
        ap.export_serialized(3)


# ---------------------------------------- state machines vs the JAX package


@pytest.mark.parametrize("seed", range(4))
def test_request_queue_drain_order_equals_jax(seed):
    """Offers and takes under the depth and age watermarks: the same
    admissions and the same take order as the JAX queue."""
    g = np.random.default_rng(seed)
    depth = int(g.integers(3, 9))
    kw = {"lifo_depth": int(g.choice([0, 2, 4])), "lifo_age_ms": float(g.choice([0.0, 5e3]))}
    queues = {"jax": (jax_ps._RequestQueue(depth, **kw), jax_ps._Pending),
              "port": (ps._RequestQueue(depth, **kw), ps._Pending)}
    trace = {name: [] for name in queues}
    img = np.zeros((1, 2, 2, 3), np.float32)
    for step in range(60):
        offer = g.random() < 0.55
        old = g.random() < 0.3  # 10 s old: past the age watermark
        for name, (q, pending_cls) in queues.items():
            if offer:
                p = pending_cls(img, None)
                p.keys = step  # the request's identity
                if old:
                    p.t_submit -= 10.0
                trace[name].append(("offer", step, q.offer(p)))
            else:
                got = q.take(timeout=0.0)
                trace[name].append(("take", None if got is None else got.keys, len(q)))
    assert trace["port"] == trace["jax"]
    assert queues["port"][0].lifo_takes == queues["jax"][0].lifo_takes


@pytest.mark.parametrize("seed", range(4))
def test_tenant_pool_evictions_equal_jax(seed):
    g = np.random.default_rng(seed)
    cap = int(g.integers(1, 4))
    tag = uuid.uuid4().hex[:8]
    pools = {"jax": jax_ps.TenantPool(cap, f"jax{tag}"),
             "port": ps.TenantPool(cap, f"port{tag}")}
    trace = {name: [] for name in pools}
    digests = [f"d{i}" for i in range(6)]
    for _ in range(80):
        op = g.choice(["admit", "submit", "dispatch", "track", "done", "sweep"])
        d = str(g.choice(digests))
        for name, pool in pools.items():
            if op == "admit":
                out = pool.admit(d, f"applier-{d}")
            elif op == "submit":
                out = pool.lookup_submit(d)
            elif op == "dispatch":
                out = pool.lookup_dispatch(d)
            elif op == "track":
                out = pool.track_submit(d)
            elif op == "done":
                out = pool.track_done(d)
            else:
                out = pool.sweep()
            trace[name].append((op, d, out, pool.resident_digests()))
    assert trace["port"] == trace["jax"]
    assert pools["port"].snapshot() == pools["jax"].snapshot()


class Stand:
    """A host-only applier: adds `delta` to the images and records what it
    was given, so a test can tell which applier served a request."""

    def __init__(self, delta=1.0, dispatch="exact", max_batch=4, digest=None):
        self.delta = float(delta)
        self.dispatch = dispatch
        self.max_batch = max_batch
        self.image, self.channels, self.num_sub = IMG, 3, 1
        self.shapes = (max_batch,)
        self.digest = digest
        self.seen: list[np.ndarray] = []

    def apply(self, images, keys):
        self.seen.append(np.array(images, np.float32))
        return np.asarray(images, np.float32) + self.delta


def _drive(server_cls, fault: str, n_requests: int, **kw):
    """Sequential requests through one server built by `server_cls` under
    the ``FAA_FAULT`` spec `fault`: each request's outcome, the stand-in's
    inputs and the server's stats."""
    os.environ["FAA_FAULT"] = fault
    faultinject.reset()
    jax_faultinject.reset()
    stand = Stand()
    srv = server_cls(stand, max_wait_ms=1, **kw).start()
    outcomes = []
    try:
        for i in range(n_requests):
            try:
                out = srv.augment(_images(2, seed=i), _keys(2, 10 * i), timeout=30)
                outcomes.append(("ok", out))
            except Exception as e:  # noqa: BLE001 -- the outcome under test
                outcomes.append((type(e).__name__, None))
    finally:
        srv.stop()  # joins the worker: its accounting after the last answer is in
    return outcomes, stand.seen, srv.stats()


def test_breaker_opens_from_faa_fault_like_jax():
    fault = "serve_error@dispatch=1;serve_error@dispatch=2"
    kw = {"breaker_threshold": 2, "breaker_cooldown_s": 60.0}
    got = _drive(ps.PolicyServer, fault, 4, **kw)
    want = _drive(jax_ps.PolicyServer, fault, 4, **kw)
    assert [o for o, _ in got[0]] == ["ServeError", "ServeError", "CircuitOpenError",
                                      "CircuitOpenError"]
    assert [o for o, _ in got[0]] == [o for o, _ in want[0]]
    for key in ("admitted", "shed_breaker", "shed_overload", "expired"):
        assert got[2]["admission"][key] == want[2]["admission"][key], key
    for key in ("state", "consecutive_failures", "threshold"):
        if key in want[2]["breaker"]:
            assert got[2]["breaker"][key] == want[2]["breaker"][key], key
    assert got[2]["breaker"]["state"] == "open"


def test_drift_and_traffic_gauges_equal_jax():
    fault = "drift@dispatch=3,shift=40"
    got = _drive(ps.PolicyServer, fault, 6, traffic_stats=True)
    want = _drive(jax_ps.PolicyServer, fault, 6, traffic_stats=True)
    assert len(got[1]) == len(want[1]) == 6
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not np.array_equal(got[1][2], _images(2, seed=2))  # drifted from dispatch 3
    assert np.array_equal(got[1][1], _images(2, seed=1))
    for (oa, a), (ob, b) in zip(got[0], want[0]):
        assert oa == ob == "ok" and np.array_equal(a, b)
    assert got[2]["traffic"] == want[2]["traffic"]


def test_swap_applier_under_traffic_drops_nothing():
    """Requests keep arriving while the server swaps between two appliers:
    every request completes, each with one applier's output, bitwise."""
    a = ps.PolicyApplier(SINGLE_SUB, image=IMG, shapes=(1, 4), device="cpu")
    b = ps.PolicyApplier(SINGLE_SUB_2, image=IMG, shapes=(1, 4), device="cpu", donate=True)
    srv = ps.PolicyServer(a, max_wait_ms=2, double_buffer=True).start()
    results, errors = [], []

    def client(c):
        for i in range(12):
            imgs, keys = _images(1, seed=100 * c + i), _keys(1, 1000 * c + i)
            try:
                results.append((imgs, keys, srv.augment(imgs, keys, timeout=60)))
            except Exception as e:  # noqa: BLE001 -- counted below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()
    swaps = 0
    while any(t.is_alive() for t in threads):
        srv.swap_applier(b if swaps % 2 == 0 else a)
        swaps += 1
        time.sleep(0.01)
    for t in threads:
        t.join(timeout=60)
    srv.stop()
    assert not errors and len(results) == 36
    for imgs, keys, out in results:
        assert any(np.array_equal(out, ap.apply_eager(imgs, keys)) for ap in (a, b))
    assert srv.stats()["reloads"] == swaps
    with pytest.raises(ValueError):
        srv.swap_applier(ps.PolicyApplier(MULTI_SUB, image=IMG, shapes=(4,), device="cpu",
                                          dispatch="grouped"))


def test_double_buffered_donated_server_matches_sequential():
    """Grouped dispatch keys are the server's (0, d): the same request
    sequence through a double-buffered server on a donated applier and
    through the sequential server gives the same bytes."""
    outs = []
    for db, donate in ((False, False), (True, True)):
        ap = ps.PolicyApplier(MULTI_SUB, image=IMG, shapes=(1, 4), groups=2, device="cpu",
                              donate=donate)
        srv = ps.PolicyServer(ap, max_wait_ms=1, double_buffer=db).start()
        try:
            outs.append([srv.augment(_images(n, seed=n)) for n in (3, 1, 4, 2, 4)])
        finally:
            srv.stop()  # joins the worker: its accounting after the last answer is in
        assert srv.stats()["dispatches"] == 5
        assert ("data_plane" in srv.stats()) == db
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def test_tenancy_serves_evicts_and_refuses_cold():
    default = ps.PolicyApplier(SINGLE_SUB, image=IMG, shapes=(1, 4), device="cpu")
    t2 = ps.PolicyApplier(SINGLE_SUB_2, image=IMG, shapes=(1, 4), device="cpu")
    t3 = ps.PolicyApplier(SINGLE_SUB_3, image=IMG, shapes=(1, 4), device="cpu")
    srv = ps.PolicyServer(default, max_wait_ms=1, tenant_capacity=1).start()
    try:
        imgs, keys = _images(2, seed=3), _keys(2, 30)
        with pytest.raises(ps.TenantNotResidentError):
            srv.augment(imgs, keys, digest=t2.digest)
        assert srv.warm_tenant(t2)["resident"] == [t2.digest]
        assert np.array_equal(srv.augment(imgs, keys, digest=t2.digest),
                              t2.apply_eager(imgs, keys))
        assert np.array_equal(srv.augment(imgs, keys, digest=default.digest),
                              default.apply_eager(imgs, keys))
        info = srv.warm_tenant(t3)
        assert info["evicted"] == [t2.digest] and info["resident"] == [t3.digest]
        with pytest.raises(ps.TenantNotResidentError) as e:
            srv.augment(imgs, keys, digest=t2.digest)
        assert e.value.resident == (t3.digest,)
        assert np.array_equal(srv.augment(imgs, keys, digest=t3.digest),
                              t3.apply_eager(imgs, keys))
        deadline = time.monotonic() + 10  # the worker sweeps after its dispatch
        while srv.stats()["tenancy"]["retiring"] and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = srv.stats()["tenancy"]
        assert snap["retiring"] == [] and snap["evicts"] == 1  # swept at a boundary
        with pytest.raises(ValueError):
            srv.warm_tenant(default)
    finally:
        srv.stop()


def test_breaker_exit_loop_exits_77():
    srv = ps.PolicyServer(Stand(), breaker_threshold=1, breaker_cooldown_s=60.0)
    state = serve_cli.ServeState(srv, "fa_reduced_cifar10")
    srv.breaker.record_failure()
    serve_cli._breaker_exit_loop(state, poll_s=0.01)
    assert state.exit_code == PREEMPTED_EXIT_CODE == 77 and state.stop_event.is_set()
    assert state.ready() == (False, "worker not running") and srv.breaker.is_open()
    with pytest.raises(ps.ServerStoppedError):  # the shutdown closed admission
        srv.submit(_images(1), _keys(1))
    srv2 = ps.PolicyServer(Stand(), breaker_threshold=1, breaker_cooldown_s=60.0).start()
    try:
        srv2.breaker.record_failure()
        assert serve_cli.ServeState(srv2, "x").ready() == (False, "circuit breaker open")
        with pytest.raises(CircuitOpenError):
            srv2.submit(_images(1), _keys(1))
    finally:
        srv2.stop()


# ------------------------------------------------------- the HTTP process


def _post(port, path, body, ctype="application/json", headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_serve_cli_answers_every_endpoint(tmp_path):
    """One replica on the CPU with every serving-plane flag: its records,
    /augment in three lanes (raw, frames, shm) bitwise equal, /metrics,
    tenancy with a cold-digest recipe, /reload and SIGHUP, then SIGTERM."""
    pols = {}
    for name, arr in (("a", SINGLE_SUB), ("b", SINGLE_SUB_2), ("c", SINGLE_SUB_3)):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(archive.tensor_to_policy(arr)))
        pols[name] = (str(path), ps.PolicyApplier(arr, image=IMG, shapes=(1, 4),
                                                  device="cpu"))
    policy_dir = tmp_path / "policies"
    policy_dir.mkdir()
    (policy_dir / "c-copy.json").write_text(json.dumps(archive.tensor_to_policy(SINGLE_SUB_3)))
    port_dir, beats, journal = tmp_path / "ports", tmp_path / "beats", tmp_path / "journal"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("FAA_FAULT", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fast_autoaugment_tpu_torch.serve.serve_cli",
         "--policy", pols["a"][0], "--image", str(IMG), "--shapes", "1,4", "--device", "cpu",
         "--port", "0", "--port-dir", str(port_dir), "--host-tag", "r0",
         "--heartbeat-dir", str(beats), "--tenant-capacity", "2", "--policy-dir",
         str(policy_dir), "--donate", "--double-buffer", "--shm-ingest", "--traffic-stats",
         "--breaker-threshold", "3", "--breaker-exit", "--watchdog", "auto", "--telemetry",
         str(journal), "--max-inflight", "8"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        record = port_dir / "r0.json"
        assert _wait(record.exists), proc.stdout.read().decode()[-3000:] \
            if proc.poll() is not None else "no port-dir record"
        rec = json.loads(record.read_text())
        jax_cli._write_beat(str(tmp_path / "jax_beat.json"), "r0")
        assert set(rec) == {"tag", "host", "port", "pid", "started_at"}
        assert (rec["tag"], rec["pid"]) == ("r0", proc.pid)
        port = rec["port"]
        beat_file = beats / "hosts" / "r0.json"
        assert _wait(beat_file.exists)
        beat = json.loads(beat_file.read_text())
        assert set(beat) == set(json.loads((tmp_path / "jax_beat.json").read_text()))
        assert beat["owner"] == "r0" and beat["done"] is False
        assert json.loads(_get(port, "/readyz"))["ready"] is True

        imgs, keys = _images(3, seed=5, dtype=np.uint8), _keys(3, 70)
        want = np.clip(pols["a"][1].apply_eager(imgs, keys), 0, 255).astype(np.uint8)
        status, body = _post(port, "/augment", wire.encode_raw(imgs, seeds=keys),
                             wire.RAW_CONTENT_TYPE)
        assert status == 200 and np.array_equal(wire.decode_raw(body)[0], want)
        frames = wire.encode_frames([
            ({"ctype": wire.RAW_CONTENT_TYPE}, wire.encode_raw(imgs[:2], seeds=keys[:2])),
            ({"ctype": wire.RAW_CONTENT_TYPE}, wire.encode_raw(imgs[2:], seeds=keys[2:])),
            ({"ctype": wire.RAW_CONTENT_TYPE}, b"garbage")])
        status, body = _post(port, "/augment_batch", frames, wire.FRAME_CONTENT_TYPE)
        parts = wire.decode_frames(body)
        assert status == 200 and [m["status"] for m, _ in parts] == [200, 200, 400]
        got = np.concatenate([wire.decode_raw(bytes(b))[0] for _, b in parts[:2]])
        assert np.array_equal(got, want)
        region = wire.ShmRegion(imgs.shape, np.uint8)
        try:
            region.write(imgs)
            status, body = _post(port, "/augment", region.request_body(seeds=keys),
                                 wire.SHM_CONTENT_TYPE)
            assert status == 200 and json.loads(body)["shm"] == region.name
            assert np.array_equal(region.read_result(), want)
        finally:
            region.close()

        metrics = _get(port, "/metrics").decode()
        for family in ("faa_serve_dispatches_total", "faa_serve_images_total",
                       "faa_serve_robustness_total", "faa_serve_stage_seconds",
                       "faa_serve_queue_depth", "faa_serve_input_mean",
                       "faa_serve_reward_proxy", "faa_tenant_resident"):
            assert family in metrics, family

        b_path, b_ap = pols["b"]
        status, body = _post(port, "/tenants/warm", json.dumps({"policy": b_path}).encode())
        assert status == 200 and json.loads(body)["digest"] == b_ap.digest
        status, body = _post(port, "/augment", wire.encode_raw(imgs, seeds=keys),
                             wire.RAW_CONTENT_TYPE, {serve_cli.DIGEST_HEADER: b_ap.digest})
        want_b = np.clip(b_ap.apply_eager(imgs, keys), 0, 255).astype(np.uint8)
        assert status == 200 and np.array_equal(wire.decode_raw(body)[0], want_b)
        c_ap = pols["c"][1]
        status, body = _post(port, "/augment", wire.encode_raw(imgs, seeds=keys),
                             wire.RAW_CONTENT_TYPE, {serve_cli.DIGEST_HEADER: c_ap.digest})
        cold = json.loads(body)
        assert status == 503 and cold["type"] == "tenant_cold" and cold["warming"] is True

        def c_served():
            s, b = _post(port, "/augment", wire.encode_raw(imgs, seeds=keys),
                         wire.RAW_CONTENT_TYPE, {serve_cli.DIGEST_HEADER: c_ap.digest})
            return s == 200 and np.array_equal(
                wire.decode_raw(b)[0], np.clip(c_ap.apply_eager(imgs, keys), 0, 255)
                .astype(np.uint8))
        assert _wait(c_served)

        status, body = _post(port, "/reload", json.dumps({"policy": pols["c"][0]}).encode())
        info = json.loads(body)
        assert status == 200 and info["reloaded"] and info["digest"] == c_ap.digest
        req = urllib.request.Request(f"http://127.0.0.1:{port}/augment",
                                     data=wire.encode_raw(imgs, seeds=keys),
                                     headers={"Content-Type": wire.RAW_CONTENT_TYPE})
        with urllib.request.urlopen(req, timeout=60) as r:  # the answer names its policy
            assert r.headers[serve_cli.DIGEST_HEADER] == c_ap.digest
            assert np.array_equal(wire.decode_raw(r.read())[0], np.clip(
                c_ap.apply_eager(imgs, keys), 0, 255).astype(np.uint8))
        assert _post(port, "/reload", b"[1]")[0] == 400
        proc.send_signal(signal.SIGHUP)  # reloads the --policy it started with
        assert _wait(lambda: json.loads(_get(port, "/stats"))["reloads"] == 2)
        stats = json.loads(_get(port, "/stats"))
        assert stats["policy_digest"] == pols["a"][1].digest
        assert stats["data_plane"] == {"donate": True, "double_buffer": True}
        assert stats["kernel_launches"]["augment"] == 0 and stats["graphs"] is False
        assert stats["traffic"]["samples"] >= 5 and stats["tenancy"]["capacity"] == 2
        assert _wait(lambda: (lambda st: st["admission"]["admitted"] == st["requests"])(
            json.loads(_get(port, "/stats"))))  # every admitted request was served
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert not record.exists()
        assert json.loads(beat_file.read_text())["done"] is True
        assert any(n.endswith(".jsonl") for n in os.listdir(journal))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
