"""The port's serving path (``fast_autoaugment_tpu_torch.serve``) on the CPU.

Oracles: the JAX package's ``AotPolicyApplier`` compiled without fused
multiply-add (bitwise, given the JAX key tree's draws through a replay
draw source; see ``test_torch_replay.py``), its policy codec and
``policy_digest`` (byte-equal), and the port's own applier for the HTTP
round trip and the coalescing contract.  Runs with ``device="cpu"``;
nothing here needs a card.
"""

import io
import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.policies import archive as jax_archive
from fast_autoaugment_tpu.serve import serve_cli as jax_cli
from fast_autoaugment_tpu.serve.policy_server import policy_digest as jax_digest
from fast_autoaugment_tpu_torch.policies import archive
from fast_autoaugment_tpu_torch.serve import serve_cli, wire
from fast_autoaugment_tpu_torch.serve.policy_server import (
    DeadlineExpiredError,
    PolicyApplier,
    PolicyServer,
    ServerOverloadedError,
    ServerStoppedError,
    pick_shape,
    policy_digest,
)
from test_torch_replay import jax_draw_source, jax_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 8
# single-sub (exact) and multi-sub (grouped); blends, a warp and a cutout
SINGLE_SUB = np.array([[[13, 0.8, 0.7], [10, 0.9, 0.3]]], np.float32)
MULTI_SUB = np.array([
    [[4, 0.8, 0.7], [10, 0.5, 0.3]],
    [[0, 0.5, 0.5], [11, 0.9, 0.5]],
    [[8, 0.9, 0.2], [14, 0.9, 0.6]],
], np.float32)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3)).astype(np.float32)


def _keys(n, base=0):
    return np.stack([np.asarray(jax.random.PRNGKey(base + i), np.uint32) for i in range(n)])


# ------------------------------------------------------ policy identity


@pytest.mark.parametrize("name", archive.ARCHIVES)
def test_policy_tensor_and_digest_byte_equal(name):
    got = archive.policy_to_tensor(archive.load_policy(name))
    want = jax_archive.policy_to_tensor(jax_archive.load_policy(name))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert policy_digest(got) == jax_digest(want)
    assert archive.tensor_to_policy(got) == jax_archive.tensor_to_policy(want)


def test_final_policy_json_byte_equal(tmp_path):
    path = tmp_path / "final_policy.json"
    path.write_text(json.dumps([[["Rotate", 0.4, 0.9], ["Equalize", 1.0, 0.2]],
                                [["Cutout", 0.7, 0.33]]]))
    got = serve_cli.build_policy_tensor(str(path))
    want = jax_cli.build_policy_tensor(str(path))
    assert got.tobytes() == want.tobytes() and got.shape == (2, 2, 3)
    assert policy_digest(got) == jax_digest(want)
    assert serve_cli.build_policy_tensor("fa_reduced_cifar10").tobytes() == \
        jax_cli.build_policy_tensor("fa_reduced_cifar10").tobytes()


# -------------------------------------------- applier vs AotPolicyApplier


EXACT_CALLS = ((3, 1), (1, 2), (7, 3))  # (n, seed): pad 3->4, exact fit 1, chunk 4+3
GROUPED_SEEDS = (7, 8, 9)


def _exact_calls():
    return [(_images(n, seed), _keys(n, base=10 * seed)) for n, seed in EXACT_CALLS]


def _grouped_calls():
    # 3 images padded to 4 before the draws, as the JAX path does
    return [(_images(3, seed), np.asarray(jax.random.PRNGKey(seed), np.uint32))
            for seed in GROUPED_SEEDS]


@pytest.fixture(scope="module")
def aot_refs(tmp_path_factory):
    """``AotPolicyApplier.apply`` outputs, exact and grouped, from one
    FMA-free JAX process (see ``test_torch_replay.py``)."""
    jobs = [
        {"kind": "aot", "policy": SINGLE_SUB, "image": IMG, "shapes": (1, 4),
         "dispatch": "auto", "groups": 8, "calls": _exact_calls()},
        {"kind": "aot", "policy": MULTI_SUB, "image": IMG, "shapes": (4,),
         "dispatch": "auto", "groups": 2, "calls": _grouped_calls()},
    ]
    exact, grouped = jax_reference(jobs, tmp_path_factory.mktemp("aot"))
    return {"exact": exact, "grouped": grouped}


def test_exact_applier_bitwise_vs_aot(aot_refs):
    port = PolicyApplier(SINGLE_SUB, image=IMG, shapes=(1, 4), dispatch="auto",
                         device="cpu", draw_source=jax_draw_source)
    assert port.dispatch == aot_refs["exact"]["dispatch"] == "exact"
    for (imgs, keys), want in zip(_exact_calls(), aot_refs["exact"]["outputs"]):
        assert np.array_equal(port.apply(imgs, keys), want)


def test_grouped_applier_bitwise_vs_aot(aot_refs):
    port = PolicyApplier(MULTI_SUB, image=IMG, shapes=(4,), dispatch="auto", groups=2,
                         device="cpu", draw_source=jax_draw_source)
    assert port.dispatch == aot_refs["grouped"]["dispatch"] == "grouped"
    for (imgs, key), want in zip(_grouped_calls(), aot_refs["grouped"]["outputs"]):
        assert np.array_equal(port.apply(imgs, key), want)


def test_pick_shape_and_validation():
    assert pick_shape((1, 8, 32), 1) == 1
    assert pick_shape((1, 8, 32), 2) == 8
    assert pick_shape((1, 8, 32), 32) == 32
    with pytest.raises(ValueError):
        pick_shape((1, 8), 9)
    ap = PolicyApplier(SINGLE_SUB, image=IMG, shapes=(2, 4), device="cpu")
    with pytest.raises(ValueError):
        ap.apply(np.zeros((2, 4, 4, 3), np.float32), _keys(2))
    with pytest.raises(ValueError):
        PolicyApplier(np.zeros((3, 2)), image=IMG, device="cpu")
    with pytest.raises(ValueError):
        PolicyApplier(SINGLE_SUB, image=IMG, dispatch="nope", device="cpu")
    with pytest.raises(ValueError):
        PolicyApplier(np.float32([[[25, 1.0, 0.5]]]), image=IMG, device="cpu")


def test_padding_never_leaks_and_uint8_input():
    ap = PolicyApplier(MULTI_SUB, image=IMG, shapes=(2, 4), dispatch="exact", device="cpu")
    imgs, keys = _images(2, seed=3), _keys(2, base=9)
    via_2 = ap.apply(imgs, keys)
    via_4 = ap.apply(np.concatenate([imgs, _images(1, seed=4)]), _keys(3, base=9))[:2]
    assert np.array_equal(via_2, via_4)
    assert np.array_equal(ap.apply(imgs.astype(np.uint8), keys), via_2)
    out = ap.apply(imgs, keys)
    assert out.dtype == np.float32 and out.min() >= 0 and out.max() <= 255
    assert np.array_equal(out, np.trunc(out))


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        PolicyApplier(SINGLE_SUB, image=IMG)


# ------------------------------------------------------------ the server


@pytest.fixture()
def applier_cpu():
    return PolicyApplier(SINGLE_SUB, image=IMG, shapes=(1, 4), device="cpu")


def test_server_coalesces_and_scatters_fifo(applier_cpu):
    srv = PolicyServer(applier_cpu, max_wait_ms=50).start()
    try:
        imgs, keys = _images(4, seed=7), _keys(4, base=50)
        p1 = srv.submit(imgs[:2], keys[:2])
        p2 = srv.submit(imgs[2:3], keys[2:3])
        p3 = srv.submit(imgs[3:4], keys[3:4])
        got = np.concatenate([srv.result(p1), srv.result(p2), srv.result(p3)])
        assert np.array_equal(got, applier_cpu.apply(imgs, keys))
        st = srv.stats()
        assert st["requests"] == 3 and st["images_served"] == 4
        assert st["dispatches"] < 3  # the window coalesced them
        assert st["policy_digest"] == policy_digest(SINGLE_SUB)
    finally:
        srv.stop()


def test_lane_output_independent_of_coalescing(applier_cpu):
    """Exact dispatch: a request's bytes do not depend on what it was
    batched with (keys pinned per image)."""
    imgs, keys = _images(4, seed=11), _keys(4, base=70)
    srv = PolicyServer(applier_cpu, max_wait_ms=80).start()
    try:
        alone = srv.augment(imgs[1:2], keys[1:2])
        burst = [srv.submit(imgs[i:i + 1], keys[i:i + 1]) for i in range(4)]
        outs = [srv.result(p) for p in burst]
        assert np.array_equal(outs[1], alone)
        assert srv.stats()["dispatches"] >= 2
    finally:
        srv.stop()


def test_server_auto_keys_are_distinct_and_monotonic(applier_cpu):
    srv = PolicyServer(applier_cpu, seed=3)
    k1, k2 = srv._auto_keys(3), srv._auto_keys(2)
    assert k1.dtype == np.uint32 and k1.shape == (3, 2)
    assert {tuple(r) for r in np.concatenate([k1, k2])} == {(3, i) for i in range(5)}


def test_server_admission_deadline_and_drain(applier_cpu):
    srv = PolicyServer(applier_cpu, queue_depth=2, max_wait_ms=1)
    a = srv.submit(_images(1), _keys(1))
    b = srv.submit(_images(1), _keys(1), deadline_ms=1)
    with pytest.raises(ServerOverloadedError):
        srv.submit(_images(1), _keys(1))
    time.sleep(0.02)
    srv.start()
    assert srv.result(a).shape == (1, IMG, IMG, 3)
    with pytest.raises(DeadlineExpiredError):
        srv.result(b)
    assert srv.drain(timeout=5.0)
    with pytest.raises(ServerStoppedError):
        srv.submit(_images(1), _keys(1))
    adm = srv.stats()["admission"]
    assert (adm["shed_overload"], adm["expired"], adm["shed_stopped"]) == (1, 1, 1)
    with pytest.raises(ValueError):
        srv.submit(_images(5), _keys(5))  # above max_batch


def test_grouped_server_serves_padded_draws():
    ap = PolicyApplier(MULTI_SUB, image=IMG, shapes=(4,), groups=2, device="cpu")
    srv = PolicyServer(ap, max_wait_ms=30).start()
    try:
        imgs = _images(3, seed=5)
        out = srv.augment(imgs)
        key = np.uint32([0, 0])  # the server's first auto key with seed 0
        assert np.array_equal(out, ap.apply(imgs, key))
    finally:
        srv.stop()


# ------------------------------------------------------ the HTTP entry point


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _post(port, body, ctype, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/augment", data=body,
                                 headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def test_serve_cli_http_round_trip(tmp_path):
    pol = tmp_path / "final_policy.json"
    pol.write_text(json.dumps(archive.tensor_to_policy(SINGLE_SUB)))
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "fast_autoaugment_tpu_torch.serve.serve_cli",
         "--policy", str(pol), "--image", str(IMG), "--shapes", "1,4",
         "--device", "cpu", "--port", "0", "--port-file", str(port_file),
         "--max-body-mb", "1"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while not port_file.exists() and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.05)
        port = int(port_file.read_text())
        assert _get(port, "/healthz") == {"ok": True}
        assert _get(port, "/readyz")["ready"] is True
        ref = PolicyApplier(SINGLE_SUB, image=IMG, shapes=(1, 4), device="cpu")
        imgs = _images(3, seed=21).astype(np.uint8)
        seeds = np.array([5, 6, 2**33 + 7])
        buf = io.BytesIO()
        np.savez(buf, images=imgs, seeds=seeds)
        status, body = _post(port, buf.getvalue(), "application/octet-stream")
        assert status == 200
        got = np.load(io.BytesIO(body))["images"]
        keys = serve_cli.seed_keys(seeds)
        assert keys.tolist() == [[0, 5], [0, 6], [0, 7]]
        assert got.dtype == np.uint8 and np.array_equal(got, ref.apply(imgs, keys))
        status, body = _post(port, wire.encode_raw(imgs.astype(np.float32), seeds=keys),
                             wire.RAW_CONTENT_TYPE)
        raw, _ = wire.decode_raw(body)
        assert status == 200 and raw.dtype == np.uint8 and np.array_equal(raw, got)
        status, body = _post(port, b"not an npz", "application/octet-stream")
        assert status == 400 and json.loads(body)["type"] == "bad_request"
        status, body = _post(port, b"x" * (2 << 20), "application/octet-stream")
        assert status == 413 and json.loads(body)["type"] == "body_too_large"
        stats = _get(port, "/stats")
        assert stats["images_served"] == 6 and stats["device"] == "cpu"
        assert stats["kernel_launches"] == {"augment": 0, "cifar_stack": 0, "imagenet_stack": 0,
                                            "sampler": 0, "train_noise": 0}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_refused_body_is_read_so_the_answer_arrives():
    """A 413 answer reaches a client that sends its body after the answer:
    the handler reads and discards the refused body before it closes, where
    closing with the body unread resets the connection mid-send."""
    httpd = serve_cli._ServeHTTPServer(("127.0.0.1", 0),
                                       serve_cli.make_handler(None, max_body_bytes=1024))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    body_len = 4 << 20
    try:
        with socket.create_connection(httpd.server_address, timeout=30) as sock:
            sock.sendall(f"POST /augment HTTP/1.1\r\nHost: x\r\nContent-Length: {body_len}"
                         f"\r\nContent-Type: application/octet-stream\r\n\r\n".encode())
            assert select.select([sock], [], [], 30)[0]  # the answer comes first
            sock.sendall(b"x" * body_len)  # reset here if the handler closed unread
            answer = b""
            while chunk := sock.recv(1 << 16):
                answer += chunk
        head, _, payload = answer.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 413")
        assert json.loads(payload)["type"] == "body_too_large"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_cli_without_gpu_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run(
        [sys.executable, "-m", "fast_autoaugment_tpu_torch.serve.serve_cli",
         "--policy", "fa_reduced_cifar10", "--port", "0"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "--device cpu" in proc.stderr


def test_serve_cli_rejects_deferred_flags():
    """The port's serve_cli takes every flag of the JAX serve_cli, with the
    same defaults, plus ``--device``, and rejects a flag neither has."""
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.required)
                for a in parser._actions if a.option_strings and a.dest != "help"}

    port, ref = flags(serve_cli.build_parser()), flags(jax_cli.build_parser())
    assert set(port) - set(ref) == {"device"} and set(ref) <= set(port)
    for dest, spec in ref.items():
        assert port[dest] == spec, dest
    with pytest.raises(SystemExit):
        serve_cli.build_parser().parse_args(["--policy", "x", "--no-such-flag", "2"])


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import fast_autoaugment_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n.startswith('jaxlib') or n == 'fast_autoaugment_tpu'\n"
        "             or n.startswith('fast_autoaugment_tpu.'))\n"
        "print(len([n for n in sys.modules if n.startswith('fast_autoaugment_tpu_torch')]))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 14  # every module of the port was imported


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
