"""The port's router, autoscaler and shared-filesystem fault seam
(``fast_autoaugment_tpu_torch/serve/router.py``, ``router_cli.py``,
``autoscaler.py``, ``core/fsfault.py``) against the JAX package's copies:
rendezvous order, port-dir discovery, the Prometheus parser, the
autoscaler's decisions over seeded signal traces, the ``FAA_FSFAULT``
grammar and reads, and the router's rotation and failover against
in-process stub replicas, each scenario driven through both packages'
routers and compared.

Host code only (none of these modules imports JAX or torch): bound is
equality of every answer, order and counter.
"""

from __future__ import annotations

import errno
import itertools
import json
import os
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from fast_autoaugment_tpu.core import fsfault as jax_fsfault
from fast_autoaugment_tpu.core import telemetry as jax_telemetry
from fast_autoaugment_tpu.serve import autoscaler as jax_autoscaler
from fast_autoaugment_tpu.serve import router as jax_router
from fast_autoaugment_tpu.serve import router_cli as jax_router_cli
from fast_autoaugment_tpu.utils import faultinject as jax_faultinject
from fast_autoaugment_tpu_torch.core import fsfault, telemetry
from fast_autoaugment_tpu_torch.serve import autoscaler, router, router_cli
from fast_autoaugment_tpu_torch.utils import faultinject

_SEQ = itertools.count()
PAIRS = [(router, faultinject), (jax_router, jax_faultinject)]


@pytest.fixture(autouse=True)
def _clean_env():
    saved = {k: os.environ.pop(k, None) for k in ("FAA_FAULT", "FAA_FSFAULT")}
    for mod in (faultinject, jax_faultinject, fsfault, jax_fsfault):
        mod.reset()
    yield
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v
    for mod in (faultinject, jax_faultinject, fsfault, jax_fsfault):
        mod.reset()


# ------------------------------------------------------------ pure functions


@pytest.mark.parametrize("seed", range(3))
def test_rendezvous_order_equals_jax(seed):
    g = np.random.default_rng(seed)
    for _ in range(50):
        ids = [f"host{int(i)}" for i in g.choice(40, int(g.integers(1, 9)), replace=False)]
        digest = "%012x" % int(g.integers(0, 2**48))
        assert router.rendezvous_order(digest, ids) == jax_router.rendezvous_order(digest, ids)


def test_static_replicas_and_discovery_equal_jax(tmp_path):
    spec = "127.0.0.1:8001, localhost:9000,[::1]:7"
    assert router.parse_static_replicas(spec) == jax_router.parse_static_replicas(spec)
    for bad in ("nohost", "h:x", ":80"):
        with pytest.raises(ValueError):
            router.parse_static_replicas(bad)
        with pytest.raises(ValueError):
            jax_router.parse_static_replicas(bad)
    d = tmp_path / "ports"
    d.mkdir()
    (d / "r0.json").write_text(json.dumps({"tag": "r0", "host": "127.0.0.1", "port": 5,
                                           "pid": 11, "started_at": 1.0}))
    (d / "r1.json").write_text(json.dumps({"host": "h", "port": "6"}))
    (d / "torn.json").write_text('{"tag": "x", "ho')
    (d / "nope.json").write_text(json.dumps({"tag": "y"}))
    (d / ".hidden.json").write_text(json.dumps({"host": "h", "port": 1}))
    (d / "r2.json.tmp.5").write_text("{}")
    got = router.discover_replicas(str(d))
    assert sorted(got, key=lambda r: r["tag"]) == sorted(
        jax_router.discover_replicas(str(d)), key=lambda r: r["tag"])
    assert {r["tag"] for r in got} == {"r0", "r1"}
    assert router.discover_replicas(str(tmp_path / "missing")) == [] == \
        jax_router.discover_replicas(str(tmp_path / "missing"))


def test_prometheus_parser_equals_jax_on_both_registries():
    texts = []
    for tel in (telemetry, jax_telemetry):
        reg = tel.MetricsRegistry()
        reg.gauge("faa_serve_queue_depth", "q", server="3").set(7.0)
        reg.counter("faa_serve_robustness_total", "r", counter="shed_overload",
                    server="3").inc(11)
        reg.counter("faa_serve_robustness_total", "r", counter="admitted", server="3").inc(2)
        reg.gauge("faa_breaker_open", "b", breaker="serve3").set(1.0)
        reg.histogram("faa_serve_stage_seconds", "h", buckets=(1e-4, 1e-2),
                      stage="pad", server="3").observe(2e-3)
        texts.append(reg.prometheus_text())
    assert texts[0] == texts[1]
    for text in texts:
        assert autoscaler.parse_prometheus_text(text) == \
            jax_autoscaler.parse_prometheus_text(text)
    fams = autoscaler.parse_prometheus_text(texts[0])
    assert fams["faa_serve_queue_depth"] == [({"server": "3"}, 7.0)]
    assert "faa_serve_stage_seconds_bucket" in fams


@pytest.mark.parametrize("seed", range(4))
def test_autoscaler_decisions_equal_jax(seed):
    g = np.random.default_rng(seed)
    kw = {"high_queue": 8.0, "low_queue": 1.0, "high_shed_rate": 1.0, "low_shed_rate": 0.0,
          "up_polls": int(g.integers(1, 4)), "down_polls": int(g.integers(1, 6)),
          "cooldown_s": float(g.choice([0.0, 3.0, 10.0])), "min_replicas": 1,
          "max_replicas": int(g.integers(2, 5))}
    pols = [autoscaler.AutoscalerPolicy(**kw), jax_autoscaler.AutoscalerPolicy(**kw)]
    counts, trace = [1, 1], [[], []]
    for step in range(120):
        sig = {"queue_depth": float(g.choice([0.0, 0.5, 4.0, 9.0, 30.0])),
               "shed_rate": float(g.choice([0.0, 0.0, 0.5, 2.0])),
               "breaker_open": bool(g.random() < 0.05)}
        for i, p in enumerate(pols):
            action, reason = p.decide(sig, counts[i], float(step))
            counts[i] += {"up": 1, "down": -1}.get(action, 0)
            trace[i].append((action, reason, counts[i]))
    assert trace[0] == trace[1]
    assert any(a == "up" for a, _, _ in trace[0])
    for bad in ({"high_queue": 1.0, "low_queue": 2.0}, {"min_replicas": 5, "max_replicas": 2}):
        with pytest.raises(ValueError):
            autoscaler.AutoscalerPolicy(**bad)


@pytest.mark.parametrize("spec", [
    "lag@dir=work,secs=2;skew@host=1,offset=45;eio@p=0.05,seed=7",
    "stale@dir=rep*,window=1.5;torn@path=*.json", "eio@p=1", " ; lag@dir=a,secs=0",
    "lag@dir=work", "nope@x=1", "eio@p=2", "lag@dir=,secs=1", "lag@secs", "skew@host=1,offset=x"])
def test_fsfault_grammar_equals_jax(spec):
    def parse(mod):
        try:
            return mod.parse_fsfault_spec(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(fsfault) == parse(jax_fsfault)


def test_fsfault_reads_equal_jax_under_torn_and_eio(tmp_path):
    """The same seeded plan makes both seams tear the same first read and
    fail the same listings."""
    d = tmp_path / "ports"
    d.mkdir()
    for i in range(4):
        (d / f"r{i}.json").write_text(json.dumps({"tag": f"r{i}", "host": "h", "port": i}))
    results = []
    for mod in (fsfault, jax_fsfault):
        os.environ["FAA_FSFAULT"] = "torn@path=r1.json;eio@p=0.5,seed=3"
        mod.reset()
        seen = []
        for _ in range(6):
            try:
                seen.append(sorted(mod.listdir(str(d))))
            except OSError as e:
                seen.append(("OSError", e.errno))
            seen.append(mod.read_json(str(d / "r1.json")))
        results.append(seen)
        os.environ.pop("FAA_FSFAULT")
        mod.reset()
    assert results[0] == results[1]
    assert ("OSError", errno.EIO) in results[0] or None in results[0]


def test_cli_parsers_equal_jax():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in parser._actions if a.dest != "help"}

    assert flags(router_cli.build_parser()) == flags(jax_router_cli.build_parser())
    assert flags(autoscaler.build_parser()) == flags(jax_autoscaler.build_parser())
    fleet = autoscaler.LocalReplicaFleet(["--policy", "p.json"], "/tmp/x")
    assert fleet.replica_cmd[1:] == ["-m", "fast_autoaugment_tpu_torch.serve.serve_cli",
                                     "--policy", "p.json"]
    assert autoscaler.LocalReplicaFleet(["python", "x.py"], "/tmp/x").replica_cmd == \
        ["python", "x.py"]


# ---------------------------------------------------- routing vs stub replicas


class StubReplica:
    """A controllable upstream: its /readyz verdict and /augment answer are
    set by the test, and every routed request is recorded."""

    def __init__(self):
        self.ready = True
        self.status, self.headers, self.body = 200, {}, b"ok"
        self.requests: list[dict] = []
        self._lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _answer(self, code, body, headers=None):
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/readyz":
                    self._answer(200 if stub.ready else 503, b"{}")
                else:
                    self._answer(404, b"{}")

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", "0") or 0))
                with stub._lock:
                    stub.requests.append({"path": self.path, "body": body,
                                          "digest": self.headers.get("X-FAA-Policy-Digest"),
                                          "deadline": self.headers.get("X-FAA-Deadline-Ms")})
                    answer = (stub.status, stub.body + b"|" + body, dict(stub.headers))
                self._answer(answer[0], answer[1], answer[2])

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.port = self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


@pytest.fixture()
def stubs():
    reps = [StubReplica() for _ in range(3)]
    yield reps
    for r in reps:
        r.close()


def _static(reps):
    return [{"tag": f"r{i}", "host": "127.0.0.1", "port": r.port} for i, r in enumerate(reps)]


#: the scenarios' clock, frozen for the router module under test: a
#: Retry-After window (7 s, 1 s) opened in a scenario stays open to its end
#: however slowly a loaded host runs it, as it does on an idle one
SCENARIO_NOW = 1000.0
#: the scenarios' readyz timeout, passed to both routers: a stub's answer
#: is never turned into a transport failure by a loaded host
SCENARIO_READYZ_TIMEOUT_S = 30.0


def _scenario(mod, stubs, fault: str | None = None) -> list:
    """One routing scenario through `mod`'s Router: affinity, failover on
    a 503 with Retry-After and on a dead replica, ejection and readmission,
    digest-less round robin, and an optional FAA_FAULT drill.  The router
    module's clock is frozen at :data:`SCENARIO_NOW` for the scenario, so
    its log depends on the scenario alone, not on the host's speed."""
    rmod, fmod = mod
    for s in stubs:
        s.ready, s.status, s.headers = True, 200, {}
    if fault:
        os.environ["FAA_FAULT"] = fault
    fmod.reset()
    clock = rmod.mono
    rmod.mono = lambda: SCENARIO_NOW
    try:
        return _scenario_log(rmod, fmod, stubs)
    finally:
        rmod.mono = clock


def _scenario_log(rmod, fmod, stubs) -> list:
    r = rmod.Router(static_replicas=_static(stubs), eject_after=1, readmit_after=1,
                    failover_attempts=2, readyz_timeout_s=SCENARIO_READYZ_TIMEOUT_S,
                    name=f"rt{next(_SEQ)}")
    log = []

    def fwd(digest, body=b"x"):
        status, _, data, tag = r.forward("POST", "/augment", body,
                                         {"Content-Length": str(len(body)),
                                          "X-FAA-Deadline-Ms": "500"}, digest)
        log.append((status, tag, data))

    try:
        r.poll_once()
        log.append(sorted(r.stats()["in_rotation"]))
        for d in ("aa11", "bb22", "cc33", "aa11"):
            fwd(d)
        primary = router.rendezvous_order("dd44", ["r0", "r1", "r2"])[0]
        stubs[int(primary[1])].status = 503
        stubs[int(primary[1])].headers = {"Retry-After": "7"}
        fwd("dd44")
        fwd("dd44")  # the primary is backing off: straight to the next
        stubs[int(primary[1])].status, stubs[int(primary[1])].headers = 200, {}
        stubs[0].ready = False
        r.poll_once()
        log.append(sorted(r.stats()["in_rotation"]))
        for d in ("aa11", "bb22", None, None, None):
            fwd(d)
        stubs[0].ready = True
        for _ in range(3):
            r.poll_once()
        log.append(sorted(r.stats()["in_rotation"]))
        for s in stubs:
            s.status, s.headers = 503, {"Retry-After": "1"}
        fwd("ee55")
        for s in stubs:
            s.status, s.headers = 200, {}
        st = r.stats()
        log.append({k: st[k] for k in ("outcomes", "failovers", "affinity", "requests_routed")})
        log.append({t: {k: v for k, v in rep.items() if k != "backing_off"}
                    for t, rep in st["replicas"].items()})
    finally:
        r.stop()
        os.environ.pop("FAA_FAULT", None)
        fmod.reset()
    return log


def test_router_failover_and_rotation_equal_jax(stubs):
    port = _scenario(PAIRS[0], stubs)
    for s in stubs:
        s.requests.clear()
    assert port == _scenario(PAIRS[1], stubs)
    assert port[0] == ["r0", "r1", "r2"] and port[7] == ["r1", "r2"]
    statuses = [e[0] for e in port if isinstance(e, tuple)]
    assert statuses.count(503) == 1 and all(s in (200, 503) for s in statuses)


@pytest.mark.parametrize("fault", ["replica_down@request=2", "readyz_flap@period=2"])
def test_router_fault_drills_equal_jax(stubs, fault):
    assert _scenario(PAIRS[0], stubs, fault) == _scenario(PAIRS[1], stubs, fault)


def test_router_cli_handler_forwards_and_reports(stubs, tmp_path):
    """``router_cli``'s handler in front of the stubs, replicas discovered
    from a port dir: /augment passes through with its headers, /readyz,
    /stats and /metrics answer, and a batched window falls back per part
    against replicas that answer no frames."""
    d = tmp_path / "ports"
    d.mkdir()
    for i, s in enumerate(stubs):
        (d / f"r{i}.json").write_text(json.dumps({"tag": f"r{i}", "host": "127.0.0.1",
                                                  "port": s.port, "pid": 1}))
    r = router.Router(port_dir=str(d), eject_after=1, readmit_after=1,
                      batch_window_ms=20, name=f"rt{next(_SEQ)}").start()
    httpd = router_cli._RouterHTTPServer(("127.0.0.1", 0), router_cli.make_router_handler(r))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    port = httpd.server_address[1]
    try:
        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as f:
                return f.status, f.read()

        assert json.loads(get("/readyz")[1]) == {"ready": True, "in_rotation": 3}
        answers = [None] * 4

        def post(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/augment", data=b"body%d" % i,
                headers={"Content-Type": "application/x-faa-raw",
                         "X-FAA-Policy-Digest": "abcabcabcabc"})
            with urllib.request.urlopen(req, timeout=30) as f:
                answers[i] = (f.status, f.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert [a[0] for a in answers] == [200] * 4
        assert sorted(a[1] for a in answers) == sorted(b"ok|body%d" % i for i in range(4))
        seen = [q for s in stubs for q in s.requests if q["path"] == "/augment"]
        assert {q["digest"] for q in seen} == {"abcabcabcabc"} and len(seen) == 4
        st = json.loads(get("/stats")[1])
        assert st["batch_forwarding"]["entries"] == 4 and st["outcomes"]["ok"] == 4
        assert b"faa_router_requests_total" in get("/metrics")[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        r.stop()
        t.join(timeout=10)


def test_scraper_reads_the_port_replica_like_jax(tmp_path):
    """Both packages' scrapers over the port's own serve_cli handler (a CPU
    PolicyServer in this process) read the same signal."""
    from fast_autoaugment_tpu_torch.serve import policy_server, serve_cli

    ap = policy_server.PolicyApplier(np.float32([[[4, 0.9, 0.6]]]), image=4, shapes=(2,),
                                     device="cpu")
    srv = policy_server.PolicyServer(ap, queue_depth=1)
    httpd = serve_cli._ServeHTTPServer(("127.0.0.1", 0), serve_cli.make_handler(srv))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    d = tmp_path / "ports"
    d.mkdir()
    (d / "r0.json").write_text(json.dumps({"tag": "r0", "host": "127.0.0.1",
                                           "port": httpd.server_address[1], "pid": 1}))
    try:
        srv.submit(np.zeros((1, 4, 4, 3), np.float32), np.zeros((1, 2), np.uint32))
        with pytest.raises(policy_server.ServerOverloadedError):
            srv.submit(np.zeros((1, 4, 4, 3), np.float32), np.zeros((1, 2), np.uint32))
        sigs = [mod.ReplicaScraper(str(d)).scrape() for mod in (autoscaler, jax_autoscaler)]
        assert sigs[0] == sigs[1]
        assert sigs[0]["queue_depth"] >= 1.0 and sigs[0]["reachable"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        srv.stop()
