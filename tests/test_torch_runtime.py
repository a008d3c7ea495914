"""The port's runtime seams against the JAX package's, on the CPU: the
telemetry registry and journal (``core/telemetry.py``), the ``FAA_FAULT``
grammar (``utils/faultinject.py``), the dispatch watchdog
(``core/watchdog.py``), the circuit breaker (``core/resilience.py``), the
compile seam (``core/compilecache.py``), the graph census
(``search/census.py``), the stopwatch (``utils/profiling.py``), and the CLIs'
runtime flags.

Bounds: the Prometheus text and the registry snapshot are byte-equal for
the same metric operations; journal records are field-equal once the two
clock fields (``t_wall``, ``t_mono``) are dropped; fault plans parse equal
(and the same malformed specs raise); watchdog deadlines, fire counts and
breaker transitions are equal under one injected clock (the EMAs fed the
same observations, ``time.monotonic`` replaced for the breakers).  Every
test runs in this process: the JAX modules here import no jax at module
level, or only for the watchdog's wait.
"""

import json
import logging
import os
import time

import pytest
import torch

from fast_autoaugment_tpu.core import resilience as JR
from fast_autoaugment_tpu.core import telemetry as JT
from fast_autoaugment_tpu.core import watchdog as JW
from fast_autoaugment_tpu.utils import faultinject as JF
from fast_autoaugment_tpu.utils import profiling as JP
from fast_autoaugment_tpu_torch.core import compilecache as CC
from fast_autoaugment_tpu_torch.core import resilience as R
from fast_autoaugment_tpu_torch.core import telemetry as T
from fast_autoaugment_tpu_torch.core import watchdog as W
from fast_autoaugment_tpu_torch.launch import search_cli as SC
from fast_autoaugment_tpu_torch.launch import train_cli as TC
from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.search import census
from fast_autoaugment_tpu_torch.utils import faultinject as F
from fast_autoaugment_tpu_torch.utils import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "confs", "wresnet10x1_shapes.yaml")


def _metric_ops(reg):
    c = reg.counter("faa_dispatches_total", "device dispatches through the span seam",
                    label="tta")
    c.inc()
    c.inc(2.5)
    reg.counter("faa_dispatches_total", "device dispatches through the span seam",
                label="audit").inc()
    g = reg.gauge("faa_breaker_open", "1 while OPEN", breaker='a"b\\c')
    g.set(1.0)
    g.inc(0.25)
    h = reg.histogram("faa_dispatch_seconds", "per-dispatch wall seconds", label="tta")
    for v in (0.0005, 0.003, 0.003, 0.2, 7.0, 400.0):
        h.observe(v)
    reg.histogram("faa_step_seconds", "steps", buckets=(0.1, 1.0), timer="x").observe(0.5)
    with pytest.raises(ValueError):
        reg.histogram("faa_dispatch_seconds", "again", buckets=(1.0,), label="tta")
    with pytest.raises(ValueError):
        reg.gauge("faa_dispatches_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        reg.counter("bad name")


def test_registry_text_and_snapshot_equal_jax():
    mine, theirs = T.MetricsRegistry(), JT.MetricsRegistry()
    _metric_ops(mine)
    _metric_ops(theirs)
    assert mine.prometheus_text() == theirs.prometheus_text()
    assert json.dumps(mine.snapshot(), sort_keys=True) == \
        json.dumps(theirs.snapshot(), sort_keys=True)
    assert mine.counters_snapshot() == theirs.counters_snapshot()
    mine._reset_for_tests()
    theirs._reset_for_tests()
    assert mine.prometheus_text() == theirs.prometheus_text()


def _journal_events(mod, directory, **kw):
    rec = mod.FlightRecorder(str(directory), host="hostA", attempt=3, **kw)
    rec.emit("dispatch", "tta", t_mono_start=1.0, t_mono_end=2.5, dur_sec=1.5, blocking=True)
    rec.emit("trial", "fold0", fold=0, trial=3, reward=0.25, quarantined=False)
    rec.emit("mark", None)
    rec.emit("checkpoint", "m.msgpack", action="save", nbytes=12, epoch=None)
    rec.emit("phase", "phase1-fold0", t_mono_start=0.0, t_mono_end=1.0, extra={"a": [1, 2]})
    with pytest.raises(ValueError):
        rec.emit("no_such_type", "x")
    with pytest.raises(ValueError):
        rec.emit("mark", "x", seq=3)
    rec.close()
    out = []
    for seg in sorted(os.listdir(directory)):
        if seg.endswith(".jsonl"):
            with open(os.path.join(directory, seg)) as fh:
                out += [json.loads(ln) for ln in fh]
    return out


def test_journal_records_equal_jax(tmp_path):
    mine = _journal_events(T, tmp_path / "port")
    theirs = _journal_events(JT, tmp_path / "jax")
    assert len(mine) == len(theirs) == 5
    for a, b in zip(mine, theirs):
        for rec in (a, b):
            assert rec.pop("t_wall") > 0 and rec.pop("t_mono") > 0
        assert a == b
    # the file names carry the same identity; both journals have their TB
    # bridge's directory beside the segments
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert "tb" in os.listdir(tmp_path / "port")


def test_journal_rotation_and_dispatch_budget(tmp_path):
    rec = T.FlightRecorder(str(tmp_path), host="h", attempt=1, max_segment_bytes=300,
                           max_segments=2, dispatch_events_per_sec=3)
    for i in range(20):
        rec.emit("mark", "x", i=i)
    assert len(rec.segments) == 2
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".jsonl")]) == 2
    assert [rec.allow_dispatch_event("tta") for _ in range(5)] == [True] * 3 + [False] * 2
    rec.close()


def test_span_seam_and_env_handoff(tmp_path, monkeypatch):
    monkeypatch.delenv(T.ENV_VAR, raising=False)
    assert T.resolve_telemetry("off") is None and T.configure_telemetry(None) is None
    monkeypatch.setenv(T.ENV_VAR, str(tmp_path / "env"))
    assert T.resolve_telemetry("off") == str(tmp_path / "env")
    monkeypatch.delenv(T.ENV_VAR)
    before = T.registry().counter("faa_dispatches_total", label="probe_label").value
    try:
        d = T.configure_telemetry(str(tmp_path / "j"))
        assert T.journal_active() and T.telemetry_dir() == d and os.environ[T.ENV_VAR] == d
        windows = []
        with T.span("probe_label", trace=lambda a, b: windows.append((a, b)), step=4):
            pass
        T.phase_event("probe_phase", 1.0, 3.0, fold=1)
        T.journal_flush()
        recs = [json.loads(ln) for n in sorted(os.listdir(d)) if n.endswith(".jsonl")
                for ln in open(os.path.join(d, n))]
    finally:
        T._disable_for_tests()
    assert len(windows) == 1 and windows[0][1] >= windows[0][0]
    assert T.registry().counter("faa_dispatches_total", label="probe_label").value == before + 1
    kinds = [(r["type"], r["label"]) for r in recs]
    assert ("dispatch", "probe_label") in kinds and ("phase", "probe_phase") in kinds
    assert not T.journal_active() and T.ENV_VAR not in os.environ


def test_metrics_server_answers(tmp_path):
    import urllib.request

    T.registry().counter("faa_probe_total", "probe").inc()
    httpd, port = T.start_metrics_server(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            text = r.read().decode()
            assert r.headers["Content-Type"] == T.PROMETHEUS_CONTENT_TYPE
        assert "# TYPE faa_probe_total counter" in text
        assert any(ln.startswith("faa_probe_total ") for ln in text.splitlines())
    finally:
        httpd.shutdown()


SPECS = ["nan_loss@step=7;sigterm@step=12;torn_ckpt@save=3;io_error@p=0.1,seed=0",
         "hang@step=5,attempt=2; slow@step=3,factor=2.5", "sigkill_trial@trial=4",
         "trial_error@trial=1;corrupt_ckpt@save=2;sigusr1@step=1;sigkill@step=9",
         "stale_lease@unit=p1-fold0;serve_error@dispatch=2;serve_slow@dispatch=1,factor=3",
         "replica_down@request=5;readyz_flap@period=2;drift@dispatch=4,shift=-20", ""]
BAD = ["nope@step=1", "nan_loss", "nan_loss@steps=1", "slow@step=1", "io_error@p=2",
       "stale_lease@unit=", "nan_loss@step=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plans_parse_equal_jax(spec):
    assert F.parse_fault_spec(spec) == JF.parse_fault_spec(spec)


@pytest.mark.parametrize("spec", BAD)
def test_fault_plans_refuse_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        JF.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        F.parse_fault_spec(spec)


def test_fault_plan_triggers_fire_once(monkeypatch):
    monkeypatch.setenv("FAA_FAULT", "nan_loss@step=5;torn_ckpt@save=2;hang@step=3;"
                                    "slow@step=4,factor=2;trial_error@trial=1")
    F.reset()
    try:
        plan = F.active_plan()
        assert plan is F.active_plan()  # cached while the value holds
        assert not plan.nan_loss_in(0, 5) and plan.nan_loss_in(4, 8) and not plan.nan_loss_in(4, 8)
        assert [plan.torn_at(plan.next_save()) for _ in range(3)] == [False, True, False]
        assert plan.dispatch_delay(2) is None
        assert plan.dispatch_delay(3) == ("hang", float("inf"))
        assert plan.dispatch_delay(9) == ("slow", 2.0) and plan.dispatch_delay(9) is None
        assert plan.trial_error_at(1) and not plan.trial_error_at(1)
        monkeypatch.setenv("FAA_ATTEMPT", "2")
        monkeypatch.setenv("FAA_FAULT", "hang@step=1,attempt=1")
        assert F.active_plan().dispatch_delay(5) is None  # gated to attempt 1
    finally:
        monkeypatch.delenv("FAA_FAULT")
        F.reset()
    assert F.active_plan() is None


def _deadlines(mod, mode, warm=False):
    wd = mod.DispatchWatchdog(mode, compile_allowance=600.0, warm_allowance=60.0,
                              hang_factor=20.0, min_deadline=10.0)
    if warm:
        wd.mark_compile_warm("b")
    out = [wd.deadline("a"), wd.deadline("b")]
    for w in (3.0, 0.1, 0.2, 1.7, 0.05):
        wd.observe("a", w)
        out.append((wd.deadline("a"), round(wd.ema("a"), 12)))
    wd.observe("b", 0.9)
    out.append(wd.deadline("b"))
    return out, wd.stats()


@pytest.mark.parametrize("mode", ["off", "auto", 2.5, "7"])
def test_watchdog_deadlines_equal_jax(mode):
    for warm in (False, True):
        (mine, s_mine), (theirs, s_theirs) = _deadlines(W, mode, warm), _deadlines(JW, mode, warm)
        assert mine == theirs
        assert s_mine == s_theirs
    for bad in (0, -1.0, "-2"):
        for mod in (W, JW):
            with pytest.raises(ValueError):
                mod.DispatchWatchdog(bad)


def test_watchdog_fire_decisions_equal_jax():
    """The same dispatches through both watchdogs: a fast one completes, an
    injected hang fires after the fixed deadline, an error passes through."""
    out = {}
    for name, mod, hung in (("port", W, R.DispatchHungError), ("jax", JW, JR.DispatchHungError)):
        wd = mod.DispatchWatchdog(0.3, compile_allowance=0.3)
        got = [wd.run("d", lambda x: x + 1, 1)]
        t0 = time.monotonic()
        with pytest.raises(hung) as e:
            wd.run("d", lambda: None, inject_delay=float("inf"))
        got.append((e.value.label, e.value.deadline_sec, time.monotonic() - t0 < 5))
        with pytest.raises(ZeroDivisionError):
            wd.run("d", lambda: 1 / 0)
        st = wd.stats()
        got.append((st["mode"], st["fires"], st["deadline_sec"], wd.fires))
        off = mod.DispatchWatchdog("off")
        got.append((off.enabled, off.run("e", lambda: 5), off.fires))
        out[name] = got
    assert out["port"] == out["jax"]
    assert out["port"][1][0] == "d" and out["port"][2][1] == 1


def test_watchdog_waits_on_the_callers_stream_and_serializer():
    """The port's run on the CPU returns the call's value; the serializer
    is a no-op until armed and one lock when armed."""
    wd = W.resolve_watchdog("auto")
    assert W.resolve_watchdog(wd) is wd and W.resolve_watchdog(None).mode == "off"
    t = torch.arange(4.0)
    assert torch.equal(wd.run("cpu", torch.add, t, 1), t + 1)
    assert type(W.dispatch_enqueue_guard()).__name__ == "nullcontext"
    W.arm_dispatch_serializer(True)
    try:
        with W.dispatch_enqueue_guard():
            with W.dispatch_enqueue_guard():  # reentrant
                pass
    finally:
        W.arm_dispatch_serializer(False)


def _breaker_trace(mod, clock):
    b = mod.CircuitBreaker(threshold=2, cooldown_s=5.0, name="probe")
    out = []
    for op in ["allow", "fail", "allow", "fail", "allow", "open?", "tick6", "allow", "allow",
               "fail", "open?", "tick6", "allow", "ok", "allow", "open?"]:
        if op == "allow":
            out.append(b.allow())
        elif op == "fail":
            b.record_failure()
        elif op == "ok":
            b.record_success()
        elif op == "open?":
            out.append(b.is_open())
        else:
            clock[0] += 6.0
        snap = b.snapshot()
        out.append((snap["state"], snap["fires"], snap["consecutive_failures"],
                    snap["retry_after_s"]))
    disabled = mod.CircuitBreaker(threshold=0)
    disabled.record_failure()
    out.append((disabled.allow(), disabled.is_open(), disabled.snapshot()))
    return out


def test_circuit_breaker_transitions_equal_jax(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    mine = _breaker_trace(R, clock)
    clock[0] = 100.0
    theirs = _breaker_trace(JR, clock)
    assert mine == theirs
    assert R.PREEMPTED_EXIT_CODE == JR.PREEMPTED_EXIT_CODE == 77
    assert R.PreemptedError.exit_code == R.DispatchHungError.exit_code == 77


def test_preemption_flag():
    R.clear_preemption()
    assert not R.preemption_requested()
    R.request_preemption()
    assert R.preemption_requested()
    R.clear_preemption()
    assert R.install_signal_handlers() and R.install_signal_handlers()  # idempotent


def test_compile_cache_seam(tmp_path, monkeypatch):
    """``off`` keeps the package's build directory; a directory moves the
    libraries' build there (exported to children); hits and misses are
    counted per library and make the process warm; first calls are timed
    through the seam; the stats carry the JAX stamp's keys."""
    monkeypatch.delenv(CC.ENV_VAR, raising=False)
    CC._reset_stats_for_tests()
    try:
        assert CC.configure_compile_cache("off") is None
        assert _kernels.BUILD_DIR == _kernels.DEFAULT_BUILD_DIR
        CC.record_libraries([], ["augment"], 0.5)  # cache off: uncached, not counted
        d = CC.configure_compile_cache(str(tmp_path / "cc"))
        assert str(_kernels.BUILD_DIR) == d == os.environ[CC.ENV_VAR]
        assert _kernels._library_path("augment").parent == tmp_path / "cc"
        assert CC.resolve_compile_cache("off") == d  # the env handoff
        assert not CC.process_is_warm()
        CC.record_libraries(["augment", "imagenet", "preprocess"], [], 0.01)
        assert CC.process_is_warm()
        with CC.timed_first("probe"):
            pass
        with CC.timed_first("probe2"):
            CC.record_libraries([], ["augment"], 2.0)
        assert not CC.process_is_warm()
        stats = CC.compile_cache_stats()
    finally:
        CC._disable_for_tests()
        CC._reset_stats_for_tests()
    import fast_autoaugment_tpu.core.compilecache as JCC

    assert set(stats) == set(JCC.compile_cache_stats())
    assert stats["hits"] == 3 and stats["misses"] == 1 and stats["enabled"]
    assert stats["labels"]["kernels"]["uncached"] == 1 and stats["labels"]["kernels"]["hit"] == 1
    assert stats["labels"]["probe"]["none"] == 1 and stats["labels"]["probe2"]["miss"] == 1
    assert _kernels.BUILD_DIR == _kernels.DEFAULT_BUILD_DIR and CC.ENV_VAR not in os.environ
    # the watchdog shrinks its first-call allowance in a warm process
    CC._dir = str(tmp_path)
    CC.record_libraries(["augment"], [], 0.0)
    try:
        assert W.DispatchWatchdog("auto").deadline("x") == W.DEFAULT_WARM_ALLOWANCE_SEC
    finally:
        CC._disable_for_tests()
        CC._reset_stats_for_tests()
    assert W.DispatchWatchdog("auto").deadline("x") == W.DEFAULT_COMPILE_ALLOWANCE_SEC


def test_graph_census():
    from fast_autoaugment_tpu_torch.models import get_model
    from fast_autoaugment_tpu_torch.search import tta

    step = tta.make_tta_step(get_model({"type": "wresnet10_1"}, 10, device="cpu"))
    assert census.executable_census(step) == 0  # on the CPU the step holds no graph
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logging.getLogger("faa_torch.census").addHandler(handler)
    try:
        assert census.executable_census(object()) is None
    finally:
        logging.getLogger("faa_torch.census").removeHandler(handler)
    assert any("UNAVAILABLE" in m for m in seen)


def test_phase_stopwatch_and_step_timer_match_jax():
    mine = P.PhaseStopwatch(device_count=2, registry=T.MetricsRegistry())
    theirs = JP.PhaseStopwatch(device_count=2, registry=JT.MetricsRegistry())
    for sw in (mine, theirs):
        with sw.phase("a"):
            pass
        sw.start("b")
        sw.stop("b")
        sw.stop("never")
        sw.phases = {"a": 10.0, "b": 3600.0}
    assert mine.summary() == theirs.summary()
    assert mine.device_hours("b") == theirs.device_hours("b") == 2.0
    assert P.PhaseStopwatch().summary()["_meta"]["backend"] in ("cpu", "cuda")
    timer = P.StepTimer(warmup=1, name="t", registry=T.MetricsRegistry())
    for _ in range(3):
        timer.start()
        timer.stop(items=4)
    assert timer.steps_timed == 2 and timer.items == 8 and timer.mean_step_seconds >= 0.0


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with P.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    with open(tmp_path / "tr" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)
    with P.trace(None):
        pass


RUNTIME_FLAGS = {"--async-pipeline": "on", "--pipeline-actors": "2",
                 "--pipeline-queue-depth": "0", "--divergence-retries": "1",
                 "--watchdog": "auto", "--compile-cache": "/tmp/cc", "--telemetry": "/tmp/t",
                 "--telemetry-port": "9"}


@pytest.mark.parametrize("flag", sorted(RUNTIME_FLAGS))
def test_clis_take_the_runtime_flags(flag):
    """Every runtime flag of the JAX CLIs parses (``train_cli`` has those of
    the JAX ``train_cli``: not the pipeline's) and is no longer refused."""
    assert flag not in SC.UNPORTED_FLAGS
    args = SC.parse_args(SC.build_parser(), ["-c", CONF, flag, RUNTIME_FLAGS[flag]])
    assert str(getattr(args, flag[2:].replace("-", "_"))) == RUNTIME_FLAGS[flag]
    if "pipeline" not in flag:
        args = SC.parse_args(TC.build_parser(), ["-c", CONF, flag, RUNTIME_FLAGS[flag]])
        assert str(getattr(args, flag[2:].replace("-", "_"))) == RUNTIME_FLAGS[flag]
    if flag == "--watchdog":
        for bad in ("0", "-1", "nan", "soon"):
            with pytest.raises(SystemExit):
                SC.parse_args(SC.build_parser(), ["-c", CONF, flag, bad])


def test_the_runtime_modules_import_nothing_the_card_lacks():
    import subprocess
    import sys

    mods = ["fast_autoaugment_tpu_torch." + m for m in (
        "core.resilience", "core.telemetry", "core.watchdog", "core.compilecache",
        "utils.faultinject", "utils.profiling", "search.census", "search.pipeline",
        "search.tta", "search.driver")]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "roots = {'jax', 'jaxlib', 'flax', 'fast_autoaugment_tpu', 'sklearn', 'yaml',\n"
            "         'msgpack', 'PIL', 'optax'}\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in roots)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
