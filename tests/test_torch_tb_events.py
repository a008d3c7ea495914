"""The port's TensorBoard event writer (``fast_autoaugment_tpu_torch/utils/
tb_events.py``), its ``make_writers(..., tb=...)`` opt-in
(``utils/logging.py``) and the journal's TB bridge (``core/telemetry.py``)
against the JAX package's: event files byte for byte under a frozen wall
clock, known crc32c vectors, the CRC-verified round trip, a CRC mismatch
raising, and two writers born in one second getting files of their own.

Host code only: neither module imports JAX or torch.
"""

from __future__ import annotations

import glob
import os
import time

import pytest

from fast_autoaugment_tpu.utils import tb_events as jax_tb
from fast_autoaugment_tpu_torch.core import telemetry
from fast_autoaugment_tpu_torch.utils.logging import ScalarWriter, TeeWriter, make_writers
from fast_autoaugment_tpu_torch.utils.tb_events import TBEventWriter, crc32c, read_events


def test_crc32c_known_vectors():
    # RFC 3720 / kernel test vectors for CRC-32C (Castagnoli)
    for data, want in ((b"", 0x00000000), (b"123456789", 0xE3069283), (b"a", 0xC1D04330),
                       (bytes(32), 0x8A9136AA)):
        assert crc32c(data) == jax_tb.crc32c(data) == want


@pytest.mark.parametrize("wall", [1_700_000_000.0, 1_700_000_123.456789])
def test_event_files_byte_equal_to_jax(tmp_path, monkeypatch, wall):
    """The same scalars at a frozen wall time: the same file name (time,
    host, pid, name) and the same bytes, and each package reads the
    other's file."""
    monkeypatch.setattr(time, "time", lambda: wall)
    paths = []
    for mod, sub in ((None, "torch"), (jax_tb, "jax")):
        w = (TBEventWriter if mod is None else mod.TBEventWriter)(str(tmp_path / sub), "train")
        for step, (tag, value) in enumerate((("loss", 1.5), ("top1", 0.25), ("lr", 3e-4),
                                             ("loss", -2.75))):
            w.add_scalar(tag, value, step=step * 1000)
        w.close()
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert read_events(paths[1]) == jax_tb.read_events(paths[0])


def test_event_file_round_trip(tmp_path):
    w = TBEventWriter(str(tmp_path), "train")
    w.add_scalar("loss", 1.5, step=1)
    w.add_scalar("top1", 0.25, step=2)
    w.close()
    events = read_events(w.path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert [(e["tag"], round(e["value"], 6), e.get("step")) for e in events[1:]] == \
        [("loss", 1.5, 1), ("top1", 0.25, 2)]
    assert all(e["wall_time"] > 0 for e in events)
    with pytest.raises(ValueError):  # negative steps raise, never clamp
        TBEventWriter(str(tmp_path), "x").add_scalar("a", 1.0, step=-1)


def test_reader_crc_mismatch_raises_value_error(tmp_path):
    w = TBEventWriter(str(tmp_path), "train")
    w.add_scalar("loss", 1.5, step=1)
    w.close()
    data = bytearray(open(w.path, "rb").read())
    data[12] ^= 0xFF  # the first payload byte of the file_version record
    with open(w.path, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(ValueError, match="crc mismatch"):
        read_events(w.path)
    with pytest.raises(ValueError, match="crc mismatch"):
        jax_tb.read_events(w.path)
    assert read_events(w.path, verify_crc=False)


def test_two_writers_same_second_get_distinct_files(tmp_path):
    w1, w2 = TBEventWriter(str(tmp_path), "train"), TBEventWriter(str(tmp_path), "train")
    try:
        assert w1.path != w2.path
        w1.add_scalar("a", 1.0, 0)
        w2.add_scalar("a", 2.0, 0)
    finally:
        w1.close()
        w2.close()
    for p in (w1.path, w2.path):
        assert sum("file_version" in e for e in read_events(p)) == 1


def test_make_writers_tb_opt_in(tmp_path, monkeypatch):
    train, valid, test = make_writers(str(tmp_path), "run", True, tb=True)
    assert isinstance(train, TeeWriter)
    train.add_scalar("loss", 2.0, step=1)
    train.flush()
    assert os.path.exists(os.path.join(tmp_path, "run_train.jsonl"))
    (tb_file,) = glob.glob(os.path.join(tmp_path, "tb", "run_train", "events.out.tfevents.*"))
    events = read_events(tb_file)
    assert events[1]["tag"] == "loss" and events[1]["value"] == 2.0
    for w in (train, valid, test):
        w.close()
    monkeypatch.delenv("FAA_TB_EVENTS", raising=False)
    w2 = make_writers(str(tmp_path / "plain"), "run", True)[0]
    assert isinstance(w2, ScalarWriter)  # the default stays JSONL only
    w2.close()
    monkeypatch.setenv("FAA_TB_EVENTS", "1")
    w3 = make_writers(str(tmp_path / "env"), "run", True)[0]
    assert isinstance(w3, TeeWriter)
    w3.close()


def test_journal_tb_bridge_crc_verified_roundtrip(tmp_path, monkeypatch):
    monkeypatch.delenv("FAA_TELEMETRY", raising=False)
    d = str(tmp_path / "tel")
    telemetry.enable_telemetry(d)
    try:
        telemetry.emit("trial", "fold0", fold=0, trial=5, reward=0.875, step=5)
        telemetry.emit("trial", "fold0", fold=0, trial=6, reward=0.9, step=6)
        telemetry.emit("dispatch", "tta", dur_ms=1.0)  # dispatch windows are skipped
    finally:
        telemetry._disable_for_tests()
    (tb_file,) = glob.glob(os.path.join(d, "tb", "events.out.tfevents.*"))
    scalars = {(e.get("tag"), e.get("step")): e.get("value")
               for e in read_events(tb_file) if "tag" in e}
    assert abs(scalars[("trial/fold0/reward", 5)] - 0.875) < 1e-6
    assert abs(scalars[("trial/fold0/reward", 6)] - 0.9) < 1e-6
    assert not any(tag.startswith("dispatch/") or tag.endswith("/host")
                   for tag, _ in scalars)
