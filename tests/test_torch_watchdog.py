"""The port's StallWatchdog: the scenarios of tests/test_watchdog.py —
deadline math, breach detection, escalation, health, the threaded poller
and the flight record — on an injected clock, with the port's counters,
tracer and goodput ledger; and the same breaches as the JAX package's
watchdog on the same beats."""

import json
import os
import threading
import time

import pytest

from edl_tpu.runtime.watchdog import StallWatchdog as JaxWatchdog
from edl_tpu_torch.observability import goodput
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.tracing import get_tracer
from edl_tpu_torch.runtime.watchdog import Stall, StallWatchdog


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make_wd(clock, cls=StallWatchdog, **kw):
    kw.setdefault("floor_s", 1.0)
    kw.setdefault("k", 4.0)
    kw.setdefault("warmup", 3)
    kw.setdefault("alpha", 0.5)
    return cls(clock=clock, **kw)


def test_floor_rules_before_any_ewma_sample():
    clock = FakeClock()
    wd = make_wd(clock, floor_s=2.5)
    assert wd.deadline_s() == 2.5
    wd.beat(0)
    assert wd.deadline_s() == 2.5


def test_detection_arms_at_first_beat_not_after_warmup():
    clock = FakeClock()
    wd = make_wd(clock, floor_s=1.0, warmup=3)
    clock.advance(100.0)
    assert wd.check() is None  # pre-beat silence is not a stall
    wd.beat(0)
    assert not wd.armed()
    clock.advance(2.0)
    stall = wd.check()
    assert stall is not None and stall.step == 0
    assert stall.deadline_s == pytest.approx(1.0)


def test_slow_first_interval_raises_deadline_before_warmup():
    clock = FakeClock()
    wd = make_wd(clock, floor_s=1.0, k=4.0, warmup=3, alpha=0.5)
    wd.beat(0)
    clock.advance(5.0)
    wd.beat(1)
    assert not wd.armed()
    assert wd.deadline_s() == pytest.approx(20.0)
    clock.advance(10.0)
    assert wd.check() is None


def test_floor_clamps_fast_steps():
    clock = FakeClock()
    wd = make_wd(clock, floor_s=1.0, k=4.0)
    for s in range(5):
        clock.advance(0.001)
        wd.beat(s)
    assert wd.ewma_s() == pytest.approx(0.001)
    assert wd.deadline_s() == 1.0


def test_deadline_grows_after_legitimately_slow_step():
    clock = FakeClock()
    wd = make_wd(clock, floor_s=0.1, k=4.0, alpha=0.5)
    for s in range(4):
        clock.advance(0.2)
        wd.beat(s)
    d_fast = wd.deadline_s()
    assert d_fast == pytest.approx(4.0 * 0.2)
    clock.advance(5.0)
    wd.beat(4)
    assert wd.deadline_s() > d_fast
    assert wd.ewma_s() == pytest.approx(0.5 * 5.0 + 0.5 * 0.2)


def test_breach_fires_once_counts_and_escalates():
    clock = FakeClock()
    stalls: list[Stall] = []
    wd = make_wd(clock, floor_s=1.0, on_stall=stalls.append,
                 scope="unit-test")
    before = get_counters().get("stalls_detected", scope="unit-test")
    for s in range(4):
        clock.advance(0.1)
        wd.beat(s)
    assert wd.healthy()
    clock.advance(0.5)
    assert wd.check() is None
    clock.advance(0.6)
    stall = wd.check()
    assert stall is not None and stall.step == 3
    assert stall.silent_s == pytest.approx(1.1)
    assert stall.deadline_s == pytest.approx(1.0)
    assert stall.silent_s <= 2 * stall.deadline_s
    assert stalls == [stall] and not wd.healthy()
    clock.advance(5.0)
    assert wd.check() is None  # one stall = one escalation
    assert wd.stalls_detected == 1
    assert get_counters().get("stalls_detected",
                              scope="unit-test") == before + 1
    assert "stall_detected" in {e.name for e in get_tracer().events()
                                if e.category == "chaos"}
    wd.beat(4)
    assert wd.healthy()
    clock.advance(50.0)
    assert wd.check() is not None
    assert wd.stalls_detected == 2


def test_escalation_failure_does_not_kill_the_poller():
    clock = FakeClock()

    def bad_escalation(stall):
        raise RuntimeError("boom")

    wd = make_wd(clock, floor_s=0.5, on_stall=bad_escalation)
    for s in range(3):
        clock.advance(0.01)
        wd.beat(s)
    clock.advance(1.0)
    assert wd.check() is not None
    assert not wd.healthy()


def test_healthy_wires_into_serve_health():
    """The verdict is a liveness check: served through the JAX package's
    health endpoint (the port has none yet), a stall turns it 503."""
    import urllib.request

    from edl_tpu.observability.health import serve_health

    clock = FakeClock()
    wd = make_wd(clock, floor_s=0.5)
    srv = serve_health(0, {"trainer_progress": wd.healthy},
                       host="127.0.0.1")
    try:
        port = srv.server_address[1]

        def probe():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        for s in range(3):
            clock.advance(0.01)
            wd.beat(s)
        code, body = probe()
        assert code == 200 and body["trainer_progress"] is True
        clock.advance(2.0)
        wd.check()
        code, body = probe()
        assert code == 503 and body["trainer_progress"] is False
    finally:
        srv.shutdown()


def test_threaded_mode_detects_real_hang():
    caught = threading.Event()
    wd = StallWatchdog(floor_s=0.3, k=4.0, warmup=2, alpha=0.5,
                       on_stall=lambda s: caught.set(), scope="thread-test")
    wd.start(poll_s=0.05)
    try:
        for s in range(4):
            wd.beat(s)
            time.sleep(0.02)
        assert caught.wait(timeout=3.0)
        assert not wd.healthy()
    finally:
        wd.stop()


def test_constructor_validation():
    with pytest.raises(ValueError):
        StallWatchdog(floor_s=0.0)
    with pytest.raises(ValueError):
        StallWatchdog(alpha=0.0)


def test_flight_record_dumped_on_injected_stall(tmp_path):
    get_tracer().instant("pre_stall_marker", category="chaos", step=5)
    get_counters().inc("flight_probe")
    clock = FakeClock()
    wd = make_wd(clock, floor_s=1.0, scope="flight-test",
                 flight_dir=str(tmp_path))
    wd.beat(5)
    clock.advance(10.0)
    assert wd.check() is not None

    def records():
        return [f for f in os.listdir(tmp_path) if f.startswith("flightrec-")]

    assert len(records()) == 1
    doc = json.loads((tmp_path / records()[0]).read_text())
    assert doc["reason"] == "stall-flight-test"
    assert doc["extra"]["step"] == 5 and doc["extra"]["silent_s"] >= 1.0
    assert doc["counters"].get("flight_probe", 0) >= 1
    assert "edl_flight_probe_total" in doc["metrics_text"]
    assert any(e["name"] == "pre_stall_marker" for e in doc["trace_events"])
    clock.advance(5.0)
    assert wd.check() is None
    assert len(records()) == 1
    wd.beat(6)
    clock.advance(100.0)
    assert wd.check() is not None
    assert len(records()) == 2


def test_flight_record_disabled_by_default_env(monkeypatch):
    monkeypatch.delenv("EDL_FLIGHTREC_DIR", raising=False)
    clock = FakeClock()
    wd = make_wd(clock, floor_s=1.0)
    assert wd.flight_dir == ""
    wd.beat()
    clock.advance(5.0)
    assert wd.check() is not None


def test_stall_window_lands_in_the_goodput_ledger():
    """A breach moves the silence already spent into ``stall`` and accrues
    there until the next beat closes the window."""
    clock = FakeClock()
    ledger = goodput.set_process_ledger(goodput.GoodputLedger(
        "t/stall", world_size=2, base_phase=goodput.PRODUCTIVE,
        clock=clock))
    try:
        wd = make_wd(clock, floor_s=1.0)
        wd.beat(0)
        clock.advance(3.0)
        assert wd.check() is not None
        assert ledger.chip_seconds(goodput.STALL) == pytest.approx(6.0)
        clock.advance(2.0)
        wd.beat(1)  # closes the stall window
        clock.advance(1.0)
        assert ledger.chip_seconds(goodput.STALL) == pytest.approx(10.0)
        assert ledger.chip_seconds(goodput.PRODUCTIVE) == pytest.approx(2.0)
        assert ledger.conserves()
    finally:
        goodput.set_process_ledger(None)


def test_breaches_equal_the_reference_watchdog_on_the_same_beats():
    beats = [0.1, 0.1, 0.3, 5.0, 0.2, 0.2]
    silences = [0.5, 2.0, 30.0]
    got = []
    for cls in (StallWatchdog, JaxWatchdog):
        clock = FakeClock()
        wd = make_wd(clock, cls=cls, floor_s=1.0, scope="parity")
        seen = []
        for s, dt in enumerate(beats):
            clock.advance(dt)
            wd.beat(s)
            seen.append(wd.deadline_s())
        for dt in silences:
            clock.advance(dt)
            stall = wd.check()
            seen.append(None if stall is None else
                        (stall.step, stall.silent_s, stall.deadline_s))
        got.append(seen)
    assert got[0] == got[1]
