"""The port's ``cli`` verbs over its observability loaders and dashboards:
``trace`` (the cases of tests/test_trace_cli.py:105-140 on
edl_tpu_torch.cli, its output equal to the JAX package's on the same
dumps), and ``fleet`` and ``calib`` scraping a served registry, their
dashboards equal to the reference CLI's on the same endpoint."""

from __future__ import annotations

import io
import re
from contextlib import redirect_stdout

import pytest

from edl_tpu import cli as ref_cli
from edl_tpu_torch import cli
from edl_tpu_torch.observability.calib import CalibrationLedger
from edl_tpu_torch.observability.health import serve_health
from edl_tpu_torch.observability.metrics import (MetricsRegistry,
                                                 dump_flight_record)
from edl_tpu_torch.observability.tracing import Tracer, new_trace_id


def two_process_trace(tmp_path, tid):
    """An LB and one replica recording one hedged request, each into its
    own tracer, dumped as two processes' files (test_trace_cli.py's)."""
    lb, fd = Tracer(), Tracer()
    root = lb.record_span("lb_request", "lb", 0.000, 0.050,
                          trace_id=tid, n=4, origin="head",
                          outcome="served", hedged=True)
    lb.record_span("lb.route", "lb", 0.000, 0.001, trace_id=tid,
                   parent_id=root)
    lb.record_span("lb.upstream", "lb", 0.001, 0.048, trace_id=tid,
                   parent_id=root, replica="r0", kind="primary",
                   outcome="discarded")
    lb.record_span("lb.upstream", "lb", 0.020, 0.024, trace_id=tid,
                   parent_id=root, replica="r1", kind="hedge",
                   outcome="win")
    door = fd.record_span("frontdoor_request", "frontdoor", 0.021,
                          0.024, trace_id=tid, parent_id=root,
                          replica="r1", rows=4)
    fd.record_span("frontdoor.forward", "frontdoor", 0.022, 0.0235,
                   trace_id=tid, parent_id=door)
    # another trace in the same files must not leak in
    lb.record_span("lb_request", "lb", 0.1, 0.2, trace_id=new_trace_id())
    lb.dump(str(tmp_path / "trace-lb-1.json"), "lb-1")
    fd.dump(str(tmp_path / "trace-fd-r1.json"), "fd-r1")


def run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_trace_verb_renders_and_errors(tmp_path, capsys):
    tid = new_trace_id()
    two_process_trace(tmp_path, tid)
    rc = cli.main(["trace", tid, "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"trace {tid}" in out
    assert "lb_request" in out and "frontdoor_request" in out
    assert "outcome=discarded" in out and "2 processes" in out
    # unknown id: exit 1 with a pointer, not a stack trace
    assert cli.main(["trace", "no-such-trace", "--trace-dir",
                     str(tmp_path)]) == 1
    assert "not found" in capsys.readouterr().err
    # no sources at all: exit 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["trace", tid, "--trace-dir", str(empty)]) == 2


def test_cli_trace_explicit_files(tmp_path):
    tid = new_trace_id()
    two_process_trace(tmp_path, tid)
    rc, txt = run(cli.main, ["trace", tid, "--files",
                             str(tmp_path / "trace-lb-1.json")])
    assert rc == 0
    # only the LB's half: the door's spans live in the other file
    assert "lb_request" in txt and "frontdoor_request" not in txt


def test_cli_trace_reads_flight_records(tmp_path):
    tid = new_trace_id()
    t = Tracer()
    t.record_span("lb_request", "lb", 0.0, 0.02, trace_id=tid,
                  origin="rescue", outcome="served")
    dump_flight_record(str(tmp_path), "lb-abnormal-exit", tracer=t)
    rc, txt = run(cli.main, ["trace", tid, "--trace-dir", str(tmp_path)])
    assert rc == 0 and "origin=rescue" in txt


@pytest.mark.parametrize("files", [False, True])
def test_cli_trace_equals_the_reference(tmp_path, files):
    tid = new_trace_id()
    two_process_trace(tmp_path, tid)
    argv = (["trace", tid, "--files", str(tmp_path / "trace-lb-1.json"),
             str(tmp_path / "trace-fd-r1.json")] if files
            else ["trace", tid, "--trace-dir", str(tmp_path)])
    ours, ref = run(cli.main, argv), run(ref_cli.main, argv)
    assert ours == ref
    assert ours[0] == 0


@pytest.fixture
def served_registry():
    """A registry with a goodput gauge and a calibration factor, served
    on ``/metrics`` of an OS-assigned port; yields ``host:port``."""
    reg = MetricsRegistry()
    reg.gauge("goodput_fraction").set(0.61, job="t/train")
    CalibrationLedger(job="cli/job", registry=reg).record(
        "reshard_seconds", 1.0, 1.4, unit="s")
    srv = serve_health(0, {}, host="127.0.0.1", registry=reg)
    try:
        yield f"127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()


def masked(text: str) -> str:
    """A dashboard with its scrape ages (host clock) blanked."""
    return re.sub(r"stale=[0-9.]+s", "stale=?", text)


@pytest.mark.parametrize("verb", ["fleet", "calib"])
def test_cli_dashboards_equal_the_reference(served_registry, verb):
    argv = [verb, "--scrape-targets", served_registry, "--sweeps", "2",
            "--scrape-interval", "0.05", "--check"]
    rc, ours = run(cli.main, argv)
    ref_rc, ref = run(ref_cli.main, argv)
    assert (rc, masked(ours)) == (ref_rc, masked(ref))
    assert rc == 0  # nothing firing: --check stays green
    assert "reshard_seconds" in ours and "cli/job" in ours
    if verb == "fleet":
        assert "t/train" in ours and "61.00%" in ours
        assert f"✓ {served_registry}" in ours  # scraped, up


@pytest.mark.parametrize("verb", ["fleet", "calib"])
def test_cli_dashboards_need_a_source(verb, capsys):
    assert cli.main([verb]) == 2
    assert "no scrape source" in capsys.readouterr().err


def test_cli_scrape_coord_wants_host_port(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["fleet", "--scrape-coord", "nonsense"])
    assert exc.value.code == 2
    assert "host:port" in capsys.readouterr().err
