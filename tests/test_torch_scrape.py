"""The port's scrape plane (edl_tpu_torch/observability/scrape.py, both
halves) and exposition parser (observability/metrics.py) against the JAX
package's: tests/test_scrape.py's classes, each scenario run on both
packages (``pkg``) with the reference's assertions, the deterministic ones
(fake clock, injected fetchers) also required to give equal results; one
rendered registry parsed equal by both packages' ``parse_exposition``; and
a ``MetricsScraper`` over a live port ``ServingFleet``'s ``/metrics`` on
the CPU (the MLP), feeding a ``ServingScaler`` through ``feed_from``."""

import json
import os
import socket
import threading
import time
import types

import numpy as np
import pytest

from edl_tpu import coord as jcoord
from edl_tpu.api import types as jtypes
from edl_tpu.coord import gc as jgc
from edl_tpu.coord import server as jserver
from edl_tpu.observability import collector as jcollector
from edl_tpu.observability import health as jhealth
from edl_tpu.observability import metrics as jmetrics
from edl_tpu.observability import scrape as jscrape
from edl_tpu.scheduler import autoscaler as jauto
from edl_tpu_torch import coord as tcoord
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.coord import gc as tgc
from edl_tpu_torch.coord import server as tserver
from edl_tpu_torch.observability import collector as tcollector
from edl_tpu_torch.observability import health as thealth
from edl_tpu_torch.observability import metrics as tmetrics
from edl_tpu_torch.observability import scrape as tscrape
from edl_tpu_torch.scheduler import autoscaler as tauto

PKGS = {
    "jax": types.SimpleNamespace(
        scrape=jscrape, metrics=jmetrics, coord=jcoord, gc=jgc,
        server=jserver, collector=jcollector, health=jhealth, auto=jauto,
        t=jtypes),
    "torch": types.SimpleNamespace(
        scrape=tscrape, metrics=tmetrics, coord=tcoord, gc=tgc,
        server=tserver, collector=tcollector, health=thealth, auto=tauto,
        t=ttypes),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def both(fn):
    """``fn(pkg)`` on the JAX package and on the port; asserts the two
    equal and returns the port's."""
    want, got = fn(PKGS["jax"]), fn(PKGS["torch"])
    assert got == want
    return got


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_scraper(pkg, fetch_map, clock=None, **kw):
    """A scraper over injected fetchers: target name → callable returning
    exposition text (or raising)."""
    clock = clock or FakeClock()
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("registry", pkg.metrics.MetricsRegistry())

    def fetch(target):
        return fetch_map[target.name]()

    s = pkg.scrape.MetricsScraper(fetch=fetch, clock=clock, **kw)
    for name in fetch_map:
        s.add_target(pkg.scrape.ScrapeTarget(name=name, addr=f"{name}:0"))
    return s, clock


def serving_registry(pkg, job="ns/svc"):
    """A registry shaped like a serving replica's /metrics."""
    reg = pkg.metrics.MetricsRegistry()
    reqs = reg.counter("serving_requests")
    viol = reg.counter("serving_slo_violations")
    hist = reg.histogram("serving_request_seconds",
                         buckets=pkg.metrics.SERVING_LATENCY_BUCKETS)
    reg.gauge("serving_fleet_queue_depth").set(0, job=job)
    reg.gauge("serving_replicas_active").set(1, job=job)
    reg.gauge("serving_replicas_ready").set(1, job=job)
    return reg, reqs, viol, hist


# -- the parser ----------------------------------------------------------------


def rich_registry(pkg):
    """One registry with every family kind, escaped label values, a hash
    inside a label value and exemplars."""
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("reqs").inc(3, job="a")
    reg.counter("reqs").inc(2, job='b"q\\n')
    reg.counter("jobs").inc(1, job="a # b")
    reg.gauge("depth").set(7.5, job="a")
    reg.gauge("depth").set(-1, job="c\nd")
    h = reg.histogram("lat_seconds", buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.004, 0.02, 0.3, 5.0):
        h.observe(v, job="a")
    h.put_exemplar(0.02, "feedbeef0001", job="a")
    reg.histogram("empty_seconds")
    return reg


def test_parse_exposition_equal_across_packages():
    def run(pkg):
        text = rich_registry(pkg).render()
        ex = []
        samples = pkg.metrics.iter_samples(text, exemplars=ex)
        return (pkg.metrics.parse_exposition(text), samples,
                [e[:4] for e in ex])
    got = both(run)
    assert got[0]['edl_reqs_total{job="a"}'] == 3
    assert got[2][0][2] == {"trace_id": "feedbeef0001"}


def test_port_render_parses_back_through_both_parsers():
    """The port's renderer (metrics.py) emits what either package's
    strict parser accepts, with the same series."""
    text = rich_registry(PKGS["torch"]).render()
    assert tmetrics.parse_exposition(text) == jmetrics.parse_exposition(text)


@pytest.mark.parametrize("bad", [
    "edl_x 1\nedl_x 2\n",
    "# TYPE edl_x counter\n# TYPE edl_x counter\nedl_x 1\n",
    "# TYPE edl_h histogram\nedl_h_bucket{le=\"1\"} 1\nedl_h_sum 1\n",
    "# TYPE edl_h histogram\nedl_h_bucket{le=\"1\"} 2\n"
    "edl_h_bucket{le=\"+Inf\"} 1\n",
    "edl_x{job=a} 1\n",
    "# BOGUS comment\n",
    "edl_x{le=\"+Inf\"} 1 # {trace_id=oops} 1\n"])
def test_grammar_violations_raise_in_both(bad):
    for pkg in PKGS.values():
        with pytest.raises(pkg.metrics.ExpositionError):
            pkg.metrics.parse_exposition(bad)


# -- ring store + queries ------------------------------------------------------


class TestQueries:
    def test_latest_delta_rate_and_counter_reset(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        c = reg.counter("reqs")
        c.inc(10, job="a")
        s, clock = make_scraper(pkg, {"t1": reg.render})
        s.sweep()
        clock.advance(1.0)
        c.inc(20, job="a")
        s.sweep()
        assert s.latest("edl_reqs_total", {"job": "a"}) == 30
        assert s.delta("edl_reqs_total", 10.0, {"job": "a"}) == 20
        assert abs(s.rate("edl_reqs_total", 10.0) - 20.0) < 1e-6
        clock.advance(1.0)
        c.clear()
        c.inc(5, job="a")
        s.sweep()
        assert s.delta("edl_reqs_total", 10.0) == 25
        assert s.latest("edl_reqs_total", {"job": "zzz"}) is None

    def test_sum_by_and_label_values(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        g = reg.gauge("replicas")
        g.set(2, job="a")
        g.set(3, job="b")
        s, clock = make_scraper(pkg, {"t1": reg.render})
        s.sweep()
        assert s.sum_by("edl_replicas", "job") == {"a": 2.0, "b": 3.0}
        assert s.label_values("edl_replicas", "job") == ["a", "b"]

    def test_latest_aggregations_across_targets(self, pkg):
        r1, r2 = pkg.metrics.MetricsRegistry(), pkg.metrics.MetricsRegistry()
        r1.gauge("frac").set(0.9, job="a")
        r2.gauge("frac").set(0.5, job="a")
        s, _ = make_scraper(pkg, {"t1": r1.render, "t2": r2.render})
        s.sweep()
        assert s.latest("edl_frac", agg="min") == 0.5
        assert s.latest("edl_frac", agg="max") == 0.9
        assert abs(s.latest("edl_frac", agg="avg") - 0.7) < 1e-9
        assert abs(s.latest("edl_frac") - 1.4) < 1e-9

    def test_histogram_quantile_windowed_interpolation(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        h = reg.histogram("lat_seconds", buckets=(0.01, 0.05, 0.1))
        s, clock = make_scraper(pkg, {"t1": reg.render})
        s.sweep()
        clock.advance(1.0)
        for _ in range(90):
            h.observe(0.005)
        for _ in range(10):
            h.observe(0.08)
        s.sweep()
        p50 = s.histogram_quantile("edl_lat_seconds", 0.50, 10.0)
        p99 = s.histogram_quantile("edl_lat_seconds", 0.99, 10.0)
        assert p50 is not None and p50 <= 0.01
        assert 0.05 < p99 <= 0.1
        clock.advance(100.0)
        s.sweep()
        assert s.histogram_quantile("edl_lat_seconds", 0.99, 1.0) is None

    def test_ring_bounded_retention(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        g = reg.gauge("v")
        s, clock = make_scraper(pkg, {"t1": reg.render}, retention=8)
        for i in range(50):
            g.set(i)
            s.sweep()
            clock.advance(1.0)
        assert s.series_count() >= 1
        ring = next(iter(s._series["edl_v"].values()))
        assert len(ring.samples) == 8


def test_query_results_equal_across_packages():
    """One fake-clocked history of counters, gauges and a histogram over
    two targets: every query answers alike in both packages."""
    def run(pkg):
        r1, r2 = pkg.metrics.MetricsRegistry(), pkg.metrics.MetricsRegistry()
        s, clock = make_scraper(pkg, {"t1": r1.render, "t2": r2.render})
        out = []
        rng = np.random.default_rng(4)
        for step in range(12):
            for reg, job in ((r1, "a"), (r2, "b")):
                reg.counter("serving_requests").inc(
                    int(rng.integers(0, 50)), job=job)
                reg.gauge("depth").set(float(rng.integers(0, 9)), job=job)
                h = reg.histogram("serving_request_seconds",
                                  buckets=pkg.metrics.SERVING_LATENCY_BUCKETS)
                for v in rng.exponential(0.02, size=int(rng.integers(1, 20))):
                    h.observe(float(v), job=job)
            s.sweep()
            clock.advance(0.5)
            out.append((
                s.latest("edl_depth"), s.latest("edl_depth", agg="max"),
                s.delta("edl_serving_requests_total", 3.0),
                round(s.rate("edl_serving_requests_total", 3.0,
                             {"job": "a"}), 9),
                s.sum_by("edl_serving_requests_total", "job", 2.0),
                s.histogram_quantile("edl_serving_request_seconds", 0.99,
                                     3.0),
                s.histogram_quantile("edl_serving_request_seconds", 0.5,
                                     1.0, {"job": "b"})))
        return out
    both(run)


# -- sweep / backoff / staleness -----------------------------------------------


class TestSweepBehavior:
    def test_failure_backoff_grows_and_is_bounded(self, pkg):
        calls = {"n": 0}

        def boom():
            calls["n"] += 1
            raise OSError("connection refused")

        s, clock = make_scraper(pkg, {"dead": boom}, interval_s=1.0,
                                backoff_base_s=1.0, backoff_max_s=4.0)
        s.sweep()
        assert calls["n"] == 1
        st = s._state[("dead:0", "/metrics")]
        assert st.consecutive_failures == 1
        s.sweep()
        assert calls["n"] == 1
        clock.advance(1.1)
        s.sweep()
        assert calls["n"] == 2 and st.consecutive_failures == 2
        clock.advance(1.1)
        s.sweep()
        assert calls["n"] == 2
        for _ in range(5):
            clock.advance(4.1)
            s.sweep()
        assert st.consecutive_failures >= 5
        assert st.next_due_t - clock() <= 4.0 + 1e-9

    def test_staleness_marked_and_healthy_targets_unaffected(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        reg.gauge("ok").set(1)
        flaky = {"fail": False}

        def maybe():
            if flaky["fail"]:
                raise OSError("down")
            return reg.render()

        s, clock = make_scraper(pkg, {"good": reg.render, "flaky": maybe},
                                interval_s=1.0, stale_after_s=3.0)
        s.sweep()
        states = {t["name"]: t for t in s.target_states()}
        assert states["good"]["state"] == "up"
        assert states["flaky"]["state"] == "up"
        flaky["fail"] = True
        for _ in range(6):
            clock.advance(1.0)
            s.sweep()
        states = {t["name"]: t for t in s.target_states()}
        assert states["flaky"]["state"] == "down"
        assert states["flaky"]["consecutive_failures"] >= 1
        assert states["flaky"]["staleness_s"] > 3.0
        assert states["good"]["state"] == "up"
        assert states["good"]["staleness_s"] <= 1.0

    def test_removed_target_rings_pruned_and_stale_gauges_excluded(self, pkg):
        r1, r2 = pkg.metrics.MetricsRegistry(), pkg.metrics.MetricsRegistry()
        r1.gauge("serving_fleet_queue_depth").set(9, job="j")
        r2.gauge("serving_fleet_queue_depth").set(0, job="j")
        s, clock = make_scraper(pkg, {"dead": r1.render, "live": r2.render},
                                stale_after_s=3.0)
        s.sweep()
        assert s.latest("edl_serving_fleet_queue_depth", {"job": "j"}) == 9

        def fetch(t):
            if t.name == "dead":
                raise OSError("down")
            return r2.render()

        s._fetch = fetch
        for _ in range(5):
            clock.advance(1.0)
            s.sweep()
        assert s.latest("edl_serving_fleet_queue_depth", {"job": "j"}) == 0
        assert s.latest("edl_serving_fleet_queue_depth", {"job": "j"},
                        max_age_s=float("inf")) == 9
        before = s.series_count()
        s.remove_target(pkg.scrape.ScrapeTarget(name="dead", addr="dead:0"))
        assert s.series_count() < before
        assert s.latest("edl_serving_fleet_queue_depth", {"job": "j"},
                        max_age_s=float("inf")) == 0

    def test_raising_discovery_source_freezes_not_forgets_targets(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        reg.gauge("x").set(1)
        broken = {"on": False}

        def discover():
            if broken["on"]:
                raise OSError("coordinator unreachable")
            return [pkg.scrape.ScrapeTarget(name="d1", addr="d1:0")]

        s = pkg.scrape.MetricsScraper(
            discover=[discover], fetch=lambda t: reg.render(),
            clock=FakeClock(), registry=pkg.metrics.MetricsRegistry(),
            forget_after_sweeps=2)
        s.sweep()
        assert [t.name for t in s.targets()] == ["d1"]
        broken["on"] = True
        for _ in range(5):
            s.sweep()
        assert [t.name for t in s.targets()] == ["d1"]
        broken["on"] = False
        s.sweep()
        assert [t.name for t in s.targets()] == ["d1"]

    def test_discovered_target_dropped_after_source_forgets_it(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        present = {"on": True}

        def discover():
            if present["on"]:
                return [pkg.scrape.ScrapeTarget(name="d1", addr="d1:0")]
            return []

        s = pkg.scrape.MetricsScraper(
            discover=[discover], fetch=lambda t: reg.render(),
            clock=FakeClock(), registry=pkg.metrics.MetricsRegistry(),
            forget_after_sweeps=2)
        s.sweep()
        assert [t.name for t in s.targets()] == ["d1"]
        present["on"] = False
        s.sweep()
        assert s.targets()
        s.sweep()
        assert s.targets() == []

    def test_self_metrics_rendered_strict(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        src = pkg.metrics.MetricsRegistry()
        src.gauge("x").set(1)
        s = pkg.scrape.MetricsScraper(fetch=lambda t: src.render(),
                                      registry=reg, clock=FakeClock())
        s.add_target(pkg.scrape.ScrapeTarget(name="t", addr="t:0"))
        s.sweep()
        series = pkg.metrics.parse_exposition(reg.render())
        assert series['edl_scrape_targets{state="up"}'] == 1
        assert series["edl_scrape_sweep_seconds_count"] >= 1
        assert series["edl_scrape_series"] >= 1

    def test_jittered_loop_runs_and_stops(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        reg.gauge("x").set(1)
        s = pkg.scrape.MetricsScraper(
            fetch=lambda t: reg.render(),
            registry=pkg.metrics.MetricsRegistry(), interval_s=0.02,
            jitter_frac=0.5)
        s.add_target(pkg.scrape.ScrapeTarget(name="t", addr="t:0"))
        s.start()
        deadline = time.monotonic() + 5.0
        while s.sweeps < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        s.stop()
        assert s.sweeps >= 3
        assert not s.is_alive()


# -- discovery -----------------------------------------------------------------


class TestDiscovery:
    def test_kv_targets_supervisor_and_serving_with_ttl(self, pkg):
        sc = pkg.scrape
        kv = pkg.coord.PyCoordService()
        kv.kv_set("metrics-addr-w0", b"127.0.0.1:9100")
        sc.publish_serving_metrics_addr(kv, "ns/svc", "r0",
                                        "127.0.0.1:9200", ttl_s=60.0)
        kv.kv_set(sc.SERVING_METRICS_ADDR_PREFIX + "ns/svc/r1",
                  sc.format_addr_value("127.0.0.1:9300", -5.0))
        found = {t.name: t for t in sc.kv_targets(kv)()}
        assert found["supervisor/w0"].addr == "127.0.0.1:9100"
        assert found["supervisor/w0"].labels["role"] == "supervisor"
        svc = found["serving/ns/svc/r0"]
        assert svc.addr == "127.0.0.1:9200"
        assert svc.labels == {"role": "serving", "job": "ns/svc",
                              "replica": "r0"}
        assert "serving/ns/svc/r1" not in found

    def test_addr_value_roundtrip(self, pkg):
        sc = pkg.scrape
        addr, expired = sc.parse_addr_value(
            sc.format_addr_value("h:1", ttl_s=30.0))
        assert addr == "h:1" and not expired
        addr, expired = sc.parse_addr_value(sc.format_addr_value("h:1", None))
        assert addr == "h:1" and not expired
        assert sc.parse_addr_value(b"garbage")[0] is None

    def test_addr_publisher_refreshes_and_deletes_on_stop(self, pkg):
        kv = pkg.coord.PyCoordService()
        pub = pkg.scrape.AddrPublisher(kv, "serving-metrics-addr/j/r",
                                       "127.0.0.1:1", ttl_s=3.0)
        pub.start()
        deadline = time.monotonic() + 5.0
        first = None
        while time.monotonic() < deadline:
            first = kv.kv_get("serving-metrics-addr/j/r")
            if first is not None:
                break
            time.sleep(0.01)
        assert first is not None
        _, exp0 = first.decode().split()
        v = first
        while time.monotonic() < deadline:
            v = kv.kv_get("serving-metrics-addr/j/r")
            if v is not None and v.decode().split()[1] != exp0:
                break
            time.sleep(0.05)
        assert v.decode().split()[1] != exp0, "expiry never refreshed"
        pub.stop()
        assert kv.kv_get("serving-metrics-addr/j/r") is None

    def test_serving_metrics_addr_swept_on_job_deletion(self, pkg):
        assert "serving-metrics-addr/" in pkg.gc.JOB_KV_PREFIXES
        kv = pkg.coord.PyCoordService()
        pkg.scrape.publish_serving_metrics_addr(kv, "ns/doomed", "r0", "h:1")
        pkg.scrape.publish_serving_metrics_addr(kv, "ns/doomed2", "r0",
                                                "h:2")
        assert pkg.gc.gc_job_kv(kv, "ns/doomed") == 1
        assert kv.kv_get("serving-metrics-addr/ns/doomed/r0") is None
        assert kv.kv_get("serving-metrics-addr/ns/doomed2/r0") is not None

    def test_file_targets(self, pkg, tmp_path):
        (tmp_path / "metrics-addr-w3").write_text("127.0.0.1:9999")
        (tmp_path / "unrelated").write_text("x")
        found = pkg.scrape.file_targets(str(tmp_path))()
        assert len(found) == 1
        assert found[0].name == "supervisor/w3"
        assert found[0].addr == "127.0.0.1:9999"

    def test_manifest_targets_from_jobparser_annotations(self, pkg):
        """Each package's jobparser manifest read by its own discovery."""
        from edl_tpu.controller import jobparser as jjobparser
        from edl_tpu_torch.controller import jobparser as tjobparser

        jobparser = tjobparser if pkg.t is ttypes else jjobparser
        job = pkg.t.TrainingJob(
            name="j1", namespace="ns", spec=pkg.t.TrainingJobSpec(
                fault_tolerant=True, trainer=pkg.t.TrainerSpec(
                    min_instance=1, max_instance=2,
                    resources=pkg.t.ResourceRequirements())))
        m = jobparser.parse_to_coordinator(job)
        targets = pkg.scrape.manifest_targets([m, {"kind": "Service"}],
                                              host="10.0.0.7")()
        assert len(targets) == 1
        t = targets[0]
        assert t.name == "ns/j1-coordinator"
        assert t.addr.startswith("10.0.0.7:")
        assert t.path == "/metrics"

    def test_static_targets(self, pkg):
        ts = pkg.scrape.static_targets(["a:1", "b:2"], role="x")
        assert [(t.name, t.addr) for t in ts] == [("a:1", "a:1"),
                                                  ("b:2", "b:2")]
        assert ts[0].labels == {"role": "x"}


# -- end to end: both coordinator backends and a black hole ---------------------


def _blackhole_server():
    """A socket that accepts connections and never answers."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    stop = threading.Event()
    conns = []

    def run():
        srv.settimeout(0.2)
        while not stop.is_set():
            try:
                c, _ = srv.accept()
                conns.append(c)
            except socket.timeout:
                continue
            except OSError:
                return

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def close():
        stop.set()
        t.join(timeout=2)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        srv.close()

    return srv.getsockname()[1], close


def test_scrape_both_coordinator_backends_and_blackholed_target():
    """The port's scraper over the port's native coordinator's /metrics,
    a port PyCoordService-backed /metrics route and a black-holed target:
    coord series land for both backends, the wedge backs off, the healthy
    targets keep their cadence."""
    if not tcoord.native_available():
        pytest.skip("native coord core unavailable")
    h = tserver.spawn_server(health_port=0)
    py_reg = tmetrics.MetricsRegistry()
    svc = tcoord.PyCoordService()
    svc.join("a")
    svc.register_metrics(py_reg)
    py_srv = thealth.serve_health(0, {"ok": lambda: True}, host="127.0.0.1",
                                  registry=py_reg)
    bh_port, bh_close = _blackhole_server()
    scraper = tscrape.MetricsScraper(
        interval_s=0.2, timeout_s=0.5, backoff_base_s=0.2,
        backoff_max_s=1.0, registry=tmetrics.MetricsRegistry())
    scraper.add_target(tscrape.ScrapeTarget(
        name="coord/native", addr=f"127.0.0.1:{h.health_port}",
        labels={"role": "coordinator"}))
    scraper.add_target(tscrape.ScrapeTarget(
        name="coord/python", addr=f"127.0.0.1:{py_srv.server_address[1]}",
        labels={"role": "coordinator"}))
    scraper.add_target(tscrape.ScrapeTarget(
        name="wedged", addr=f"127.0.0.1:{bh_port}"))
    try:
        c = h.client()
        c.join("w0", "a")
        t0 = time.monotonic()
        report = scraper.sweep()
        assert report["failed"] == 1, report
        assert report["scraped"] == 2, report
        assert time.monotonic() - t0 < 3.0
        assert scraper.latest("edl_coord_members", agg="max") is not None
        by_target = {t["name"]: t for t in scraper.target_states()}
        assert by_target["coord/native"]["state"] == "up"
        assert by_target["coord/python"]["state"] == "up"
        assert by_target["wedged"]["consecutive_failures"] == 1
        assert by_target["wedged"]["state"] in ("stale", "down")
        for _ in range(4):
            time.sleep(0.25)
            scraper.sweep()
        st = scraper._state[(f"127.0.0.1:{bh_port}", "/metrics")]
        assert st.next_due_t - time.monotonic() <= 1.0 + 0.5
        fresh = {t["name"]: t for t in scraper.target_states()}
        assert fresh["coord/native"]["scrapes"] > 1
        c.close()
    finally:
        bh_close()
        py_srv.shutdown()
        h.stop()


# -- FleetView and the scrape-fed scaler ----------------------------------------


JOB = "ns/svc"


def fleet_view(pkg, reg, clock):
    s = pkg.scrape.MetricsScraper(fetch=lambda t: reg.render(), clock=clock,
                                  registry=pkg.metrics.MetricsRegistry())
    s.add_target(pkg.scrape.ScrapeTarget(name="r0", addr="r0:0",
                                         labels={"job": JOB}))
    return s, pkg.scrape.FleetView(s, window_s=10.0)


class TestFleetView:
    def test_serving_stats_rollup(self, pkg):
        reg, reqs, viol, hist = serving_registry(pkg, JOB)
        clock = FakeClock()
        s, view = fleet_view(pkg, reg, clock)
        s.sweep()
        clock.advance(2.0)
        for _ in range(100):
            reqs.inc(job=JOB)
            hist.observe(0.004, job=JOB)
        reg.gauge("serving_fleet_queue_depth").set(7, job=JOB)
        s.sweep()
        st = view.stats_for(JOB)
        assert st.requests_windowed == 100
        assert abs(st.qps - 50.0) < 1.0
        assert 2.5 <= st.p99_ms <= 5.0
        assert st.queue_depth == 7
        assert st.replicas_active == 1 and st.replicas_ready == 1
        assert view.jobs() == [JOB]

    def test_scrape_fed_scaler_matches_hook_fed_policy(self, pkg):
        reg, reqs, viol, hist = serving_registry(pkg, JOB)
        reg.gauge("serving_replicas_active").set(2, job=JOB)
        reg.gauge("serving_replicas_ready").set(2, job=JOB)
        clock = FakeClock()
        s, view = fleet_view(pkg, reg, clock)
        s.sweep()
        clock.advance(1.0)
        for _ in range(50):
            reqs.inc(job=JOB)
            hist.observe(0.08, job=JOB)
        s.sweep()
        sc = pkg.auto.ServingScaler().feed_from(view)
        job = pkg.t.ServingJob(name="svc", namespace="ns",
                               spec=pkg.t.ServingSpec(
                                   min_replicas=1, max_replicas=8,
                                   slo_p99_ms=50.0))
        stats = sc.stats_for(JOB)
        assert stats.p99_ms > 50.0
        assert sc.decide(job, stats, 2) == 3
        reg2, reqs2, _, hist2 = serving_registry(pkg, JOB)
        reg2.gauge("serving_replicas_active").set(2, job=JOB)
        clock2 = FakeClock()
        s2, view2 = fleet_view(pkg, reg2, clock2)
        s2.sweep()
        clock2.advance(2.0)
        for _ in range(200):
            reqs2.inc(job=JOB)
            hist2.observe(0.001, job=JOB)
        s2.sweep()
        job_qps = pkg.t.ServingJob(name="svc", namespace="ns",
                                   spec=pkg.t.ServingSpec(
                                       min_replicas=1, max_replicas=8,
                                       slo_p99_ms=0.0,
                                       target_qps_per_replica=30.0))
        sc2 = pkg.auto.ServingScaler().feed_from(view2)
        st2 = sc2.stats_for(JOB)
        assert abs(st2.qps - 100.0) < 5.0
        assert sc2.decide(job_qps, st2, 2) == 4
        assert sc.decide(job, type(stats)(
            p50_ms=10, p99_ms=30, qps=10, queue_depth=1, replicas_ready=2,
            replicas_active=2, requests_windowed=20), 2) is None

    def test_dashboard_renders(self, pkg):
        reg, reqs, viol, hist = serving_registry(pkg, JOB)
        reg.gauge("goodput_fraction").set(0.87, job="t/train")
        clock = FakeClock()
        s, view = fleet_view(pkg, reg, clock)
        s.sweep()
        clock.advance(1.0)
        reqs.inc(10, job=JOB)
        s.sweep()
        engine = pkg.scrape.AlertEngine(
            view, rules=[pkg.scrape.TargetDownRule()],
            registry=pkg.metrics.MetricsRegistry())
        engine.evaluate()
        out = pkg.scrape.render_fleet_dashboard(view, engine)
        assert "FLEET" in out and JOB in out
        assert "TARGETS" in out and "r0" in out
        assert "ALERTS" in out
        assert "t/train" in out


def test_fleet_view_and_dashboards_equal_across_packages():
    """One fake-clocked replica history (requests, violations, latency,
    goodput, calibration series) rolled up by each package's FleetView:
    the stats, the snapshot and both dashboards are equal."""
    def run(pkg):
        reg, reqs, viol, hist = serving_registry(pkg, JOB)
        reg.gauge("goodput_fraction").set(0.61, job="t/train")
        reg.gauge("calibration_factor").set(1.7, job="t/train",
                                            predictor="reshard_seconds")
        reg.counter("calibration_samples").inc(
            4, job="t/train", predictor="reshard_seconds")
        clock = FakeClock()
        s, view = fleet_view(pkg, reg, clock)
        out = []
        for k in range(6):
            s.sweep()
            clock.advance(1.0)
            reqs.inc(20 + 3 * k, job=JOB)
            viol.inc(k, job=JOB)
            for v in (0.001, 0.004, 0.03 * (k + 1)):
                hist.observe(v, job=JOB)
        s.sweep()
        st = view.stats_for(JOB)
        engine = pkg.scrape.AlertEngine(
            view, rules=pkg.scrape.default_rules(),
            registry=pkg.metrics.MetricsRegistry())
        firing = [(a.rule, a.labels, a.value) for a in engine.evaluate()]
        snap = view.snapshot()
        out.append((st, snap, firing,
                    pkg.scrape.render_fleet_dashboard(view, engine),
                    pkg.scrape.render_calib_dashboard(view)))
        return [(dataclass_dict(x[0]),) + x[1:] for x in out]
    both(run)


def dataclass_dict(st) -> dict:
    import dataclasses

    return dataclasses.asdict(st)


# -- alerting ------------------------------------------------------------------


def armed(pkg, reg, clock, rules, **engine_kw):
    s = pkg.scrape.MetricsScraper(fetch=lambda t: reg.render(), clock=clock,
                                  registry=pkg.metrics.MetricsRegistry())
    s.add_target(pkg.scrape.ScrapeTarget(name="r0", addr="r0:0"))
    view = pkg.scrape.FleetView(s, window_s=10.0)
    engine = pkg.scrape.AlertEngine(view, rules=rules,
                                    registry=pkg.metrics.MetricsRegistry(),
                                    **engine_kw)
    return s, view, engine


class TestAlertEngine:
    def test_fast_burn_fires_within_two_windows_and_resolves(self, pkg):
        reg, reqs, viol, hist = serving_registry(pkg, JOB)
        clock = FakeClock()
        rule = pkg.scrape.BurnRateRule(budget_fraction=0.001,
                                       fast_window_s=5.0, slow_window_s=60.0,
                                       fast_factor=10.0, min_requests=10)
        s, view, engine = armed(pkg, reg, clock, [rule])
        s.sweep()
        assert engine.evaluate() == []
        clock.advance(1.0)
        reqs.inc(100, job=JOB)
        viol.inc(50, job=JOB)
        s.sweep()
        firing = engine.evaluate()
        assert "slo_fast_burn" in {a.rule for a in firing}, firing
        fast = next(a for a in firing if a.rule == "slo_fast_burn")
        assert fast.labels == {"job": JOB}
        assert fast.value > 10.0
        assert engine._gauge.value(rule="slo_fast_burn") == 1
        assert pkg.collector.get_counters().get(
            "alerts_fired", rule="slo_fast_burn") >= 1
        clock.advance(20.0)
        reqs.inc(100, job=JOB)
        s.sweep()
        assert "slo_fast_burn" not in {a.rule for a in engine.evaluate()}
        assert engine._gauge.value(rule="slo_fast_burn") == 0

    def test_goodput_collapse_and_conservation_rules(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        reg.gauge("goodput_fraction").set(0.2, job="t/j")
        reg.gauge("goodput_conservation_error_pct").set(4.2, job="t/j")
        clock = FakeClock()
        s, view, engine = armed(pkg, reg, clock, [
            pkg.scrape.GoodputCollapseRule(min_fraction=0.5),
            pkg.scrape.ConservationRule(max_error_pct=1.0)])
        s.sweep()
        rules = {a.rule: a for a in engine.evaluate()}
        assert rules["goodput_collapse"].labels == {"job": "t/j"}
        assert rules["conservation_violation"].value == 4.2
        reg.gauge("goodput_fraction").set(0.9, job="t/j")
        reg.gauge("goodput_conservation_error_pct").set(0.1, job="t/j")
        clock.advance(1.0)
        s.sweep()
        assert engine.evaluate() == []

    def test_target_down_rule(self, pkg):
        def boom():
            raise OSError("refused")

        clock = FakeClock()
        s = pkg.scrape.MetricsScraper(
            fetch=lambda t: boom(), clock=clock,
            registry=pkg.metrics.MetricsRegistry(), backoff_base_s=0.1,
            backoff_max_s=0.1)
        s.add_target(pkg.scrape.ScrapeTarget(name="dead", addr="dead:0"))
        view = pkg.scrape.FleetView(s)
        engine = pkg.scrape.AlertEngine(
            view, rules=[pkg.scrape.TargetDownRule(down_after_failures=2)],
            registry=pkg.metrics.MetricsRegistry())
        s.sweep()
        assert engine.evaluate() == []
        for _ in range(3):
            clock.advance(0.2)
            s.sweep()
        firing = engine.evaluate()
        assert [a.rule for a in firing] == ["scrape_target_down"]
        assert firing[0].labels == {"target": "dead"}

    def test_alert_fires_flight_record_through_shared_lock(self, pkg,
                                                           tmp_path):
        reg = pkg.metrics.MetricsRegistry()
        reg.gauge("goodput_fraction").set(0.1, job="t/j")
        clock = FakeClock()
        s, view, engine = armed(
            pkg, reg, clock, [pkg.scrape.GoodputCollapseRule(
                min_fraction=0.5)],
            flight_dir=str(tmp_path), dump_cooldown_s=60.0)
        s.sweep()
        engine.evaluate()
        recs = [f for f in os.listdir(tmp_path)
                if f.startswith("flightrec-")]
        assert len(recs) == 1
        doc = json.loads((tmp_path / recs[0]).read_text())
        assert doc["reason"] == "alert-goodput_collapse"
        assert doc["extra"]["labels"] == {"job": "t/j"}

    def test_rule_exception_does_not_stop_other_rules(self, pkg):
        sc = pkg.scrape

        class Broken(sc.AlertRule):
            def evaluate(self, view):
                raise RuntimeError("boom")

        class Always(sc.AlertRule):
            def evaluate(self, view):
                return [sc.Alert(rule="always", labels={}, firing=True)]

        s, view, engine = armed(pkg, pkg.metrics.MetricsRegistry(),
                                FakeClock(), [Broken(), Always()])
        assert [a.rule for a in engine.evaluate()] == ["always"]


# -- flight-record dump lock and cooldown ---------------------------------------


class TestFlightDumpSerialization:
    def test_same_reason_deduped_within_cooldown(self, pkg, tmp_path):
        dump = pkg.metrics.dump_flight_record
        p1 = dump(str(tmp_path), "stall-x", cooldown_s=60.0)
        before = pkg.collector.get_counters().get("flight_dumps_deduped",
                                                  reason="stall-x")
        p2 = dump(str(tmp_path), "stall-x", cooldown_s=60.0)
        assert p2 == p1
        assert pkg.collector.get_counters().get(
            "flight_dumps_deduped", reason="stall-x") == before + 1
        assert len([f for f in os.listdir(tmp_path)
                    if f.startswith("flightrec-")]) == 1
        p3 = dump(str(tmp_path), "alert-y", cooldown_s=60.0)
        assert p3 != p1
        assert len([f for f in os.listdir(tmp_path)
                    if f.startswith("flightrec-")]) == 2

    def test_cooldown_zero_keeps_legacy_always_dump(self, pkg, tmp_path):
        a = pkg.metrics.dump_flight_record(str(tmp_path), "r")
        b = pkg.metrics.dump_flight_record(str(tmp_path), "r")
        assert a != b

    def test_concurrent_watchdog_and_alert_dumps_serialized(self, pkg,
                                                            tmp_path):
        errors = []
        barrier = threading.Barrier(8)

        def dump(reason):
            try:
                barrier.wait(timeout=10)
                for _ in range(5):
                    pkg.metrics.dump_flight_record(str(tmp_path), reason,
                                                   cooldown_s=60.0)
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        threads = ([threading.Thread(target=dump, args=("stall-wd",))
                    for _ in range(4)]
                   + [threading.Thread(target=dump, args=("alert-burn",))
                      for _ in range(4)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        recs = sorted(f for f in os.listdir(tmp_path)
                      if f.startswith("flightrec-"))
        assert len(recs) == 2, recs
        for f in recs:
            doc = json.loads((tmp_path / f).read_text())
            assert doc["reason"] in ("stall-wd", "alert-burn")
        assert not [f for f in os.listdir(tmp_path)
                    if f.startswith(".flightrec-")]


# -- histogram exemplars ---------------------------------------------------------


def exposed_registry(pkg, tid="feedbeef0001", v=0.05):
    reg = pkg.metrics.MetricsRegistry()
    h = reg.histogram("serving_request_seconds",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    h.observe(v, job="j1")
    h.put_exemplar(v, tid, job="j1")
    reg.counter("serving_requests").inc(3, job="j1")
    return reg


class TestExemplars:
    def test_parse_exposition_roundtrips_exemplars(self, pkg):
        text = exposed_registry(pkg).render()
        assert ' # {trace_id="feedbeef0001"} 0.05' in text
        series = pkg.metrics.parse_exposition(text)
        assert series['edl_serving_request_seconds_count{job="j1"}'] == 1
        ex = []
        pkg.metrics.iter_samples(text, exemplars=ex)
        assert len(ex) == 1
        name, labels, ex_labels, ex_value, ts = ex[0]
        assert name == "edl_serving_request_seconds_bucket"
        assert labels["le"] == "0.1" and labels["job"] == "j1"
        assert ex_labels == {"trace_id": "feedbeef0001"}
        assert ex_value == 0.05 and ts is not None

    def test_scraper_ingests_and_fleetview_surfaces_slowest(self, pkg):
        reg = exposed_registry(pkg, tid="slowtrace001", v=0.25)
        h = reg.histogram("serving_request_seconds")
        h.observe(0.002, job="j2")
        h.put_exemplar(0.002, "fasttrace002", job="j2")
        s, clock = make_scraper(pkg, {"t1": reg.render})
        s.sweep()
        ex = s.exemplars("edl_serving_request_seconds")
        assert [e["trace_id"] for e in ex[:2]] == ["slowtrace001",
                                                   "fasttrace002"]
        view = pkg.scrape.FleetView(s)
        slow = view.slowest_exemplars(k=1)
        assert slow[0]["trace_id"] == "slowtrace001"
        assert slow[0]["family"] == "edl_serving_request_seconds"
        snap = view.snapshot()
        assert snap["jobs"]["j1"]["slowest_trace"]["trace_id"] == \
            "slowtrace001"
        assert snap["jobs"]["j1"]["slowest_trace"]["latency_ms"] == 250.0
        assert "slowtrace001" in pkg.scrape.render_fleet_dashboard(view)

    def test_exemplar_stays_fresh_while_exposed(self, pkg):
        reg = exposed_registry(pkg)
        s, clock = make_scraper(pkg, {"t1": reg.render})
        s.sweep()
        for _ in range(6):
            clock.advance(1.5)
            s.sweep()
        ex = s.exemplars("edl_serving_request_seconds", {"job": "j1"})
        assert len(ex) == 1 and ex[0]["age_s"] < s.stale_after_s

    def test_dead_target_exemplars_age_out_with_its_series(self, pkg):
        reg = exposed_registry(pkg)
        alive = [True]

        def discover():
            return ([pkg.scrape.ScrapeTarget(name="d1", addr="d1:9",
                                             source="x")]
                    if alive[0] else [])

        clock = FakeClock()
        s = pkg.scrape.MetricsScraper(
            fetch=lambda t: reg.render(), clock=clock, discover=[discover],
            interval_s=1.0, forget_after_sweeps=3,
            registry=pkg.metrics.MetricsRegistry())
        s.sweep()
        assert s.exemplars("edl_serving_request_seconds")
        alive[0] = False
        for _ in range(4):
            clock.advance(1.5)
            s.sweep()
        assert s.targets() == []
        assert s.exemplars("edl_serving_request_seconds",
                           max_age_s=float("inf")) == []

    def test_hash_inside_label_value_is_not_an_exemplar(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        reg.counter("jobs").inc(1, job="a # b")
        text = reg.render()
        assert pkg.metrics.parse_exposition(text)[
            'edl_jobs_total{job="a # b"}'] == 1
        ex = []
        pkg.metrics.iter_samples(text, exemplars=ex)
        assert ex == []
        h = reg.histogram("lat_seconds", buckets=(1.0,))
        h.observe(0.5, job="a # b")
        h.put_exemplar(0.5, "tid # x", job="a # b")
        ex = []
        pkg.metrics.iter_samples(reg.render(), exemplars=ex)
        assert len(ex) == 1
        assert ex[0][1]["job"] == "a # b"
        assert ex[0][2] == {"trace_id": "tid # x"}

    def test_expired_exemplar_stops_rendering(self, pkg):
        reg = pkg.metrics.MetricsRegistry()
        h = reg.histogram("lat_seconds", buckets=(1.0,))
        h.observe(0.5, job="j")
        h.put_exemplar(0.5, "oldtrace", job="j")
        assert "oldtrace" in reg.render()
        for ex in h._exemplars.values():
            for i, (tid, v, ts) in list(ex.items()):
                ex[i] = (tid, v, ts - h.exemplar_ttl_s - 1)
        assert "oldtrace" not in reg.render()
        assert all(not ex for ex in h._exemplars.values())


# -- a live port fleet's /metrics, scraped and fed to the SLO policy -------------


def test_live_fleet_scrape_feeds_serving_scaler():
    """A port ``ServingFleet`` of the MLP on the CPU serves its
    ``/metrics`` (address published in coordinator KV); a scraper
    discovers it through ``kv_targets``, and the ``FleetView`` it feeds
    (``ServingScaler.feed_from``) holds the fleet's own qps and p99 over
    the same window; the policy then records the fleet's capacity curve
    and, with the fleet observe-only, hints instead of actuating."""
    from edl_tpu_torch.models import mlp
    from edl_tpu_torch.observability.goodput import load_curve
    from edl_tpu_torch.runtime.serving import PoissonTraffic, ServingFleet

    job = "t/scrape-parity"
    kv = tcoord.PyCoordService()
    model = mlp.MLP([8, 16, 4], device="cpu")
    fleet = ServingFleet(lambda p, b: mlp.apply(p, b[0]), model,
                         example_row=(np.zeros((8,), np.float32),), job=job,
                         max_batch_size=4, max_queue_ms=1.0,
                         slo_p99_ms=500.0, device="cpu", kv=kv)
    scraper = tscrape.MetricsScraper(discover=[tscrape.kv_targets(kv)],
                                     interval_s=0.1, timeout_s=2.0,
                                     registry=tmetrics.MetricsRegistry())
    halt = threading.Event()
    try:
        fleet.scale_to(1)
        fleet.serve_metrics(0, replica="r0")
        view = tscrape.FleetView(scraper, window_s=2.5)
        traffic = PoissonTraffic(
            fleet, lambda i: (np.full((8,), i % 5, np.float32),), qps=120,
            seed=7)

        def sweeper():
            while not halt.wait(0.25):
                scraper.sweep()

        scraper.sweep()
        assert [t.name for t in scraper.targets()] == [f"serving/{job}/r0"]
        sw = threading.Thread(target=sweeper, daemon=True)
        sw.start()
        traffic.run(3.0)
        scraper.sweep()
        st = view.stats_for(job)
        own = fleet.stats(window_s=2.5)
        halt.set()
        sw.join(timeout=5)
        tally = traffic.await_all(timeout_s=30.0)
        assert tally["dropped"] == 0 and tally["errors"] == 0
        assert st.requests_windowed > 0 and st.replicas_active == 1
        assert own.qps > 0
        assert 0.6 * own.qps <= st.qps <= 1.4 * own.qps, (st, own)
        assert 60.0 <= st.qps <= 200.0, st
        assert st.p99_ms > 0
        assert st.p99_ms <= max(own.p99_ms * 4.0, 5.0), (st, own)
        assert own.p99_ms <= max(st.p99_ms * 4.0, 5.0), (st, own)
        # the SLO policy fed from the view: a QPS target under the
        # fleet's rate wants a second replica; observe-only, it hints
        spec = ttypes.ServingJob(name="scrape-parity", namespace="t",
                                 spec=ttypes.ServingSpec(
                                     min_replicas=1, max_replicas=4,
                                     slo_p99_ms=500.0,
                                     target_qps_per_replica=40.0))
        actuated, hints = [], []
        scaler = tauto.ServingScaler(
            actuate=lambda uid, n: actuated.append((uid, n)),
            coord_for=lambda j: kv).feed_from(view)
        scaler.hint_sink = lambda uid, n: hints.append((uid, n))
        scaler.on_add(spec)
        scaler.observe_only.add(spec.full_name)
        scaler.tick()
        assert actuated == [] and hints and hints[0][1] >= 2
        curve = load_curve(kv, job)
        assert curve is not None and curve.world_sizes() == [1]
        assert curve.tokens_per_second(1) == pytest.approx(
            st.qps, rel=0.5)
    finally:
        halt.set()
        fleet.stop()


def test_request_spans_on_a_port_fleet():
    """A traced request through a port fleet emits the span tree and the
    span histograms, as the JAX package's does."""
    from edl_tpu_torch.models import mlp
    from edl_tpu_torch.observability.tracing import get_tracer
    from edl_tpu_torch.runtime.serving import ServingFleet

    fleet = ServingFleet(lambda p, b: mlp.apply(p, b[0]),
                         mlp.MLP([8, 16, 4], device="cpu"),
                         example_row=(np.zeros((8,), np.float32),),
                         job="t/spans", max_batch_size=4, max_queue_ms=0.5,
                         slo_p99_ms=1000.0, device="cpu")
    try:
        fleet.scale_to(1)
        req = fleet.submit((np.ones((8,), np.float32),),
                           trace_id="feedbeef00000002")
        req.wait(10.0)
    finally:
        fleet.stop()
    evs = [e for e in get_tracer().events()
           if e.trace_id == "feedbeef00000002"]
    by_name = {e.name: e for e in evs}
    root = by_name["serving_request"]
    phases = {"admit", "queue", "batch", "forward", "respond"}
    for ph in phases:
        child = by_name[f"serving_request.{ph}"]
        assert child.parent_id == root.span_id
        assert child.trace_id == root.trace_id
    assert by_name["serving_request.queue"].start_s <= \
        by_name["serving_request.forward"].start_s
    series = tmetrics.parse_exposition(tmetrics.get_registry().render())
    for ph in phases:
        assert series[f'edl_serving_span_seconds_count{{phase="{ph}"}}'] >= 1
