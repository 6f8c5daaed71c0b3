"""The port's calibration plane (edl_tpu_torch/observability/calib.py, the
ledger and its coordinator half) against the JAX package's:
tests/test_calib.py's ledger, KV persistence, ``load_factors`` and
``CalibrationFactors`` scenarios over each package's ``PyCoordService``
(``pkg``), the read-back's answers required equal across the two; the
allocator's calibration source; the drift rule and dashboards over a
scraped ledger."""

import types

import pytest

from edl_tpu import coord as jcoord
from edl_tpu.coord import gc as jgc
from edl_tpu.observability import calib as jcalib
from edl_tpu.observability import goodput as jgoodput
from edl_tpu.observability import metrics as jmetrics
from edl_tpu.observability import scrape as jscrape
from edl_tpu_torch import coord as tcoord
from edl_tpu_torch.coord import gc as tgc
from edl_tpu_torch.observability import calib as tcalib
from edl_tpu_torch.observability import goodput as tgoodput
from edl_tpu_torch.observability import metrics as tmetrics
from edl_tpu_torch.observability import scrape as tscrape

PKGS = {
    "jax": types.SimpleNamespace(calib=jcalib, coord=jcoord, gc=jgc,
                                 goodput=jgoodput, metrics=jmetrics,
                                 scrape=jscrape),
    "torch": types.SimpleNamespace(calib=tcalib, coord=tcoord, gc=tgc,
                                   goodput=tgoodput, metrics=tmetrics,
                                   scrape=tscrape),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _no_process_ledger():
    """Every test starts and ends with both process ledgers disarmed."""
    for p in PKGS.values():
        p.calib.set_process_calib(None)
    yield
    for p in PKGS.values():
        p.calib.set_process_calib(None)


def both(fn):
    want, got = fn(PKGS["jax"]), fn(PKGS["torch"])
    assert got == want
    return got


def ledger(pkg, **kw):
    kw.setdefault("job", "ns/job")
    kw.setdefault("registry", pkg.metrics.MetricsRegistry())
    return pkg.calib.CalibrationLedger(**kw)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_scraper(pkg, fetch_map):
    clock = FakeClock()
    s = pkg.scrape.MetricsScraper(
        fetch=lambda t: fetch_map[t.name](), clock=clock, interval_s=1.0,
        registry=pkg.metrics.MetricsRegistry())
    for name in fetch_map:
        s.add_target(pkg.scrape.ScrapeTarget(name=name, addr=f"{name}:0"))
    return s, clock


# -- the ledger ----------------------------------------------------------------


def test_record_pairs_prediction_with_measurement(pkg):
    led = ledger(pkg)
    assert led.record("reshard_seconds", 2.0, 3.0, unit="s") == \
        pytest.approx(50.0)
    assert led.factor("reshard_seconds") == pytest.approx(1.5)
    assert led.sample_count("reshard_seconds") == 1
    led.record("reshard_seconds", 2.0, 2.0)
    assert led.factor("reshard_seconds") == pytest.approx(0.1 + 0.9 * 1.5)
    snap = led.snapshot()["predictors"]["reshard_seconds"]
    assert snap["samples"] == 2 and snap["unit"] == "s"
    assert snap["last_predicted"] == 2.0 and snap["last_measured"] == 2.0
    assert snap["error_pct_p50"] in (0.0, 50.0)
    assert led.predictors() == ["reshard_seconds"]
    assert led.factor("never_recorded") is None


def test_sample_ring_is_bounded_but_counters_are_not(pkg):
    led = ledger(pkg, ring_size=4)
    for i in range(10):
        led.record("p", 1.0, 1.0 + i)
    assert led.sample_count("p") == 10
    ring = led.samples("p")
    assert [m for _, m, _ in ring] == [7.0, 8.0, 9.0, 10.0]
    assert led.error_pct_quantile("p", 0.0) == pytest.approx(600.0)
    assert led.error_pct_quantile("p", 0.99) == pytest.approx(900.0)
    assert led.error_pct_quantile("q", 0.5) is None


def test_zero_predictions_counted_never_divided(pkg):
    led = ledger(pkg)
    for pred, meas in ((0.0, 5.0), (-1.0, 5.0), (float("nan"), 5.0),
                       (1.0, float("nan"))):
        assert led.record("p", pred, meas) is None
    assert led.factor("p") is None and led.sample_count("p") == 0
    snap = led.snapshot()["predictors"]["p"]
    assert snap["zero_predictions"] == 4 and snap["factor"] is None
    assert led.record("p", 1.0, 2.0) == pytest.approx(100.0)
    assert led.factor("p") == pytest.approx(2.0)


def test_exposition_is_strictly_parseable_with_all_series(pkg):
    reg = pkg.metrics.MetricsRegistry()
    led = ledger(pkg, registry=reg)
    led.record("reshard_seconds", 1.0, 2.0, unit="s")
    led.record("goodput_curve", 100.0, 90.0, unit="tok/s")
    led.record("goodput_curve", 0.0, 90.0)
    text = reg.render()
    names = {k.split("{", 1)[0] for k in pkg.metrics.parse_exposition(text)}
    assert {"edl_calibration_samples_total", "edl_calibration_factor",
            "edl_calibration_error_pct_bucket",
            "edl_calibration_zero_predictions_total"} <= names
    assert ('edl_calibration_factor{job="ns/job",'
            'predictor="reshard_seconds"} 2') in text
    assert ('edl_calibration_zero_predictions_total{job="ns/job",'
            'predictor="goodput_curve"} 1') in text


def test_process_ledger_helpers_are_safe_unarmed_and_armed(pkg):
    pkg.calib.record("p", 1.0, 2.0)
    assert pkg.calib.get_process_calib() is None
    led = pkg.calib.set_process_calib(ledger(pkg))
    assert pkg.calib.get_process_calib() is led
    pkg.calib.record("p", 1.0, 2.0)
    assert led.sample_count("p") == 1
    pkg.calib.record("p", "not-a-number", 2.0)
    assert led.sample_count("p") == 1


def test_nominal_transfer_seconds_prices_each_path(pkg):
    nts = pkg.calib.nominal_transfer_seconds
    assert nts(90e9) == pytest.approx(1.0)
    assert nts(0.0, 6.25e9) == pytest.approx(1.0)
    assert nts(4e9, 4e9, host=True) == pytest.approx(1.0)
    assert nts(0.0) == 0.0


def test_ledger_snapshots_equal_across_packages():
    def run(pkg):
        led = ledger(pkg, ring_size=8, ewma_alpha=0.25)
        for i in range(12):
            led.record("reshard_seconds", 1.0 + i, 1.5 + 0.7 * i, unit="s")
            led.record("goodput_curve", 100.0, 90.0 + i, unit="tok/s")
        led.record("goodput_curve", 0.0, 1.0)
        return led.snapshot()
    both(run)


# -- KV persistence, the GC sweep, read-back ---------------------------------------


def test_factor_record_roundtrip_on_py_backend(pkg):
    svc = pkg.coord.PyCoordService()
    led = ledger(pkg, coord=svc)
    led.record("reshard_seconds", 1.0, 2.0, unit="s", path="ici")
    assert svc.kv_get("calib/ns/job/reshard_seconds") is not None
    doc = pkg.calib.load_factor(svc, "ns/job", "reshard_seconds")
    assert doc["factor"] == pytest.approx(2.0)
    assert doc["n"] == 1 and doc["unit"] == "s"
    assert doc["labels"] == {"path": "ici"}
    assert pkg.calib.load_factor(svc, "ns/job", "nope") is None
    led.record("kv_move_seconds", 1.0, 1.5)
    assert set(pkg.calib.load_factors(svc, "ns/job")) == {
        "reshard_seconds", "kv_move_seconds"}
    assert pkg.calib.load_factors(svc, "other/job") == {}


def test_calib_prefix_swept_on_job_deletion(pkg):
    assert "calib/" in pkg.gc.JOB_KV_PREFIXES
    svc = pkg.coord.PyCoordService()
    doomed = ledger(pkg, job="ns/doomed", coord=svc)
    doomed.record("reshard_seconds", 1.0, 2.0)
    doomed.record("goodput_curve", 10.0, 9.0)
    ledger(pkg, job="ns/doomedx", coord=svc).record("reshard_seconds",
                                                    1.0, 2.0)
    assert pkg.gc.gc_job_kv(svc, "ns/doomed") == 2
    assert pkg.calib.load_factors(svc, "ns/doomed") == {}
    assert set(pkg.calib.load_factors(svc, "ns/doomedx")) == {
        "reshard_seconds"}


def test_factors_readback_caches_gates_and_clamps(pkg):
    svc = pkg.coord.PyCoordService()
    led = ledger(pkg, job="j", coord=svc)
    for _ in range(3):
        led.record("honest", 1.0, 3.0)
    led.record("thin", 1.0, 5.0)
    for _ in range(3):
        led.record("wild", 1.0, 1000.0)
    clock = [0.0]
    cf = pkg.calib.CalibrationFactors(svc, "j", refresh_s=10.0,
                                      clock=lambda: clock[0])
    assert cf.factor("honest") == pytest.approx(3.0)
    assert cf.scale("honest", 10.0) == pytest.approx(30.0)
    assert cf.factor("thin") == 1.0
    assert cf.factor("missing") == 1.0
    assert cf.factor("wild") == 20.0
    for _ in range(3):
        led.record("late", 1.0, 2.0)
    assert cf.factor("late") == 1.0
    clock[0] = 11.0
    assert cf.factor("late") == pytest.approx(2.0)


def test_factors_readback_neutral_on_dead_coordinator(pkg):
    class Dead:
        def kv_keys(self, prefix):
            raise ConnectionError("coordinator unreachable")

        def kv_get(self, key):
            raise ConnectionError("coordinator unreachable")

    cf = pkg.calib.CalibrationFactors(Dead(), "j")
    assert cf.factor("anything") == 1.0
    assert cf.scale("anything", 7.0) == 7.0


def test_load_factors_and_read_back_equal_across_packages():
    """One recorded history, persisted through each package's ledger into
    its own coordinator: the persisted records (the JSON documents) and
    the read-back's factors, clamps and gates are equal."""
    def run(pkg):
        svc = pkg.coord.PyCoordService()
        led = ledger(pkg, job="ns/j", coord=svc)
        for i in range(6):
            led.record("reshard_seconds", 2.0, 2.5 + i / 10, unit="s")
            led.record("kv_move_seconds", 1.0, 0.01 * (i + 1))
        led.record("serving_scale_qps", 100.0, 80.0)
        led.record("goodput_curve", 0.0, 5.0)
        docs = pkg.calib.load_factors(svc, "ns/j")
        cf = pkg.calib.CalibrationFactors(svc, "ns/j")
        return docs, {p: cf.factor(p) for p in (
            "reshard_seconds", "kv_move_seconds", "serving_scale_qps",
            "goodput_curve", "never")}
    both(run)


# -- the calibrated estimate paths ---------------------------------------------


def test_goodput_step_marginal_scales_only_the_measured_branch():
    def run(pkg):
        from edl_tpu.scheduler import planner as jplanner
        from edl_tpu_torch.scheduler import planner as tplanner

        planner = jplanner if pkg is PKGS["jax"] else tplanner
        c = pkg.goodput.ScalingCurve()
        c.observe(2, 100.0)
        c.observe(4, 180.0)
        sm = planner._step_marginal
        got = [sm(c, 4, 1, 0.0), sm(c, 4, 1, 0.0, calib_factor=0.5),
               sm(None, 4, 1, 123.0, calib_factor=0.5),
               sm(pkg.goodput.ScalingCurve(), 4, 1, 77.0, calib_factor=0.5)]
        assert got == [pytest.approx(40.0), pytest.approx(20.0), 123.0, 77.0]
        return got
    both(run)


def test_goodput_allocator_threads_the_calibration_factor():
    """The allocator prices measured steps by the persisted
    ``goodput_curve`` factor (a CalibrationFactors over the coordinator,
    or a plain callable), and a raising or non-positive source is
    neutral — in both packages alike."""
    from test_torch_sched_goodput import JAX, TORCH

    def run(p):
        pk = PKGS["jax" if p is JAX else "torch"]
        cv = p.curves_for({"default/a": {1: 100.0, 2: 200.0, 4: 400.0}})

        def plan(calibration=None):
            return p.planner.scale_all_jobs_goodput(
                [p.priced("a", 1, 0, 4, 0)], p.one_domain(1, 4), 1.0,
                curves=cv, calibration=calibration)

        svc = pk.coord.PyCoordService()
        led = ledger(pk, job="default/a", coord=svc)
        for _ in range(4):
            led.record("goodput_curve", 100.0, 50.0)
        factors = pk.calib.CalibrationFactors(svc, "default/a")

        def broken(_):
            raise RuntimeError("kv down")

        base = plan()
        out = [plan(c) for c in (lambda _: 0.5, factors, broken,
                                 lambda _: 0.0)]
        assert base.marginals["default/a"] == pytest.approx(100.0)
        assert [o.diff for o in out] == [base.diff] * 4
        assert [o.marginals["default/a"] for o in out] == [
            pytest.approx(50.0), pytest.approx(50.0), pytest.approx(100.0),
            pytest.approx(100.0)]
        return [(o.diff, o.marginals) for o in [base] + out]
    assert run(TORCH) == run(JAX)


def test_curve_store_records_goodput_curve_predictor(pkg):
    led = pkg.calib.set_process_calib(ledger(pkg, job="g/job"))
    store = pkg.goodput.CurveStore(pkg.coord.PyCoordService(), "g/job",
                                   registry=pkg.metrics.MetricsRegistry())
    store.record(4, 1000.0)
    assert led.sample_count("goodput_curve") == 0
    store.record(4, 900.0)
    assert led.sample_count("goodput_curve") == 1
    pred, measured, err = led.samples("goodput_curve")[0]
    assert (pred, measured) == (1000.0, 900.0)
    assert err == pytest.approx(10.0)


# -- the scraped view: summary, drift rule, dashboards ----------------------------


def scraped_ledger_view(pkg):
    reg = pkg.metrics.MetricsRegistry()
    led = pkg.calib.CalibrationLedger(job="j", registry=reg)
    s, clock = make_scraper(pkg, {"t": reg.render})
    s.sweep()
    clock.advance(1.0)
    led.record("reshard_seconds", 1.0, 1.5, unit="s")
    led.record("goodput_curve", 100.0, 95.0, unit="tok/s")
    s.sweep()
    return pkg.scrape.FleetView(s, window_s=10.0), led, s, clock


def test_fleetview_calibration_summary_rolls_up_per_predictor(pkg):
    view, led, _, _ = scraped_ledger_view(pkg)
    summary = view.calibration_summary()
    assert set(summary) == {"j"}
    assert set(summary["j"]) == {"reshard_seconds", "goodput_curve"}
    rs = summary["j"]["reshard_seconds"]
    assert rs["factor"] == pytest.approx(1.5)
    assert rs["samples"] == 1
    assert rs["error_pct_p50"] is not None
    assert view.snapshot()["calibration"]["j"]["goodput_curve"][
        "factor"] == pytest.approx(0.95)


def test_calibration_drift_rule_fires_after_consecutive_windows(pkg):
    reg = pkg.metrics.MetricsRegistry()
    g = reg.gauge("calibration_factor")
    g.set(5.0, job="j", predictor="p")
    reg.counter("calibration_samples").inc(10, job="j", predictor="p")
    s, clock = make_scraper(pkg, {"t": reg.render})
    s.sweep()
    engine = pkg.scrape.AlertEngine(
        pkg.scrape.FleetView(s, window_s=10.0),
        rules=[pkg.scrape.CalibrationDriftRule(windows=3)],
        registry=pkg.metrics.MetricsRegistry())
    engine.evaluate()
    engine.evaluate()
    assert engine.firing() == []
    engine.evaluate()
    firing = engine.firing()
    assert [a.rule for a in firing] == ["calibration_drift"]
    assert firing[0].labels == {"job": "j", "predictor": "p"}
    g.set(1.2, job="j", predictor="p")
    clock.advance(1.0)
    s.sweep()
    engine.evaluate()
    assert engine.firing() == []


def test_calibration_drift_needs_min_samples(pkg):
    reg = pkg.metrics.MetricsRegistry()
    reg.gauge("calibration_factor").set(9.0, job="j", predictor="p")
    reg.counter("calibration_samples").inc(2, job="j", predictor="p")
    s, _ = make_scraper(pkg, {"t": reg.render})
    s.sweep()
    engine = pkg.scrape.AlertEngine(
        pkg.scrape.FleetView(s),
        rules=[pkg.scrape.CalibrationDriftRule(windows=1, min_samples=3)],
        registry=pkg.metrics.MetricsRegistry())
    engine.evaluate()
    assert engine.firing() == []


def test_drift_rule_ships_in_default_rules(pkg):
    assert any(isinstance(r, pkg.scrape.CalibrationDriftRule)
               for r in pkg.scrape.default_rules())


def test_calib_dashboard_renders_factors_and_drift(pkg):
    view, _, s, clock = scraped_ledger_view(pkg)
    engine = pkg.scrape.AlertEngine(
        view, rules=[pkg.scrape.CalibrationDriftRule(windows=1)],
        registry=pkg.metrics.MetricsRegistry())
    engine.evaluate()
    out = pkg.scrape.render_calib_dashboard(view, engine)
    assert "reshard_seconds" in out and "goodput_curve" in out
    assert "1.5" in out and "ok" in out
    assert "DRIFT: none firing" in out
    assert "CALIBRATION" in pkg.scrape.render_fleet_dashboard(view, engine)
    reg2 = pkg.metrics.MetricsRegistry()
    led2 = pkg.calib.CalibrationLedger(job="j2", registry=reg2)
    for _ in range(3):
        led2.record("kv_move_seconds", 1.0, 10.0)
    s2, _ = make_scraper(pkg, {"t": reg2.render})
    s2.sweep()
    view2 = pkg.scrape.FleetView(s2)
    engine2 = pkg.scrape.AlertEngine(
        view2, rules=[pkg.scrape.CalibrationDriftRule(windows=1)],
        registry=pkg.metrics.MetricsRegistry())
    engine2.evaluate()
    out2 = pkg.scrape.render_calib_dashboard(view2, engine2)
    assert "CALIBRATION DRIFT FIRING (1)" in out2
    assert "kv_move_seconds" in out2


def test_calib_dashboard_empty_view_degrades_gracefully(pkg):
    reg = pkg.metrics.MetricsRegistry()
    s, _ = make_scraper(pkg, {"t": reg.render})
    s.sweep()
    assert "no calibration series scraped" in \
        pkg.scrape.render_calib_dashboard(pkg.scrape.FleetView(s))
