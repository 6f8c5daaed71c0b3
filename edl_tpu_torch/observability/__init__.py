"""Observability: structured logging, the metrics plane (registry +
Prometheus /metrics and its strict parser), correlated span tracing and
its loaders, the flight recorder, the goodput ledger and scaling curves,
the calibration plane, the cluster collector, and the scrape plane that
consumes every /metrics — the port's copy of edl_tpu.observability."""

from edl_tpu_torch.observability.calib import (
    CalibrationFactors, CalibrationLedger, get_process_calib,
    load_factor, load_factors, set_process_calib,
)
from edl_tpu_torch.observability.collector import (
    Collector, Counters, JobInfo, Sample, get_counters,
)
from edl_tpu_torch.observability.goodput import (
    CurveStore, GoodputLedger, ScalingCurve, get_process_ledger,
    load_curve, set_process_ledger,
)
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import (
    Counter, ExpositionError, Gauge, Histogram, MetricsRegistry,
    dump_flight_record, get_registry, iter_samples, parse_exposition,
)
from edl_tpu_torch.observability.scrape import (
    AlertEngine, AlertRule, BurnRateRule, CalibrationDriftRule,
    ConservationRule, FleetView, GoodputCollapseRule, MetricsScraper,
    ScrapeTarget, TargetDownRule, render_calib_dashboard,
    render_fleet_dashboard,
)
from edl_tpu_torch.observability.tracing import (
    Tracer, build_span_forest, current_trace_id, discover_trace_files,
    get_tracer, load_trace_events, new_trace_id, render_trace_tree,
    set_trace_id,
)

__all__ = ["AlertEngine", "AlertRule", "BurnRateRule",
           "CalibrationDriftRule", "CalibrationFactors",
           "CalibrationLedger", "Collector",
           "ConservationRule", "Counter", "Counters", "CurveStore",
           "ExpositionError", "FleetView", "Gauge", "GoodputCollapseRule",
           "GoodputLedger", "Histogram", "JobInfo", "MetricsRegistry",
           "MetricsScraper", "Sample", "ScalingCurve", "ScrapeTarget",
           "TargetDownRule", "Tracer", "build_span_forest",
           "current_trace_id", "discover_trace_files",
           "dump_flight_record", "get_counters", "get_logger",
           "get_process_calib", "get_process_ledger", "get_registry",
           "get_tracer", "iter_samples", "load_curve", "load_factor",
           "load_factors", "load_trace_events", "new_trace_id",
           "parse_exposition", "render_calib_dashboard",
           "render_fleet_dashboard", "render_trace_tree",
           "set_process_calib", "set_process_ledger", "set_trace_id"]
