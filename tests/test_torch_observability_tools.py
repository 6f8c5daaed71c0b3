"""The port's trace loaders (edl_tpu_torch/observability/tracing.py:
``Tracer.merge_files``, ``load_trace_events``, ``build_span_forest``,
``render_trace_tree``, ``discover_trace_files``) and cluster ``Collector``
(observability/collector.py) against the JAX package's: the same dumps and
flight records read by both packages give equal events, forests, trees
and merges; the same pods on both packages' fake clusters give equal
samples and TSV lines, the port's accelerator column being ``GPU-UTILS``
where the reference's is ``CHIP-UTILS``."""

import io
import json
import os
import time

import pytest

from edl_tpu.api import types as jtypes
from edl_tpu.cluster.fake import FakeCluster as JaxCluster
from edl_tpu.observability import collector as jcollector
from edl_tpu.observability import metrics as jmetrics
from edl_tpu.observability import tracing as jtracing
from edl_tpu_torch.api import types as ttypes
from edl_tpu_torch.cluster.fake import FakeCluster as TorchCluster
from edl_tpu_torch.observability import collector as tcollector
from edl_tpu_torch.observability import metrics as tmetrics
from edl_tpu_torch.observability import tracing as ttracing

LOADERS = {"jax": jtracing, "torch": ttracing}


def two_process_trace(tracing, tmp_path, tid):
    """The LB and one replica recording one hedged request, each into its
    own tracer, dumped as two processes' files (tests/test_trace_cli.py's
    fixture)."""
    lb, fd = tracing.Tracer(), tracing.Tracer()
    root = lb.record_span("lb_request", "lb", 0.000, 0.050, trace_id=tid,
                          n=4, origin="head", outcome="served", hedged=True)
    lb.record_span("lb.route", "lb", 0.000, 0.001, trace_id=tid,
                   parent_id=root)
    lb.record_span("lb.upstream", "lb", 0.001, 0.048, trace_id=tid,
                   parent_id=root, replica="r0", kind="primary",
                   outcome="discarded")
    lb.record_span("lb.upstream", "lb", 0.020, 0.024, trace_id=tid,
                   parent_id=root, replica="r1", kind="hedge", outcome="win")
    door = fd.record_span("frontdoor_request", "frontdoor", 0.021, 0.024,
                          trace_id=tid, parent_id=root, replica="r1", rows=4)
    fd.record_span("frontdoor.forward", "frontdoor", 0.022, 0.0235,
                   trace_id=tid, parent_id=door)
    lb.instant("lb_shed_marker", category="lb")
    lb.dump(str(tmp_path / "trace-lb-1.json"), "lb-1")
    fd.dump(str(tmp_path / "trace-fd-r1.json"), "fd-r1")


def read_back(tracing, directory, tid):
    files = tracing.discover_trace_files(str(directory))
    events = tracing.load_trace_events(files, tid)
    return ([os.path.basename(f) for f in files], events,
            tracing.build_span_forest(events),
            tracing.render_trace_tree(events, tid))


@pytest.mark.parametrize("writer", sorted(LOADERS))
def test_loaders_read_either_packages_dumps_alike(writer, tmp_path):
    tid = jtracing.new_trace_id()
    two_process_trace(LOADERS[writer], tmp_path, tid)
    got = {name: read_back(t, tmp_path, tid) for name, t in LOADERS.items()}
    assert got["torch"] == got["jax"]
    files, events, roots, txt = got["torch"]
    assert len(files) == 2 and len(events) == 6
    assert {e["proc"] for e in events} == {"lb-1", "fd-r1"}
    assert len(roots) == 1 and roots[0]["name"] == "lb_request"
    assert [c["name"] for c in roots[0]["children"]] == [
        "lb.route", "lb.upstream", "lb.upstream", "frontdoor_request"]
    assert "2 processes" in txt and "frontdoor.forward" in txt
    assert "outcome=discarded" in txt and "outcome=win" in txt


@pytest.mark.parametrize("writer", sorted(LOADERS))
def test_flight_records_are_trace_sources_and_dedupe(writer, tmp_path):
    """A flight record embeds the ring with its wall anchor; the same ring
    dumped as a trace file and a flight record dedupes by span id."""
    tracing = LOADERS[writer]
    metrics = jmetrics if writer == "jax" else tmetrics
    tid = jtracing.new_trace_id()
    t = tracing.Tracer()
    root = t.record_span("lb_request", "lb", 0.0, 0.05, trace_id=tid,
                         origin="rescue")
    t.record_span("lb.upstream", "lb", 0.001, 0.049, trace_id=tid,
                  parent_id=root, kind="primary", outcome="win")
    t.dump(str(tmp_path / "trace-lb.json"), "lb-1")
    path = metrics.dump_flight_record(str(tmp_path), "loop-lag-lb",
                                      tracer=t)
    assert path in tracing.discover_trace_files(str(tmp_path))
    got = {}
    for name, loader in LOADERS.items():
        files = loader.discover_trace_files(str(tmp_path))
        only_rec = loader.load_trace_events([path], tid)
        events = loader.load_trace_events(files, tid)
        got[name] = (only_rec, events, loader.render_trace_tree(events, tid))
    assert got["torch"] == got["jax"]
    only_rec, events, txt = got["torch"]
    assert [e["name"] for e in only_rec] == ["lb_request", "lb.upstream"]
    assert only_rec[0]["args"]["origin"] == "rescue"
    assert len(events) == 2 and "2 spans" in txt


def test_orphans_foreign_files_and_filters_alike(tmp_path):
    tid = jtracing.new_trace_id()
    t = ttracing.Tracer()
    t.record_span("frontdoor_request", "frontdoor", 0.0, 0.01, trace_id=tid,
                  parent_id="missing-span-id")
    t.record_span("other", "x", 0.0, 0.01, trace_id="another")
    t.dump(str(tmp_path / "trace-orphan.json"), "fd")
    (tmp_path / "trace-foreign.json").write_text(json.dumps({
        "traceEvents": [{"name": "ext_span", "cat": "x", "ph": "X",
                         "ts": 1000.0, "dur": 500.0, "pid": 0, "tid": 0,
                         "args": {"trace_id": tid, "span_id": "e1"}}]}))
    (tmp_path / "trace-torn.json").write_text("{not json")
    (tmp_path / "unrelated.json").write_text("{}")

    def run(loader):
        files = loader.discover_trace_files(str(tmp_path))
        events = loader.load_trace_events(files, tid)
        return (events, [r["name"] for r in loader.build_span_forest(events)],
                loader.render_trace_tree(events, tid),
                loader.render_trace_tree(events, "nope"),
                len(loader.load_trace_events(files)))
    want, got = run(jtracing), run(ttracing)
    assert got == want
    events, roots, txt, missing, everything = got
    assert sorted(roots) == ["ext_span", "frontdoor_request"]
    assert missing == "trace not found" and everything == 3
    ext = next(e for e in events if e["name"] == "ext_span")
    assert ext["ts_s"] == 0.001 and ext["dur_s"] == 0.0005


def test_merge_files_equal_and_aligned(tmp_path):
    """Two processes' dumps and an anchorless one merged by each package:
    the same document; every file a pid row, the anchored ones on one
    wall axis, the anchorless one at its raw timestamps."""
    a, b = ttracing.Tracer(), ttracing.Tracer()
    tid = ttracing.new_trace_id()
    root = a.record_span("reform", "reform", 0.0, 0.2, trace_id=tid)
    b.record_span("world_start.restore", "reform",
                  b.from_wall(time.time() - 0.2), b.from_wall(time.time()),
                  trace_id=tid, parent_id=root)
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    a.dump(pa, process_name="supervisor")
    b.dump(pb, process_name="child")
    pc = tmp_path / "legacy.json"
    pc.write_text(json.dumps({"traceEvents": [{
        "name": "legacy_event", "cat": "x", "ph": "i", "ts": 123.0,
        "dur": 0.0, "pid": 0, "tid": 0, "args": {}}]}))
    paths = [pa, pb, str(pc), str(tmp_path / "missing.json")]
    got = ttracing.Tracer.merge_files(paths, str(tmp_path / "merged.json"))
    assert got == jtracing.Tracer.merge_files(paths)
    assert json.loads((tmp_path / "merged.json").read_text()) == got
    slices = [e for e in got["traceEvents"] if e.get("ph") == "X"]
    assert {e["pid"] for e in slices} == {0, 1}
    child = next(e for e in slices if e["name"] == "world_start.restore")
    assert child["args"]["parent_id"] == root
    assert got["edl"]["merged_from"] == ["supervisor", "child",
                                         "legacy.json"]
    legacy = next(e for e in got["traceEvents"]
                  if e["name"] == "legacy_event")
    assert legacy["ts"] == 123.0


# -- the Collector ---------------------------------------------------------------


class Side:
    """One package's cluster, jobs and collector, from one description:
    TPU chips on the JAX side, GPU cards on the port's."""

    def __init__(self, jax: bool) -> None:
        self.jax = jax
        self.t = jtypes if jax else ttypes
        self.collector = jcollector if jax else tcollector
        self.metrics = jmetrics if jax else tmetrics
        self.key = jtypes.RESOURCE_TPU if jax else ttypes.RESOURCE_GPU

    def cluster(self, nodes=4, per_node=4):
        c = JaxCluster() if self.jax else TorchCluster()
        for i in range(nodes):
            if self.jax:
                c.add_node(f"n{i}", cpu_milli=16000, memory_mega=64000,
                           tpu_chips=per_node, ici_domain="pod0")
            else:
                c.add_node(f"n{i}", cpu_milli=16000, memory_mega=64000,
                           gpus=per_node, nvlink_domain="pod0")
        return c

    def job(self, name, acc=1, lo=2, hi=4):
        t = self.t
        return t.TrainingJob(name=name, spec=t.TrainingJobSpec(
            fault_tolerant=True, trainer=t.TrainerSpec(
                min_instance=lo, max_instance=hi,
                resources=t.ResourceRequirements(
                    requests={"cpu": "1", "memory": "1G"},
                    limits={"cpu": "1", "memory": "1G",
                            self.key: str(acc)}))))

    def sample(self, s) -> dict:
        """A sample in package-neutral form."""
        return dict(timestamp=s.timestamp, submitted=s.submitted_jobs,
                    pending=s.pending_jobs, trainers=s.running_trainers,
                    cpu=s.cpu_utils_pct,
                    acc=s.chip_utils_pct if self.jax else s.gpu_utils_pct)


SIDES = (Side(True), Side(False))


def collect(side: Side, scenario) -> tuple:
    """Run ``scenario(side, cluster)`` (which builds pods), then one
    collector sample at a fixed clock: (sample, TSV text with the
    accelerator column named alike, the registry's cluster gauges)."""
    c = scenario(side)
    out = io.StringIO()
    reg = side.metrics.MetricsRegistry()
    col = side.collector.Collector(c, out=out, clock=lambda: 1.7e9,
                                   registry=reg)
    s = col.run_once()
    text = out.getvalue().replace("CHIP-UTILS", "GPU-UTILS")
    gauges = {k.replace("chip_utils", "gpu_utils"): v for k, v in
              side.metrics.parse_exposition(reg.render()).items()
              if k.startswith("edl_cluster_")}
    return side.sample(s), text, gauges


def empty(side):
    return side.cluster()


def running(side):
    c = side.cluster()
    c.create_resources(side.job("j1", acc=1))
    c.create_resources(side.job("j2", acc=2, lo=3, hi=3))
    c.reconcile()
    return c


def pending(side):
    c = side.cluster(per_node=0)
    c.create_resources(side.job("big", acc=8, lo=2, hi=2))
    c.reconcile()
    return c


def mixed(side):
    """A running job, a killed trainer, a deleted job and a system pod."""
    c = side.cluster(nodes=2)
    a, b = side.job("a", acc=2), side.job("b", acc=1, lo=1, hi=1)
    c.create_resources(a)
    c.create_resources(b)
    c.reconcile()
    c.kill_pod(c.list_pods(job_uid=a.full_name, role="trainer")[0].name)
    c.delete_resources(b)
    c.reconcile()
    c.add_system_pod("hold", "n1", cpu_request_milli=2000)
    return c


@pytest.mark.parametrize("scenario", [empty, running, pending, mixed])
def test_collector_sample_and_tsv_equal_the_reference(scenario):
    want, got = (collect(side, scenario) for side in SIDES)
    assert got == want
    sample, text, gauges = got
    header, line = text.strip().split("\n")
    assert header.split("\t") == ["TIMESTAMP", "SUBMITTED-JOBS",
                                  "PENDING-JOBS", "RUNNING-TRAINERS",
                                  "CPU-UTILS", "GPU-UTILS"]
    assert len(line.split("\t")) == 6
    if scenario is running:
        assert sample["trainers"] == {"default/j1": 2, "default/j2": 3}
        assert sample["acc"] == pytest.approx(100.0 * 8 / 16)
    if scenario is pending:
        assert sample["pending"] == 1
        assert sample["trainers"] == {"default/big": 0}


def test_collector_run_bounded_and_prunes_deleted_jobs():
    for side in SIDES:
        out = io.StringIO()
        side.collector.Collector(side.cluster(), interval_s=0.0,
                                 out=out).run(max_samples=3)
        assert len(out.getvalue().strip().split("\n")) == 4
        reg = side.metrics.MetricsRegistry()
        c = side.cluster()
        job = side.job("ephemeral")
        c.create_resources(job)
        c.reconcile()
        col = side.collector.Collector(c, out=io.StringIO(), registry=reg)
        col.run_once()
        g = reg.gauge("cluster_running_trainers")
        assert g.value(job="default/ephemeral") == 2
        c.delete_resources(job)
        c.reconcile()
        col.run_once()
        assert 'job="default/ephemeral"' not in reg.render()
        assert reg.gauge("cluster_submitted_jobs").value() == 0
