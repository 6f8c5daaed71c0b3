"""Cluster metrics collector, and the process's labeled monotonic
counters (``resizes_failed``, ...) — the port's copy of
edl_tpu.observability.collector.

The :class:`Collector` is the port of the reference's metrics collector
(reference example/collector.py:20-226): poll the cluster on a fixed
cadence (10 s, collector.py:226), classify every job's pods by role and
phase (collector.py:95-118), and emit one TSV line per sample with the
reference's metric columns (collector.py:215-226):

  * ``SUBMITTED-JOBS``   — jobs with any pod present (collector.py:194)
  * ``PENDING-JOBS``     — jobs whose master/pserver is pending, or whose
    trainers are absent or all pending (collector.py:194-202)
  * ``RUNNING-TRAINERS`` — ``job:count|job:count`` (collector.py:137-154)
  * ``CPU-UTILS`` / ``GPU-UTILS`` — Σ running-pod requests (card limits
    for the accelerator) over allocatable (collector.py:156-179).

Works over any backend exposing ``inquiry_resource()`` and ``list_pods()``
(the :class:`~edl_tpu_torch.cluster.fake.FakeCluster` contract);
utilization is computed from the Running pods directly, as the reference
does.  Every column is also a gauge of the process registry
(``edl_cluster_*``).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Callable, TextIO

from edl_tpu_torch.cluster.base import PodPhase
from edl_tpu_torch.observability.metrics import MetricsRegistry, get_registry

#: Reference sampling cadence (example/collector.py:226).
DEFAULT_INTERVAL_S = 10.0

_HEADER = ("TIMESTAMP", "SUBMITTED-JOBS", "PENDING-JOBS",
           "RUNNING-TRAINERS", "CPU-UTILS", "GPU-UTILS")


@dataclass
class JobInfo:
    """Per-job pod phase lists — reference example/collector.py:95-118."""

    name: str
    masters: list[PodPhase] = field(default_factory=list)
    pservers: list[PodPhase] = field(default_factory=list)
    trainers: list[PodPhase] = field(default_factory=list)

    def running_trainers(self) -> int:
        return sum(1 for p in self.trainers if p == PodPhase.RUNNING)

    def pending(self) -> bool:
        """Reference pending rule (example/collector.py:194-202): the job
        counts as pending if any master/pserver pod is pending, or it has
        no trainer pods yet, or every trainer pod is pending."""
        if any(p == PodPhase.PENDING for p in self.masters + self.pservers):
            return True
        if not self.trainers:
            return True
        return all(p == PodPhase.PENDING for p in self.trainers)


@dataclass(frozen=True)
class Sample:
    """One collector sample = one TSV line."""

    timestamp: float
    submitted_jobs: int
    pending_jobs: int
    running_trainers: dict[str, int]
    cpu_utils_pct: float
    gpu_utils_pct: float

    def tsv(self) -> str:
        trainers = "|".join(
            f"{name}:{n}" for name, n in sorted(self.running_trainers.items()))
        return "\t".join([
            time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(self.timestamp)),
            str(self.submitted_jobs),
            str(self.pending_jobs),
            trainers or "-",
            f"{self.cpu_utils_pct:.2f}",
            f"{self.gpu_utils_pct:.2f}",
        ])


class Counters:
    """``inc("name", type="x")`` and ``get("name", type="x")`` agree: the
    labels are folded into the key in sorted order.  A facade over a
    :class:`MetricsRegistry`: the process-wide instance is backed by
    ``metrics.get_registry()``, so every count renders as
    ``edl_<name>_total{labels}``; a standalone ``Counters()`` gets a
    private registry."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self._registry = registry if registry is not None \
            else MetricsRegistry()

    def inc(self, name: str, n: int = 1, **labels: str) -> int:
        return int(self._registry.counter(name).inc(n, **labels))

    def get(self, name: str, **labels: str) -> int:
        return int(self._registry.counter(name).value(**labels))

    def total(self, name: str) -> int:
        """Sum over every label combination of ``name``."""
        return int(sum(self._registry.counter(name).series().values()))

    def snapshot(self) -> dict[str, int]:
        """Flat ``name{k=v,...}`` → count view of every counter that has
        counted (flight records, tests)."""
        out: dict[str, int] = {}
        for name, fam in sorted(self._registry.counter_families().items()):
            for labels, v in fam.series().items():
                key = name if not labels else name + "{" + ",".join(
                    f"{k}={val}" for k, val in labels) + "}"
                out[key] = int(v)
        return out


_default_counters = Counters(get_registry())


def get_counters() -> Counters:
    """The process-wide counters."""
    return _default_counters


class Collector:
    """Polling metrics collector (reference example/collector.py `Collector`)."""

    def __init__(self, cluster, interval_s: float = DEFAULT_INTERVAL_S,
                 out: TextIO | None = None,
                 clock: Callable[[], float] = time.time,
                 registry: MetricsRegistry | None = None) -> None:
        self._cluster = cluster
        self._interval_s = interval_s
        self._out = out  # None = current sys.stdout at write time
        self._clock = clock
        self._header_written = False
        #: every TSV column doubles as a gauge (edl_cluster_* series)
        self._registry = registry if registry is not None else get_registry()

    # -- classification (reference collector.py:95-118) --------------------

    def job_infos(self, pods=None) -> dict[str, JobInfo]:
        if pods is None:
            pods = self._cluster.list_pods()
        infos: dict[str, JobInfo] = {}
        for pod in pods:
            if not pod.job_uid:  # system pods carry no job label
                continue
            info = infos.setdefault(pod.job_uid, JobInfo(pod.job_uid))
            bucket = {"master": info.masters, "pserver": info.pservers,
                      "trainer": info.trainers}.get(pod.role)
            if bucket is None:
                continue
            phase = (PodPhase.TERMINATING if pod.deletion_timestamp
                     else pod.phase)
            bucket.append(phase)
        return infos

    # -- one sample (reference collector.py:120-213) ------------------------

    def run_once(self) -> Sample:
        r = self._cluster.inquiry_resource()
        pods = self._cluster.list_pods()  # one LIST serves both aggregates
        infos = self.job_infos(pods)

        cpu_running = 0
        gpus_running = 0
        for pod in pods:
            if pod.phase != PodPhase.RUNNING:
                continue  # only Running pods count (collector.py:156-179)
            cpu_running += pod.cpu_request_milli
            gpus_running += pod.gpu_limit

        sample = Sample(
            timestamp=self._clock(),
            submitted_jobs=len(infos),
            pending_jobs=sum(1 for i in infos.values() if i.pending()),
            running_trainers={n: i.running_trainers() for n, i in infos.items()},
            cpu_utils_pct=(100.0 * cpu_running / r.cpu_total_milli
                           if r.cpu_total_milli else 0.0),
            gpu_utils_pct=(100.0 * gpus_running / r.gpu_total
                           if r.gpu_total else 0.0),
        )
        self._write(sample)
        self._export(sample)
        return sample

    def _export(self, s: Sample) -> None:
        """Mirror the sample into the registry, so a /metrics route serves
        the same truth as the TSV."""
        r = self._registry
        r.gauge("cluster_submitted_jobs",
                help="jobs with any pod present").set(s.submitted_jobs)
        r.gauge("cluster_pending_jobs",
                help="jobs pending by the reference rule").set(s.pending_jobs)
        r.gauge("cluster_cpu_utils_pct",
                help="running-pod CPU requests over allocatable"
                ).set(s.cpu_utils_pct)
        r.gauge("cluster_gpu_utils_pct",
                help="running-pod card limits over allocatable"
                ).set(s.gpu_utils_pct)
        g = r.gauge("cluster_running_trainers",
                    help="running trainer pods per job")
        # prune series for jobs that left the cluster FIRST — a deleted
        # job must disappear from /metrics, not freeze at its last count
        for labels in g.label_sets():
            if labels.get("job") not in s.running_trainers:
                g.remove(**labels)
        for job, n in s.running_trainers.items():
            g.set(n, job=job)
        r.counter("collector_samples",
                  help="collector samples taken").inc()

    def run(self, max_samples: int | None = None) -> None:
        """Poll forever (reference collector.py:215-226); ``max_samples``
        bounds the loop."""
        n = 0
        while max_samples is None or n < max_samples:
            if n:
                time.sleep(self._interval_s)
            self.run_once()
            n += 1

    def _write(self, sample: Sample) -> None:
        out = self._out if self._out is not None else sys.stdout
        if not self._header_written:
            print("\t".join(_HEADER), file=out)
            self._header_written = True
        print(sample.tsv(), file=out, flush=True)
