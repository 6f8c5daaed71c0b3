"""Job-scoped coordinator-KV garbage collection — the port's copy of
edl_tpu.coord.gc.

Several subsystems persist PER-JOB state in coordinator KV so it rides
HA replication: the goodput scaling curve (``goodput-curve/<job>``,
observability/goodput.py), the virtual-worker ownership map and
consumed-offset cursors (``vw-map/<job>`` / ``vw-cursor/<job>``,
runtime/virtual.py), and the serving fleet's weight generation
(``serving-gen/<job>``, runtime/serving.py).  None of these are
per-generation, so ``prune_generations`` (which sweeps ``trace/`` and
checkpoint pointers by epoch) deliberately never touches them — they
must survive every reform and failover for the job's whole life.

They must NOT survive the job: on a shared coordinator (the local
harness, multi-job deployments, tests) a deleted job's keys would
otherwise accumulate forever, and a RESUBMITTED job under the same name
would inherit a dead job's scaling curve and cursors.  The controller
sweeps them at job deletion (``Controller(coord_for=...)``,
edl_tpu_torch.controller.controller).
"""

from __future__ import annotations

from edl_tpu_torch.observability.logging import get_logger

log = get_logger("coord.gc")

#: every KV prefix that scopes per-JOB (not per-generation) state; a
#: subsystem adding a new per-job key family appends its prefix here so
#: deletion keeps sweeping it (tests/test_serving.py pins the sweep)
JOB_KV_PREFIXES = (
    "goodput-curve/",
    "vw-map/",
    "vw-cursor/",
    "serving-gen/",
    # serving replicas' published /metrics addresses (TTL'd values —
    # observability/scrape.py stamps an expiry the scraper honors — but
    # the keys themselves only leave KV here or via AddrPublisher.stop)
    "serving-metrics-addr/",
    # the DATA-plane address + ready-gate keys the LB tier discovers
    # replicas through (runtime/frontdoor.py _StatePublisher)
    "serving-addr/",
    # per-(step, worker) update fingerprints the SDC defense plane
    # cross-checks (runtime/sdc.py); quarantine markers are per-WORKER
    # like evict/ and deliberately not swept with the job
    "sdc-fp/",
    # per-predictor calibration factors (``calib/<job>/<predictor>``,
    # observability/calib.py) — a resubmitted job must re-measure, not
    # inherit a dead job's corrections
    "calib/",
)


def gc_job_kv(coord, job: str) -> int:
    """Delete every job-scoped KV key of ``job`` (its ``namespace/name``
    uid, or whatever job string the writers used); returns how many keys
    were removed.  Exact-key and sub-key (``prefix + job + "/..."``)
    forms are both swept; other jobs' keys are untouched.  Best-effort
    per key — a racing delete is a no-op, not an error."""
    removed = 0
    for prefix in JOB_KV_PREFIXES:
        scoped = prefix + job
        try:
            keys = [k for k in coord.kv_keys(scoped)
                    if k == scoped or k.startswith(scoped + "/")]
        except Exception as exc:  # an unreachable coordinator: log, move on
            log.warn("job KV sweep list failed", job=job, prefix=prefix,
                     error=str(exc)[:120])
            continue
        for key in keys:
            try:
                if coord.kv_del(key):
                    removed += 1
            except Exception as exc:
                log.warn("job KV sweep delete failed", job=job, key=key,
                         error=str(exc)[:120])
    if removed:
        log.info("job-scoped coordinator KV swept", job=job, keys=removed)
        from edl_tpu_torch.observability.collector import get_counters

        get_counters().inc("job_kv_swept", removed)
    return removed
