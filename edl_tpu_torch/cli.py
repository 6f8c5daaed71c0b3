"""``python -m edl_tpu_torch.cli`` — the operator CLI; the port's copy of
edl_tpu.cli, every verb and flag of it, over the port's modules.

Role of the reference's ``edl`` binary (reference cmd/edl/edl.go:16-51):
parse flags, build the cluster backend, construct the controller, run
forever.  The reference's three flags survive verbatim
(``--kubeconfig``, ``--log-level``, ``--max-load-desired``,
edl.go:17-20); further verbs cover the rest of the reference's operator
surface:

  controller    run the control plane (controller + autoscaler loop)
  collector     cluster metrics TSV (role of example/collector.py)
  coordinator   run the coordination server (role of the Go master+etcd)
  launch        pod-role entrypoint dispatch (role of docker/paddle_k8s)
  submit        submit a TrainingJob manifest
  delete        delete a job (role of example/del_jobs.sh for one job)
  status        per-role / per-pod job status (the CRD status detail,
                pkg/apis/paddlepaddle/v1/types.go:154-162)
  list          all TrainingJobs with recorded phases (`kubectl get tj`)
  validate      parse+default+validate a manifest, print the result (in
                the manifest's own format: a JSON manifest needs no PyYAML)
  fleet         one-screen fleet dashboard from scraped /metrics
                (doc/observability.md §scrape-plane)
  trace         render one request's stitched cross-process span tree
                from per-process trace dumps (doc/serving.md §request
                tracing)
  calib         per-predictor calibration dashboard from scraped /metrics

The ``controller`` verb on a real cluster needs the ``kubernetes`` package
(``cluster/k8s.py``); with ``--fake`` it runs on the in-memory cluster.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.logging import setup as setup_logging

log = get_logger("cli")


def _build_cluster(args):
    if getattr(args, "fake", False):
        from edl_tpu_torch.cluster.fake import FakeCluster

        return FakeCluster()
    from edl_tpu_torch.cluster.k8s import K8sCluster

    return K8sCluster(kubeconfig=args.kubeconfig, namespace=args.namespace)


def _build_scraper(args):
    """A MetricsScraper from the shared scrape flags (None when no
    source was requested): static --scrape-targets plus dynamic
    discovery over the coordinator's KV (--scrape-coord)."""
    targets = [a.strip() for a in
               (getattr(args, "scrape_targets", "") or "").split(",")
               if a.strip()]
    coord_ep = getattr(args, "scrape_coord", "") or ""
    if not targets and not coord_ep:
        return None
    from edl_tpu_torch.observability.scrape import (
        MetricsScraper, kv_targets, static_targets,
    )

    discover = []
    if coord_ep:
        from edl_tpu_torch.coord.client import CoordClient

        host, _, port = coord_ep.rpartition(":")
        if not host or not port.isdigit():
            print(f"error: --scrape-coord wants host:port, got "
                  f"{coord_ep!r}", file=sys.stderr)
            raise SystemExit(2)
        discover.append(kv_targets(CoordClient(host, int(port))))
    return MetricsScraper(
        targets=static_targets(targets),
        discover=discover,
        interval_s=getattr(args, "scrape_interval", 1.0))


def _add_scrape_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scrape-targets", default="",
                   help="comma-separated host:port /metrics endpoints "
                        "to scrape statically")
    p.add_argument("--scrape-coord", default="",
                   help="coordinator host:port whose KV is polled for "
                        "dynamic targets (supervisor metrics-addr-* and "
                        "TTL'd serving-metrics-addr/* keys)")
    p.add_argument("--scrape-interval", type=float, default=1.0,
                   help="per-target scrape cadence (jittered)")


def cmd_controller(args) -> int:
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.scheduler.topology import POW2_POLICY, UNIT_POLICY

    cluster = _build_cluster(args)
    # a coordinator endpoint wires the goodput planner's curve source
    # (doc/scheduling.md), the serving capacity recorder, and job-KV GC
    goodput_curves = coord_for = None
    coord_ep = getattr(args, "coord", "")
    if coord_ep:
        from edl_tpu_torch.coord.client import CoordClient
        from edl_tpu_torch.observability.goodput import load_curve

        host, _, port = coord_ep.rpartition(":")
        if not host or not port.isdigit():
            print(f"error: --coord wants host:port, got {coord_ep!r}",
                  file=sys.stderr)
            raise SystemExit(2)
        coord = CoordClient(host, int(port))
        goodput_curves = lambda uid: load_curve(coord, uid)  # noqa: E731
        coord_for = lambda job: coord  # noqa: E731
    controller = Controller(
        cluster,
        max_load_desired=args.max_load_desired,
        shape_policy=POW2_POLICY if args.pow2_shapes else UNIT_POLICY,
        autoscaler_loop_seconds=args.loop_seconds,
        goodput_curves=goodput_curves,
        goodput_objective=getattr(args, "goodput_objective", True),
        coord_for=coord_for,
        # scrape plane: with a source configured, the serving scaler is
        # fed from scraped replica /metrics instead of any in-process
        # hook (doc/observability.md §scrape-plane)
        scraper=_build_scraper(args),
    )
    log.info("controller starting", max_load_desired=args.max_load_desired,
             loop_seconds=args.loop_seconds)
    controller.start()
    sync = None
    if not getattr(args, "fake", False):
        # The deployed watch: TrainingJob CRs drive the controller (role
        # of WatchTrainingJobs, reference pkg/controller.go:79-108).  The
        # fake backend has no CR store — there, jobs are submitted
        # in-process (tests/demos).
        from edl_tpu_torch.controller.sync import TrainingJobSyncLoop

        sync = TrainingJobSyncLoop(cluster, controller,
                                   poll_seconds=args.loop_seconds,
                                   gc_orphans=args.gc_orphans,
                                   orphan_grace_ticks=args.orphan_grace_ticks,
                                   watch=args.watch)
        sync.start()
    health = None
    if args.health_port >= 0:
        from edl_tpu_torch.observability.health import serve_health

        # probe truth = the loops' threads are actually alive; a crashed
        # autoscaler/sync thread flips /healthz to 503 and the kubelet
        # restarts the pod (k8s/controller.yaml probes)
        checks = {"autoscaler": controller.autoscaler.is_alive}
        if sync is not None:
            checks["crd_sync"] = sync.is_alive
        health = serve_health(args.health_port, checks)
        log.info("healthz serving", port=health.server_address[1])
    try:
        while True:  # role of the select{} park in edl.go:50
            time.sleep(3600)
    except KeyboardInterrupt:
        if health is not None:
            health.shutdown()
        if sync is not None:
            sync.stop()
        controller.stop()
    return 0


def cmd_collector(args) -> int:
    from edl_tpu_torch.observability.collector import Collector

    cluster = _build_cluster(args)
    health = None
    if args.health_port >= 0:
        from edl_tpu_torch.observability.health import serve_health

        # the TSV columns double as gauges on /metrics (Collector mirrors
        # every sample into the shared registry); /healthz goes 503 only
        # if the process is gone — sampling runs on this thread
        health = serve_health(args.health_port, {"collector": lambda: True})
        log.info("collector /metrics serving",
                 port=health.server_address[1])
    try:
        Collector(cluster, interval_s=args.interval).run(
            max_samples=args.samples if args.samples > 0 else None)
    finally:
        if health is not None:
            health.shutdown()
    return 0


def cmd_coordinator(args) -> int:
    from edl_tpu_torch.coord import server as coord_server

    argv = ["--port", str(args.port)]
    if args.state_file:
        argv += ["--state-file", args.state_file]
    if args.standby:
        argv += ["--standby"]
    if args.replicate_to:
        argv += ["--replicate-to", args.replicate_to]
    if args.health_port is not None:
        # explicit flag wins over the env; when absent, coord_server.main
        # owns the EDL_HEALTH_PORT fallback (one policy, one place)
        argv += ["--health-port", str(args.health_port)]
    return coord_server.main(argv)


def cmd_launch(args) -> int:
    from edl_tpu_torch.runtime import launcher

    return launcher.main([args.verb] + args.rest)


def cmd_submit(args) -> int:
    from edl_tpu_torch.api.serde import load_manifest_file, manifest_to_dict
    from edl_tpu_torch.api.types import ServingJob
    from edl_tpu_torch.api.validation import validate_any

    job = load_manifest_file(args.manifest)  # kind-dispatching decode
    validate_any(job)  # reject locally before touching the API
    cluster = _build_cluster(args)
    serving = isinstance(job, ServingJob)
    if getattr(args, "fake", False):
        # no CR store in the fake backend: materialize directly (demo path)
        cluster.create_resources(job)
    elif serving:
        cluster.create_serving_job_cr(manifest_to_dict(job))
    else:
        # Submission = creating the CR; the controller's sync loop
        # validates, materializes and tracks phases (the reference's flow:
        # kubectl create CR → informer onAdd, pkg/controller.go:110-148).
        cluster.create_training_job_cr(manifest_to_dict(job))
    lo, hi = job.group_range()
    log.info("job submitted", job=job.full_name,
             kind=type(job).__name__,
             replicas=f"{lo}-{hi}",
             elastic=job.elastic())
    return 0


def cmd_delete(args) -> int:
    from edl_tpu_torch.api.types import ServingJob, TrainingJob

    cluster = _build_cluster(args)
    if not getattr(args, "fake", False):
        # the controller's sync loop observes the CR deletion and tears
        # the job down (reference onDelete, pkg/controller.go:156-161).
        # Both kinds are tried: the verb takes a name, not a kind.
        cluster.delete_training_job_cr(args.name)
        if hasattr(cluster, "delete_serving_job_cr"):
            cluster.delete_serving_job_cr(args.name)
    # also delete pod resources directly so the verb works when no
    # controller is running (the reference's del_jobs.sh role)
    cluster.delete_resources(
        TrainingJob(name=args.name, namespace=args.namespace))
    try:
        cluster.delete_resources(
            ServingJob(name=args.name, namespace=args.namespace))
    except KeyError:
        pass  # no serving group under this name (the common case)
    log.info("job deleted", job=f"{args.namespace}/{args.name}")
    return 0


def format_status(cluster, namespace: str, name: str) -> str:
    """Per-role / per-pod state table for one job, preferring the status
    the controller recorded in the TrainingJob CR (what `kubectl get tj`
    shows; reference pkg/updater/trainingJobUpdater.go:295-307), falling
    back to a stateless recompute from live pods when no CR/controller is
    around (the fake backend, or a job submitted without the CRD)."""
    from edl_tpu_torch.controller.updater import compute_replica_statuses

    uid = f"{namespace}/{name}"
    lines = [f"job {uid}"]
    statuses = None
    cr = None
    if hasattr(cluster, "get_training_job_cr"):
        cr = cluster.get_training_job_cr(name, namespace=namespace)
    if cr is None and hasattr(cluster, "get_serving_job_cr"):
        cr = cluster.get_serving_job_cr(name, namespace=namespace)
    if cr is not None and cr.get("status"):
        from edl_tpu_torch.api.serde import status_from_dict

        status = status_from_dict(cr["status"])
        phase = status.phase.value + (
            f" ({status.reason})" if status.reason else "")
        lines.append(f"  phase: {phase}  [recorded by controller]")
        statuses = status.replica_statuses
    if statuses is None:
        statuses = compute_replica_statuses(cluster, uid)
    any_pod = False
    for st in statuses:
        lines.append(f"  {st.resource_type:<8} {st.state.value}")
        for pod, state in sorted(st.resource_states.items()):
            any_pod = True
            lines.append(f"    {pod:<28} {state.value}")
    if not any_pod:
        lines.append("  (no pods found — job absent or fully torn down)")
    return "\n".join(lines)


def cmd_status(args) -> int:
    cluster = _build_cluster(args)
    print(format_status(cluster, args.namespace, args.name))
    return 0


def format_job_list(cluster) -> str:
    """One line per TrainingJob CR with its recorded phase — the
    `kubectl get tj` table (the CRD's printer columns, k8s/crd.yaml)
    without kubectl."""
    rows = [("NAMESPACE", "NAME", "KIND", "PHASE", "MIN", "MAX", "REASON")]
    for cr in cluster.list_training_job_crs():
        meta = cr.get("metadata") or {}
        trainer = (cr.get("spec") or {}).get("trainer") or {}
        status = cr.get("status") or {}
        rows.append((
            meta.get("namespace", "default"),
            meta.get("name", ""),
            "TrainingJob",
            status.get("phase", "None"),
            str(trainer.get("min_instance", trainer.get("min-instance", ""))),
            str(trainer.get("max_instance", trainer.get("max-instance", ""))),
            (status.get("reason") or "")[:48],
        ))
    if hasattr(cluster, "list_serving_job_crs"):
        for cr in cluster.list_serving_job_crs():
            meta = cr.get("metadata") or {}
            server = (cr.get("spec") or {}).get("server") or {}
            status = cr.get("status") or {}
            rows.append((
                meta.get("namespace", "default"),
                meta.get("name", ""),
                "ServingJob",
                status.get("phase", "None"),
                str(server.get("min_replicas",
                               server.get("min-replicas",
                                          server.get("minReplicas", "")))),
                str(server.get("max_replicas",
                               server.get("max-replicas",
                                          server.get("maxReplicas", "")))),
                (status.get("reason") or "")[:48],
            ))
    if len(rows) == 1:
        return "no TrainingJobs found"
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                     for r in rows)


def cmd_list(args) -> int:
    cluster = _build_cluster(args)
    if not hasattr(cluster, "list_training_job_crs"):
        # no CR store (fake backend): list trainer groups from pods
        names = sorted({p.job_uid for p in cluster.list_pods(role="trainer")
                        if p.job_uid})
        print("\n".join(names) if names else "no TrainingJobs found")
        return 0
    print(format_job_list(cluster))
    return 0


def cmd_fleet(args) -> int:
    """One-screen fleet dashboard off the scrape plane: discover + sweep
    the fleet's /metrics endpoints, roll them up (FleetView), evaluate
    the alert rules, render.  ``--watch`` repaints every interval;
    default is sweep-a-few-times-then-print (scriptable)."""
    from edl_tpu_torch.observability.scrape import (
        AlertEngine, FleetView, render_fleet_dashboard,
    )
    # the rollup reads FleetStats from the serving module, which imports
    # torch: import it before the sweeps, or its seconds age the samples
    # just scraped past the staleness horizon by the time they render
    import edl_tpu_torch.runtime.serving  # noqa: F401

    scraper = _build_scraper(args)
    if scraper is None:
        print("error: no scrape source — pass --scrape-targets and/or "
              "--scrape-coord", file=sys.stderr)
        return 2
    view = FleetView(scraper, window_s=args.window)
    engine = AlertEngine(view, flight_dir=args.flight_dir or None)
    try:
        if args.watch:
            while True:
                scraper.sweep()
                engine.evaluate()
                print("\033[2J\033[H", end="")  # clear + home
                print(render_fleet_dashboard(view, engine))
                time.sleep(args.scrape_interval)
        # one-shot: a few sweeps so rates/deltas have two samples to
        # difference, then a single render.  Sleep the FULL interval
        # between sweeps — targets are due-gated on it, so a shorter
        # nap would make every sweep after the first scrape nothing and
        # render a zero dashboard for a live fleet
        for i in range(max(int(args.sweeps), 1)):
            scraper.sweep()
            if i < args.sweeps - 1:
                time.sleep(args.scrape_interval)
        engine.evaluate()
        print(render_fleet_dashboard(view, engine))
    except KeyboardInterrupt:
        pass
    finally:
        scraper.stop()
    firing = engine.firing()
    return 3 if firing and args.check else 0


def cmd_calib(args) -> int:
    """Per-predictor calibration dashboard off the scrape plane: every
    cost model's running measured/predicted factor, sample count and
    windowed error-pct quantiles, plus firing calibration_drift alerts.
    Same sweep discipline as ``fleet``; ``--check`` exits 3 while any
    predictor's drift alert is firing."""
    from edl_tpu_torch.observability.scrape import (
        AlertEngine, CalibrationDriftRule, FleetView,
        render_calib_dashboard,
    )

    scraper = _build_scraper(args)
    if scraper is None:
        print("error: no scrape source — pass --scrape-targets and/or "
              "--scrape-coord", file=sys.stderr)
        return 2
    view = FleetView(scraper, window_s=args.window)
    engine = AlertEngine(view, rules=[CalibrationDriftRule()],
                         flight_dir=args.flight_dir or None)
    try:
        if args.watch:
            while True:
                scraper.sweep()
                engine.evaluate()
                print("\033[2J\033[H", end="")  # clear + home
                print(render_calib_dashboard(view, engine))
                time.sleep(args.scrape_interval)
        # full-interval naps between sweeps, same reason as cmd_fleet:
        # targets are due-gated on the interval
        for i in range(max(int(args.sweeps), 1)):
            scraper.sweep()
            if i < args.sweeps - 1:
                time.sleep(args.scrape_interval)
        engine.evaluate()
        print(render_calib_dashboard(view, engine))
    except KeyboardInterrupt:
        pass
    finally:
        scraper.stop()
    return 3 if engine.firing() and args.check else 0


def cmd_trace(args) -> int:
    """Stitch one trace id's spans across every tier that recorded them
    (LB origin → front door → batcher; serving fleet phases) and render
    the tree.  Sources: ``trace-*.json`` dumps each data-plane process
    writes under EDL_TRACE_DIR (``Tracer.dump`` format) plus
    ``flightrec-*.json`` flight records — pass ``--files`` to read
    specific dumps instead.  Exit 1 when the id appears in no source
    (sampled out, ring rotated, or the dir is wrong)."""
    from edl_tpu_torch.observability.tracing import (
        discover_trace_files, load_trace_events, render_trace_tree,
    )

    paths = list(args.files or [])
    if not paths:
        paths = discover_trace_files(args.trace_dir)
    if not paths:
        print(f"error: no trace-*.json / flightrec-*.json under "
              f"{args.trace_dir!r} — point --trace-dir at the dir the "
              f"data-plane processes dump to (EDL_TRACE_DIR), or pass "
              f"--files", file=sys.stderr)
        return 2
    events = load_trace_events(paths, args.trace_id)
    if not events:
        print(f"trace {args.trace_id} not found in {len(paths)} "
              f"source file(s) — it may have been sampled out or the "
              f"ring rotated past it", file=sys.stderr)
        return 1
    print(render_trace_tree(events, args.trace_id))
    return 0


def cmd_validate(args) -> int:
    from edl_tpu_torch.api.serde import (dump_document, is_json,
                                         load_document, manifest_from_dict,
                                         manifest_to_dict)
    from edl_tpu_torch.api.validation import ValidationError, validate_any

    try:
        with open(args.manifest) as f:
            text = f.read()
        job = manifest_from_dict(load_document(text))
        validate_any(job)
    except (ValidationError, ValueError, OSError, RuntimeError) as exc:
        # RuntimeError: a YAML manifest where PyYAML is not installed
        print(f"INVALID: {exc}", file=sys.stderr)
        return 1
    # echoed in the manifest's own format: JSON in, JSON out (no PyYAML)
    print(dump_document(manifest_to_dict(job), as_json=is_json(text)),
          end="")
    return 0


def _add_cluster_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--kubeconfig", default=None,
                   help="path to kubeconfig; in-cluster config if omitted "
                        "(reference cmd/edl/edl.go:17, 31-36)")
    p.add_argument("--namespace", default="default")
    p.add_argument("--fake", action="store_true",
                   help="use the in-memory cluster backend (demos/tests)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m edl_tpu_torch.cli",
                                description="elastic deep learning on "
                                            "NVIDIA GPUs")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warn", "error"],
                   help="reference cmd/edl/edl.go:18")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("controller", help="run the control plane")
    _add_cluster_flags(c)
    c.add_argument("--max-load-desired", type=float, default=0.97,
                   help="cluster load ceiling (reference cmd/edl/edl.go:19)")
    c.add_argument("--loop-seconds", type=float, default=5.0,
                   help="autoscaler cadence (reference pkg/autoscaler.go:31)")
    c.add_argument("--pow2-shapes", action="store_true",
                   help="scale trainer counts in powers of two (the "
                        "pow2 shape policy)")
    c.add_argument("--gc-orphans", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="tear down job resources whose TrainingJob CR is "
                        "gone (--no-gc-orphans = log-only; teardown always "
                        "waits --orphan-grace-ticks consecutive ticks)")
    c.add_argument("--orphan-grace-ticks", type=int, default=3,
                   help="consecutive CR-less ticks before an orphaned "
                        "group is torn down (min 2: never on the first "
                        "tick)")
    c.add_argument("--health-port", type=int, default=-1,
                   help="serve GET /healthz for k8s probes "
                        "(k8s/controller.yaml passes 8080); -1 disables, "
                        "0 = OS-assigned")
    c.add_argument("--watch", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="stream TrainingJob watch events between periodic "
                        "full LISTs (the reference informer model); "
                        "--no-watch = pure poll-list every tick")
    c.add_argument("--goodput-objective",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="price cards by marginal goodput from each job's "
                        "measured ScalingCurve (priorities, preemption, "
                        "gang placement — doc/scheduling.md); needs a "
                        "curve source (--coord); --no-goodput-objective "
                        "pins the reference count-based packing")
    c.add_argument("--coord", default="",
                   help="coordinator host:port: enables the goodput "
                        "curve source (goodput-curve/<job> KV), the "
                        "serving capacity-curve recorder, and job-KV GC "
                        "on deletion")
    _add_scrape_flags(c)
    c.set_defaults(fn=cmd_controller)

    c = sub.add_parser("collector", help="cluster metrics TSV")
    _add_cluster_flags(c)
    c.add_argument("--interval", type=float, default=10.0,
                   help="sampling cadence (reference example/collector.py:226)")
    c.add_argument("--samples", type=int, default=0,
                   help="stop after N samples (0 = forever)")
    c.add_argument("--health-port", type=int, default=-1,
                   help="serve GET /healthz + /metrics (Prometheus text "
                        "of the TSV columns); -1 disables, 0 = "
                        "OS-assigned")
    c.set_defaults(fn=cmd_collector)

    c = sub.add_parser("coordinator", help="run the coordination server")
    c.add_argument("--port", type=int, default=7164)
    c.add_argument("--state-file",
                   default=os.environ.get("EDL_COORD_STATE_FILE", ""),
                   help="write-through durability file (restart with the "
                        "same path to resume queue/KV/epoch state)")
    c.add_argument("--standby", action="store_true",
                   default=os.environ.get("EDL_COORD_STANDBY", "") == "1",
                   help="start as a warm HA standby (doc/coordinator_ha.md)")
    c.add_argument("--replicate-to",
                   default=os.environ.get("EDL_COORD_REPLICATE_TO", ""),
                   help="host:port[,host:port] standbys this primary "
                        "streams its state to before acking mutations")
    c.add_argument("--health-port", type=int, default=None,
                   help="HTTP GET /healthz port; default from "
                        "EDL_HEALTH_PORT (compiled manifests set 8080), "
                        "-1 disables")
    c.set_defaults(fn=cmd_coordinator)

    c = sub.add_parser("launch", help="pod-role entrypoint")
    c.add_argument("verb",
                   choices=["start_coordinator", "start_trainer",
                            "start_static_trainer", "start_pserver",
                            "start_server"])
    c.add_argument("rest", nargs="*")
    c.set_defaults(fn=cmd_launch)

    c = sub.add_parser("submit", help="submit a TrainingJob or "
                                      "ServingJob manifest")
    _add_cluster_flags(c)
    c.add_argument("manifest")
    c.set_defaults(fn=cmd_submit)

    c = sub.add_parser("delete", help="delete a job")
    _add_cluster_flags(c)
    c.add_argument("name")
    c.set_defaults(fn=cmd_delete)

    c = sub.add_parser("status", help="per-role / per-pod job status")
    _add_cluster_flags(c)
    c.add_argument("name")
    c.set_defaults(fn=cmd_status)

    c = sub.add_parser("list", help="all TrainingJobs with recorded phases "
                                    "(the `kubectl get tj` table)")
    _add_cluster_flags(c)
    c.set_defaults(fn=cmd_list)

    c = sub.add_parser("fleet", help="one-screen fleet dashboard from "
                                     "scraped /metrics (the scrape "
                                     "plane's operator surface)")
    _add_scrape_flags(c)
    c.add_argument("--window", type=float, default=10.0,
                   help="rollup window for qps/p99 (seconds)")
    c.add_argument("--sweeps", type=int, default=3,
                   help="one-shot mode: sweeps before rendering (≥2 so "
                        "rates have deltas)")
    c.add_argument("--watch", action="store_true",
                   help="repaint every --scrape-interval until ^C")
    c.add_argument("--flight-dir", default="",
                   help="dump a flight record when an alert rule fires")
    c.add_argument("--check", action="store_true",
                   help="exit 3 if any alert is firing (CI/cron probes)")
    c.set_defaults(fn=cmd_fleet)

    c = sub.add_parser("calib", help="per-predictor calibration "
                                     "dashboard (measured/predicted "
                                     "factors + drift alerts)")
    _add_scrape_flags(c)
    c.add_argument("--window", type=float, default=10.0,
                   help="rollup window for error-pct quantiles (seconds)")
    c.add_argument("--sweeps", type=int, default=3,
                   help="one-shot mode: sweeps before rendering")
    c.add_argument("--watch", action="store_true",
                   help="repaint every --scrape-interval until ^C")
    c.add_argument("--flight-dir", default="",
                   help="dump a flight record when drift fires")
    c.add_argument("--check", action="store_true",
                   help="exit 3 if calibration drift is firing")
    c.set_defaults(fn=cmd_calib)

    c = sub.add_parser("trace", help="render one request's stitched "
                                     "cross-process span tree by trace "
                                     "id")
    c.add_argument("trace_id")
    c.add_argument("--trace-dir",
                   default=os.environ.get("EDL_TRACE_DIR", "."),
                   help="directory holding per-process trace-*.json "
                        "dumps and flightrec-*.json records (default: "
                        "EDL_TRACE_DIR, else .)")
    c.add_argument("--files", nargs="*", default=None,
                   help="explicit dump files (overrides --trace-dir)")
    c.set_defaults(fn=cmd_trace)

    c = sub.add_parser("validate", help="validate a manifest")
    c.add_argument("manifest")
    c.set_defaults(fn=cmd_validate)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
