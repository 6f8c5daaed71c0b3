"""Pod entrypoint — role dispatcher for every container the controller
launches; the port's copy of edl_tpu.runtime.launcher.

Port of the reference's bash entrypoint ``paddle_k8s`` (reference
docker/paddle_k8s:1-262).  The verbs map as:

  reference (docker/paddle_k8s)        this launcher
  ------------------------------       ----------------------------------
  start_master          (:26-32)   →   start_coordinator — runs the C++
                                       coordination server (task-lease
                                       queue + membership + KV), replacing
                                       the Go master *and* the etcd sidecar
  start_new_trainer     (:119-141) →   start_trainer — fault-tolerant
                                       path: failed-count guard, wait for
                                       coordinator, join membership, exec
                                       the user entrypoint
  start_trainer v2      (:143-226) →   start_static_trainer — non-FT
                                       barrier path with IP-sort-style rank
  start_new_pserver     (:14-24)   →   start_pserver — a membership-only
                                       pod (parameters live on the trainers)
  (serving replica)                →   start_server — serve_main
  exit-code → termination log (:44-60) classify_exit / write_termination_log

Everything is a plain function over explicit arguments; ``main()`` is the
thin env-reading shell (the ``EDL_*`` contract emitted by
``edl_tpu_torch.controller.jobparser.pod_env``, role of PADDLE_INIT_*,
reference pkg/jobparser.go:263-311).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import time
from typing import Callable, Optional

from edl_tpu_torch.coord.client import CoordClient
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.runtime.discovery import CoordDiscovery, PodDiscovery

log = get_logger("launcher")

TERMINATION_LOG = "/dev/termination-log"

#: Exit-code classification (reference docker/paddle_k8s:44-60).
_EXIT_REASONS = {
    136: "Floating point exception (core dumped)",
    139: "Segmentation fault (core dumped)",
    134: "Aborted (core dumped)",
}


def classify_exit(code: int) -> Optional[str]:
    return _EXIT_REASONS.get(code)


def write_termination_log(code: int, path: str = TERMINATION_LOG) -> None:
    """Record crash reason where the kubelet surfaces it
    (reference paddle_k8s:44-60)."""
    reason = classify_exit(code)
    if reason is None:
        return
    try:
        with open(path, "w") as f:
            f.write(reason)
    except OSError:  # not running in a pod; log only
        log.warn("termination log unwritable", code=code, reason=reason)


def check_failed_cnt(discovery: PodDiscovery, max_failed: int) -> bool:
    """Abort the job when too many trainers have failed
    (reference paddle_k8s:34-42, 121: threshold = TRAINERS for FT,
    0 for the static path).  Returns True if the job should abort."""
    from edl_tpu_torch.cluster.base import PodPhase

    failed = discovery.count_pods_by_phase(PodPhase.FAILED)
    if failed > max_failed:
        log.error("too many failed trainers; aborting",
                  failed=failed, max_failed=max_failed)
        return True
    return False


def wait_coordinator(host: str, port: int, timeout_s: float = 600.0,
                     poll_s: float = 1.0) -> CoordClient:
    """Block until the coordinator answers (role of the master-pod wait,
    reference paddle_k8s:126-129)."""
    deadline = time.monotonic() + timeout_s
    last_err: Exception | None = None
    while time.monotonic() < deadline:
        try:
            client = CoordClient(host, port)
            if client.ping():
                return client
            client.close()
        except OSError as exc:
            last_err = exc
        time.sleep(poll_s)
    raise TimeoutError(
        f"coordinator {host}:{port} unreachable after {timeout_s}s: {last_err}")


def run_entry(entry: str, workspace: str = "", extra_env: dict | None = None
              ) -> int:
    """``cd $TRAINER_PACKAGE && sh -c "$ENTRY"`` (reference
    paddle_k8s:133-139) with crash classification on the way out."""
    env = dict(os.environ)
    env.update(extra_env or {})
    proc = subprocess.run(
        ["sh", "-c", entry], cwd=workspace or None, env=env)
    if proc.returncode != 0:
        write_termination_log(proc.returncode)
    return proc.returncode


# -- role verbs --------------------------------------------------------------

def start_coordinator(port: int, argv_extra: list[str] | None = None) -> int:
    """Run the coordination server (role of start_master, reference
    paddle_k8s:26-32 — task timeout defaults to the reference's 16 s
    re-dispatch bound)."""
    from edl_tpu_torch.coord import server as coord_server

    return coord_server.main(["--port", str(port)] + (argv_extra or []))


def start_trainer(
    *,
    coord_host: str,
    coord_port: int,
    entry: str,
    workspace: str = "",
    worker_name: str = "",
    worker_address: str = "",
    discovery: PodDiscovery | None = None,
    max_failed: int | None = None,
    wait_timeout_s: float = 600.0,
) -> int:
    """Fault-tolerant trainer startup (role of start_new_trainer,
    reference paddle_k8s:119-141):

      1. failed-trainer guard (paddle_k8s:121),
      2. wait for the coordinator (paddle_k8s:126-129),
      3. join membership (replacing etcd registration, train_ft.py:105-110),
      4. exec the user entrypoint with the coordinator's address exported.

    The entry process re-resolves its own rank from membership epochs —
    trainer count appears nowhere here, which is what makes the job
    elastic (SURVEY §3.4)."""
    if discovery is not None and max_failed is not None:
        if check_failed_cnt(discovery, max_failed):
            return 1
    client = wait_coordinator(coord_host, coord_port, wait_timeout_s)
    name = worker_name or os.environ.get("HOSTNAME", f"worker-{os.getpid()}")
    member = CoordDiscovery(client, name, worker_address)
    member.join()
    try:
        # Heartbeat in the background while the user entrypoint runs —
        # without it the member expires after the TTL and the epoch bump
        # looks like a scale-down to every peer.
        with member.keepalive():
            return run_entry(entry, workspace, {
                "EDL_COORD_HOST": coord_host,
                "EDL_COORD_PORT": str(coord_port),
                "EDL_WORKER_NAME": name,
            })
    finally:
        try:
            member.leave()
        finally:
            client.close()


def start_pserver(
    *,
    coord_host: str,
    coord_port: int,
    worker_name: str = "",
    wait_timeout_s: float = 600.0,
    park: Callable[[], None] | None = None,
) -> int:
    """Migration-mode pserver pod (role of start_new_pserver, reference
    paddle_k8s:14-24).  The trainers hold the parameters, so this role
    carries no parameter state — it joins membership under a ``pserver/``
    name and heartbeats, giving reference-style job specs a live,
    observable pod for each requested pserver replica.  ``park`` (default:
    sleep-forever loop) exists for tests."""
    client = wait_coordinator(coord_host, coord_port, wait_timeout_s)
    name = worker_name or os.environ.get("HOSTNAME", f"ps-{os.getpid()}")
    member = CoordDiscovery(client, f"pserver/{name}")
    member.join()
    log.info("pserver joined membership (parameters live on the trainers; "
             "this role is migration-mode only)", name=name)
    try:
        with member.keepalive():
            if park is not None:
                park()
            else:  # pragma: no cover - infinite loop
                while True:
                    time.sleep(60.0)
        return 0
    finally:
        try:
            member.leave()
        finally:
            client.close()


def start_static_trainer(
    *,
    discovery: PodDiscovery,
    n_trainers: int,
    my_name: str,
    entry: str,
    workspace: str = "",
    wait_timeout_s: float = 600.0,
) -> int:
    """Static (non-fault-tolerant) path (role of start_trainer v2,
    reference paddle_k8s:143-226): barrier on the exact trainer count,
    rank from the sorted running-pod list, zero failure budget.

    Barrier, rank and peer addresses all come from ONE
    ``snapshot_running`` view — separate list calls with different
    filters let a pod deleted mid-startup desynchronize them."""
    if check_failed_cnt(discovery, 0):
        return 1
    deadline = time.monotonic() + wait_timeout_s
    while True:
        snap = discovery.snapshot_running()
        names = [n for n, _a in snap]
        # EXACT count (the reference's barrier): ">=" would let two pods
        # pass with different-sized snapshots during churn and disagree
        # on world size; with "==", every pod that passes saw the same
        # n_trainers-member set
        if len(snap) == n_trainers and my_name in names:
            break
        if time.monotonic() >= deadline:
            log.error("static barrier timed out",
                      have=len(snap), want=n_trainers, me=my_name)
            return 1
        time.sleep(1.0)
    return run_entry(entry, workspace, {
        "EDL_TRAINER_ID": str(names.index(my_name)),
        "EDL_TRAINERS": str(n_trainers),
        "EDL_TRAINER_ADDRESSES": ",".join(a for _n, a in snap),
    })


def resolve_coordinator_endpoint(env, default_port: int) -> tuple[str, int]:
    """Coordinator (host, port) from the EDL_* env contract.

    EDL_COORD_ENDPOINT wins (``host`` or ``host:port``), then
    EDL_COORD_HOST + EDL_COORD_PORT.  No silent localhost fallback: a
    worker pod with no coordinator address configured is a deployment bug
    and should fail loudly, not hang against localhost for 10 minutes."""
    endpoint = env.get("EDL_COORD_ENDPOINT", "")
    if endpoint:
        host, sep, p = endpoint.rpartition(":")
        if sep and p.isdigit():
            return host, int(p)
        return endpoint, default_port  # bare hostname, no port suffix
    host = env.get("EDL_COORD_HOST", "")
    if host:
        return host, default_port
    raise ValueError(
        "no coordinator address: set EDL_COORD_ENDPOINT (host[:port]) or "
        "EDL_COORD_HOST — the jobparser emits the coordinator Service DNS "
        "name for fault-tolerant jobs")


class _EnvPeersLister:
    """Pod 'listing' from EDL_STATIC_PEERS="name[=addr],name[=addr],..."
    — the discovery backend for environments without a kubernetes client
    (the process-backed kubelet, unit tests, bare-metal runs with a
    pre-agreed peer set).  Every listed peer is reported Running: a static
    declaration carries no live phase, so the failed-count guard cannot
    fire through this backend — failure budgeting falls to the control
    plane (the non-FT updater fails the job on ANY failed trainer,
    controller/updater.py convert)."""

    def __init__(self, spec: str, job_uid: str) -> None:
        from edl_tpu_torch.cluster.base import PodPhase
        from edl_tpu_torch.cluster.k8s import PodView

        self._pods = []
        for item in filter(None, (s.strip() for s in spec.split(","))):
            name, _, addr = item.partition("=")
            self._pods.append(PodView(
                name=name, job_uid=job_uid, role="trainer",
                phase=PodPhase.RUNNING, ip=addr))

    def list_pods(self, job_uid=None, role=None):
        return list(self._pods)


def _pod_discovery_from_env(env) -> PodDiscovery:
    """Pod-list discovery for the static path, from the EDL_* contract
    (role of the in-cluster k8s_tools calls, reference paddle_k8s:143-226).
    EDL_STATIC_PEERS (explicit peer set) takes precedence; otherwise the
    in-cluster kubernetes client.  Split out so tests can monkeypatch."""
    ns = env.get("EDL_NAMESPACE", "default")
    job = env.get("EDL_JOB_NAME", "")
    if not job:
        raise ValueError("EDL_JOB_NAME not set; the jobparser always "
                         "emits it for trainer pods")
    peers = env.get("EDL_STATIC_PEERS", "")
    if peers:
        return PodDiscovery(_EnvPeersLister(peers, f"{ns}/{job}"),
                            f"{ns}/{job}")
    from edl_tpu_torch.cluster.k8s import K8sCluster

    return PodDiscovery(K8sCluster(namespace=ns), f"{ns}/{job}")


# -- env-reading shell (the container's actual command) ----------------------

def main(argv: list[str] | None = None) -> int:
    """``python -m edl_tpu_torch.runtime.launcher <verb>`` — the container
    command the jobparser emits (role of the paddle_k8s dispatch,
    reference docker/paddle_k8s:236-261)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: launcher "
              "{start_coordinator|start_trainer|start_static_trainer|"
              "start_pserver|start_server}",
              file=sys.stderr)
        return 2
    verb = argv[0]
    env = os.environ
    default_port = int(env.get("EDL_COORD_PORT", "7164"))
    if verb == "start_coordinator":
        return start_coordinator(default_port, argv[1:])
    if verb == "start_server":
        # ServingJob replica: the model server fed from the EDL_SERVING_*
        # contract the jobparser emits, on the card
        from edl_tpu_torch.runtime.serving import serve_main

        return serve_main(env)
    if verb == "start_static_trainer":
        # non-FT pods (jobparser emits this verb when fault_tolerant is
        # off): barrier on the exact trainer count via the pod API —
        # no coordinator exists for these jobs
        try:
            discovery = _pod_discovery_from_env(env)
        except Exception as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        return start_static_trainer(
            discovery=discovery,
            n_trainers=int(env.get("EDL_TRAINER_MIN", "1")),
            my_name=env.get("EDL_POD_NAME",
                            env.get("HOSTNAME", "")),
            entry=env.get("EDL_ENTRY", ""),
            workspace=env.get("EDL_TRAINER_PACKAGE", ""),
        )
    if verb in ("start_trainer", "start_pserver"):
        try:
            host, port = resolve_coordinator_endpoint(env, default_port)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        if verb == "start_pserver":
            return start_pserver(
                coord_host=host, coord_port=port,
                worker_name=env.get("EDL_POD_NAME", ""),
            )
        return start_trainer(
            coord_host=host, coord_port=port,
            entry=env.get("EDL_ENTRY", ""),
            workspace=env.get("EDL_TRAINER_PACKAGE", ""),
            worker_name=env.get("EDL_POD_NAME", ""),
            worker_address=env.get("EDL_POD_IP", ""),
        )
    print(f"unknown verb {shlex.quote(verb)}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
