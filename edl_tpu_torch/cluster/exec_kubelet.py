"""Process-backed kubelet: FakeCluster pods actually exec their command —
the port's copy of edl_tpu.cluster.exec_kubelet.

The reference's whole stack meets in one running system because its
controller-created pods really execute the shipped entrypoint — the
trainer Job's template says ``paddle_k8s start_new_trainer``
(reference pkg/jobparser.go:124), the kubelet runs it
(reference docker/paddle_k8s:119-141), and the controller only created
the objects (reference pkg/controller.go:134-147).  This module closes
the same loop for the port without a real cluster:

* :class:`ProcessKubelet` attaches to a :class:`FakeCluster` via
  ``pod_event_hook``.  When reconcile starts a pod, the kubelet compiles
  the pod's container command + env **from the same jobparser manifest
  the deployed path ships** (`controller/jobparser.py` — it does not
  invent its own command line) and spawns it as a real OS process group.
* When reconcile stops a pod, the process group gets SIGTERM, escalating
  to SIGKILL after a grace period — kubelet pod termination semantics.
* When a pod's process exits on its own, the kubelet reports the exit
  back (``FakeCluster.report_pod_exit``): rc 0 → Succeeded (work-queue
  Job complete), else Failed → the Job controller's next reconcile
  replaces the pod.  This is what turns a ``kill -9`` of a worker into
  the full failure story: membership epoch bump → world reform →
  replacement pod → rejoin.  A pod is its own process group (a new
  session), so the SIGKILL reaches the launcher, the user entry, the
  supervisor and its world children — and with them every CUDA context
  the pod holds.

Single-machine emulation notes (the kubelet owns the pod sandbox, so
these belong here, not in the manifests):

* **Service DNS**: a ``*.svc`` host in ``EDL_COORD_ENDPOINT`` resolves
  to 127.0.0.1 — every "pod" runs on this machine.
* **Volumes**: each declared volumeMount maps to a per-job host
  directory; env values under the mount path are rewritten to it.
  Keying by job (not pod) gives the coordinator's state volume PVC
  semantics — its state survives pod replacement, which is the
  durability story the coordinator manifest documents
  (`controller/jobparser.py` EDL_COORD_STATE_FILE).
* **Pod identity**: ``EDL_POD_NAME``/``EDL_POD_IP``/``HOSTNAME`` are
  injected per pod, what the downward API / pod hostname provide for real
  (the IP is 127.0.0.1: every pod runs here).
* **The job image**: ``python`` in a pod command, and in the user entry
  the launcher runs through ``sh -c``, is this interpreter (a ``python``
  script under the workdir's ``bin/``, first on the pod's ``PATH``), and the
  port's package root is on ``PYTHONPATH``.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

from edl_tpu_torch.cluster.fake import FakeCluster, FakePod
from edl_tpu_torch.observability.logging import get_logger

log = get_logger("exec-kubelet")

@dataclass(frozen=True)
class Spawned:
    """One pod process: its pod, pid (= its process group), command, the
    user entry the launcher runs (``EDL_ENTRY``; empty for a coordinator),
    and the wall-clock time of the spawn."""

    pod: str
    pid: int
    command: list
    entry: str
    wall: float


_ROLE_PARSERS = {
    "trainer": "parse_to_trainer",
    "coordinator": "parse_to_coordinator",
    "pserver": "parse_to_pserver",
}


class ProcessKubelet:
    """Runs FakeCluster pods as real local processes.

    ``env_overrides`` is the harness knob (test/demo sizing, forcing the
    CPU backend, free health ports); it is applied after the manifest env
    and therefore must not be used to change the contract under test.
    """

    def __init__(
        self,
        cluster: FakeCluster,
        workdir: str,
        env_overrides: Optional[dict[str, str]] = None,
        term_grace_s: float = 5.0,
        reap_interval_s: float = 0.2,
    ) -> None:
        self.cluster = cluster
        self.workdir = workdir
        self.env_overrides = dict(env_overrides or {})
        self.term_grace_s = term_grace_s
        os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
        # `python` of the job image: this interpreter, through a script
        # (a symlink would lose a virtual environment's site-packages)
        self._bin = os.path.join(workdir, "bin")
        os.makedirs(self._bin, exist_ok=True)
        shim = os.path.join(self._bin, "python")
        with open(shim, "w") as f:
            f.write(f"#!/bin/sh\nexec {shlex.quote(sys.executable)} \"$@\"\n")
        os.chmod(shim, 0o755)
        self._lock = threading.Lock()
        self._procs: dict[str, subprocess.Popen] = {}
        #: every pod process spawned, in order
        self.spawned: list[Spawned] = []
        #: pod → the exit code the reaper reported
        self.exit_codes: dict[str, int] = {}
        self._term_deadline: dict[str, float] = {}
        self._prev_hook = cluster.pod_event_hook
        self._prev_aux = cluster.materialize_aux_pods
        cluster.materialize_aux_pods = True
        cluster.pod_event_hook = self._on_pod_event
        self._stop = threading.Event()
        self._reaper = threading.Thread(
            target=self._reap_loop, args=(reap_interval_s,),
            daemon=True, name="process-kubelet-reaper")
        self._reaper.start()

    # -- public surface ----------------------------------------------------

    def log_path(self, pod_name: str) -> str:
        return os.path.join(self.workdir, "logs", f"{pod_name}.log")

    def pid_of(self, pod_name: str) -> Optional[int]:
        with self._lock:
            p = self._procs.get(pod_name)
            return p.pid if p is not None and p.poll() is None else None

    def signal_pod(self, pod_name: str, sig: int = signal.SIGKILL) -> bool:
        """Chaos hook: signal the pod's whole process group (the
        ``kill -9`` of the reference's failure demo, doc-level parity
        with docker/paddle_k8s:119-141's dead-trainer-is-a-non-event)."""
        pid = self.pid_of(pod_name)
        if pid is None:
            return False
        try:
            os.killpg(pid, sig)
            return True
        except ProcessLookupError:
            return False

    def live_pods(self) -> list[str]:
        with self._lock:
            return [n for n, p in self._procs.items() if p.poll() is None]

    def stop(self) -> None:
        """Tear the kubelet down: kill every pod process group."""
        self._stop.set()
        with self._lock:
            names = list(self._procs)
        for name in names:
            self._kill_registered(name)
        self._reaper.join(timeout=5)
        # An in-flight _start_pod may have passed its _stop check before
        # set() above and registered a fresh process AFTER the sweep; with
        # the reaper gone nothing else would ever reap it.  The reaper has
        # exited here, so re-sweep whatever is still registered.
        with self._lock:
            leaked = [n for n, p in self._procs.items() if p.poll() is None]
        for name in leaked:
            log.warn("reaping pod spawned during teardown", pod=name)
            self._kill_registered(name)
        self.cluster.pod_event_hook = self._prev_hook
        self.cluster.materialize_aux_pods = self._prev_aux

    # -- manifest → process ------------------------------------------------

    def _container_for(self, pod: FakePod) -> Optional[dict]:
        from edl_tpu_torch.controller import jobparser

        job = self.cluster.job_spec(pod.job_uid)
        if job is None:
            return None
        parser = _ROLE_PARSERS.get(pod.role)
        if parser is None:
            return None  # system pods have no command to run
        manifest = getattr(jobparser, parser)(job)
        if manifest is None:
            return None
        tmpl = manifest["spec"]["template"]["spec"]
        container = tmpl["containers"][0]
        return {
            "command": list(container["command"]),
            # valueFrom (downward-API) entries carry no literal value —
            # this kubelet injects the pod identity itself in _pod_env
            "env": {e["name"]: e["value"]
                    for e in container.get("env", []) if "value" in e},
            "volumes": [v["name"] for v in tmpl.get("volumes", [])],
            "mounts": {m["name"]: m["mountPath"]
                       for m in container.get("volumeMounts", [])},
        }

    def _pod_env(self, pod: FakePod, container: dict) -> dict[str, str]:
        env = dict(os.environ)
        # "the job image has the framework installed": pod processes run
        # with the kubelet's workdir as cwd, so the package root must be
        # importable explicitly
        import edl_tpu_torch

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(edl_tpu_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env["PATH"] = self._bin + (
            os.pathsep + env["PATH"] if env.get("PATH") else "")
        env.update(container["env"])
        # volume emulation: env values under a mount path point into the
        # per-job volume dir (PVC semantics — survives pod replacement)
        job_dir = pod.job_uid.replace("/", "_")
        for vol, mount in container["mounts"].items():
            host_dir = os.path.join(self.workdir, "volumes", job_dir, vol)
            os.makedirs(host_dir, exist_ok=True)
            prefix = mount.rstrip("/") + "/"
            for k, v in list(env.items()):
                # exact path or a child of the mount — NOT a sibling that
                # merely shares the string prefix (/state vs /state-backup)
                if isinstance(v, str) and (v == mount
                                           or v.startswith(prefix)):
                    env[k] = host_dir + v[len(mount.rstrip("/")):]
        # Service DNS emulation: *.svc resolves to this machine
        ep = env.get("EDL_COORD_ENDPOINT", "")
        if ".svc" in ep:
            host, sep, port = ep.rpartition(":")
            env["EDL_COORD_ENDPOINT"] = (
                f"127.0.0.1:{port}" if sep and port.isdigit() else "127.0.0.1")
        # pod-API emulation for the static path: the launcher's
        # kubernetes-client discovery has no apiserver here, so hand it
        # the job's trainer pod set explicitly (launcher EDL_STATIC_PEERS
        # backend).  All pods run on this machine — name doubles as addr.
        if (pod.role == "trainer"
                and container["command"][-1] == "start_static_trainer"):
            from edl_tpu_torch.cluster.base import PodPhase

            # LIVE pods only: a crashed trainer must not appear in its
            # replacement's frozen peer list (the env backend cannot
            # re-observe phases later — the non-FT updater's any-failure-
            # is-fatal rule is what ultimately enforces the zero budget)
            peers = sorted(p.name for p in self.cluster.list_pods(
                job_uid=pod.job_uid, role="trainer")
                if not p.deletion_timestamp
                and p.phase in (PodPhase.PENDING, PodPhase.RUNNING))
            env.setdefault("EDL_STATIC_PEERS", ",".join(peers))
        # pod identity (downward API / pod hostname); every pod's IP is
        # this machine's, the address the supervised worker registers
        # with — the launcher's membership join and the worker's own are
        # then one member, not an address change that bumps the epoch
        env["EDL_POD_NAME"] = pod.name
        env["EDL_POD_IP"] = "127.0.0.1"
        env["HOSTNAME"] = pod.name
        env.update(self.env_overrides)
        return env

    def _on_pod_event(self, pod: FakePod, what: str) -> None:
        if self._prev_hook is not None:
            self._prev_hook(pod, what)
        if what == "start":
            self._start_pod(pod)
        elif what == "stop":
            self._request_stop(pod.name)

    def _start_pod(self, pod: FakePod) -> None:
        # start events race teardown and scale-down: reconcile() runs on
        # several threads and the hook fires outside the cluster lock, so
        # a pod may already be stopped/deleted (or the kubelet stopping)
        # by the time its start event lands — spawning then would leak a
        # live process no snapshot tracks
        if self._stop.is_set():
            return
        from edl_tpu_torch.cluster.base import PodPhase

        current = {p.name for p in self.cluster.list_pods()
                   if p.phase == PodPhase.RUNNING
                   and not p.deletion_timestamp}
        if pod.name not in current:
            return
        container = self._container_for(pod)
        if container is None:
            return
        command = container["command"]
        if command and command[0] == "python":
            command = [sys.executable] + command[1:]
        env = self._pod_env(pod, container)
        logf = open(self.log_path(pod.name), "w")
        try:
            proc = subprocess.Popen(
                command, env=env, stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True, cwd=self.workdir)
        except OSError as exc:
            log.error("pod spawn failed", pod=pod.name, error=str(exc))
            logf.close()
            self.cluster.report_pod_exit(pod.name, 127)
            return
        finally:
            logf.close()  # the child holds its own fd now
        with self._lock:
            self._procs[pod.name] = proc
            self.spawned.append(Spawned(pod.name, proc.pid, list(command),
                                        env.get("EDL_ENTRY", ""),
                                        time.time()))
        # stop() may have run between the _stop check above and the
        # registration: its kill sweep missed this process and the reaper
        # is gone, so nothing would ever reap it — kill it ourselves
        # (stop()'s post-join re-sweep is the backstop for the symmetric
        # window where registration lands mid-sweep)
        if self._stop.is_set():
            self._kill_registered(pod.name)
            return
        log.info("pod started", pod=pod.name, pid=proc.pid,
                 command=" ".join(command[:4]))

    def _kill_registered(self, pod_name: str) -> None:
        """SIGKILL + reap a process already in ``_procs`` (teardown path)."""
        with self._lock:
            proc = self._procs.pop(pod_name, None)
        if proc is None or proc.poll() is not None:
            return
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            log.error("pod process unreapable", pod=pod_name, pid=proc.pid)

    def _request_stop(self, pod_name: str) -> None:
        with self._lock:
            proc = self._procs.get(pod_name)
            if proc is None or proc.poll() is not None:
                return
            self._term_deadline[pod_name] = time.monotonic() + self.term_grace_s
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass

    # -- the reaper (kubelet status loop) ----------------------------------

    def _reap_loop(self, interval_s: float) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            exited: list[tuple[str, int]] = []
            with self._lock:
                for name, proc in list(self._procs.items()):
                    rc = proc.poll()
                    if rc is not None:
                        exited.append((name, rc))
                        self._procs.pop(name, None)
                        self._term_deadline.pop(name, None)
                    elif self._term_deadline.get(name, float("inf")) < now:
                        # grace expired: kubelet escalates to SIGKILL
                        self._term_deadline.pop(name, None)
                        try:
                            os.killpg(proc.pid, signal.SIGKILL)
                        except ProcessLookupError:
                            pass
            for name, rc in exited:
                if self._stop.is_set():
                    break  # teardown: a FAILED report would spawn a
                    # replacement process that outlives stop()
                log.info("pod exited", pod=name, rc=rc)
                self.exit_codes[name] = rc
                # a stop-requested pod is already deleted cluster-side;
                # report_pod_exit no-ops for it (pod gone / terminal)
                self.cluster.report_pod_exit(name, rc)
            self._stop.wait(interval_s)
