"""Coordination-server launcher — the port's copy of edl_tpu.coord.server.

``python -m edl_tpu_torch.coord.server --port 7164`` runs the port's native
C++ server (building it first if needed, into ``build/edl_tpu_torch/coord/``;
see :mod:`edl_tpu_torch.coord.bindings`) — the coordinator's entrypoint, in
the role of the reference's start_master (docker/paddle_k8s:26-32).

:func:`spawn_server` starts one as a child process and returns a handle —
used by the elastic runtime and tests.  It runs the native binary or
raises: there is no Python server to hand back instead.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass

from edl_tpu_torch.coord.bindings import SERVER_PATH, ensure_built
from edl_tpu_torch.coord.client import CoordClient
from edl_tpu_torch.coord.service import DEFAULT_MEMBER_TTL_MS, DEFAULT_TASK_TIMEOUT_MS

_LISTEN_RE = re.compile(rb"listening on (\d+)")
_HEALTH_RE = re.compile(rb"health listening on (\d+)")


@dataclass
class ServerHandle:
    process: subprocess.Popen
    port: int
    #: HTTP health endpoint port (``GET /healthz``); None unless the
    #: server was spawned with ``health_port``
    health_port: int | None = None

    def client(self, timeout: float = 10.0) -> CoordClient:
        return CoordClient("127.0.0.1", self.port, timeout=timeout)

    def stop(self) -> None:
        if self.process.poll() is None:
            self.process.terminate()
            try:
                self.process.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.process.kill()


def spawn_server(
    port: int = 0,
    task_timeout_ms: int = DEFAULT_TASK_TIMEOUT_MS,
    passes: int = 1,
    member_ttl_ms: int = DEFAULT_MEMBER_TTL_MS,
    startup_timeout: float = 10.0,
    state_file: str | None = None,
    crash_on_persist: str | None = None,
    health_port: int | None = None,
    die_with_parent: bool = True,
    standby: bool = False,
    replicate_to: str | None = None,
    repl_lease_ms: int | None = None,
    repl_lease_strict: bool = False,
) -> ServerHandle:
    """Start edl-coord-server (port 0 = ephemeral) and wait until it
    reports its listening port.  ``state_file`` enables write-through
    durability: restart the server with the same file and it resumes the
    job's queue accounting, KV and epoch (the etcd-sidecar role).
    ``crash_on_persist`` ("N:tmp" | "N:acked" | "N:repl") is test-only
    fault injection for the power-loss/failover durability tests.
    ``die_with_parent`` (default on) SIGKILLs the server when the
    spawning process dies — spawn_server callers are tests/benches/demos,
    and an interrupted harness must not leave a coordinator squatting on
    the state file (the deployed coordinator path, ``edl-tpu
    coordinator`` → execv, never goes through here).

    HA (doc/coordinator_ha.md): ``standby=True`` starts a warm mirror
    that rejects every client verb with ``ERR fenced`` until PROMOTEd;
    ``replicate_to="host:port[,host:port]"`` makes a primary stream its
    versioned snapshot there before acking any mutation;
    ``repl_lease_ms`` tunes how stale the replication lease may go before
    the primary re-verifies its claim (the split-brain read guard).  See
    :func:`spawn_ha_pair` for the one-call pair."""
    ensure_built()  # raises with the compiler's output
    cmd = [
        str(SERVER_PATH),
        "--port", str(port),
        "--task-timeout-ms", str(task_timeout_ms),
        "--passes", str(passes),
        "--member-ttl-ms", str(member_ttl_ms),
    ]
    if state_file:
        cmd += ["--state-file", str(state_file)]
    if crash_on_persist:
        cmd += ["--crash-on-persist", crash_on_persist]
    if standby:
        cmd += ["--standby", "1"]
    if replicate_to:
        cmd += ["--replicate-to", str(replicate_to)]
    if repl_lease_ms is not None:
        cmd += ["--repl-lease-ms", str(repl_lease_ms)]
    if repl_lease_strict:
        cmd += ["--repl-lease-strict", "1"]
    # mirror the CLI/env convention: None or a negative value = disabled
    health_enabled = health_port is not None and health_port >= 0
    if health_enabled:
        cmd += ["--health-port", str(health_port)]  # 0 = OS-assigned
    preexec = None
    if die_with_parent:
        # Resolve libc in the PARENT: the preexec closure runs between
        # fork and exec, where import machinery / symbol resolution can
        # deadlock under a threaded parent — post-fork it may only call
        # the already-bound C function.
        import ctypes
        import signal as _signal

        try:
            _libc = ctypes.CDLL("libc.so.6", use_errno=True)

            def preexec(_libc=_libc, _sig=_signal.SIGKILL):
                _libc.prctl(1, _sig)  # PR_SET_PDEATHSIG
        except OSError:  # pragma: no cover - non-glibc platform
            preexec = None
    proc = subprocess.Popen(
        cmd,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        preexec_fn=preexec,
    )

    def read_banner(what: str) -> bytes:
        # readline in a thread: a hung/silent server must time out, not
        # block the caller forever
        import queue as _queue
        import threading as _threading

        box: "_queue.Queue[bytes]" = _queue.Queue()
        _threading.Thread(
            target=lambda: box.put(proc.stdout.readline()), daemon=True
        ).start()
        try:
            line = box.get(timeout=startup_timeout)
        except _queue.Empty:
            proc.kill()
            raise RuntimeError(f"coord server printed no {what} banner "
                               f"within {startup_timeout}s") from None
        if not line and proc.poll() is not None:
            raise RuntimeError("coord server exited at startup")
        return line

    line = read_banner("listen")
    m = _LISTEN_RE.search(line)
    if not m:
        proc.kill()
        raise RuntimeError(f"unexpected coord server banner: {line!r}")
    bound_health: int | None = None
    if health_enabled:
        # the health banner is the SECOND line when enabled
        hline = read_banner("health")
        hm = _HEALTH_RE.search(hline)
        if not hm:
            proc.kill()
            raise RuntimeError(f"unexpected health banner: {hline!r}")
        bound_health = int(hm.group(1))
    return ServerHandle(process=proc, port=int(m.group(1)),
                        health_port=bound_health)


def spawn_ha_pair(
    state_dir: str,
    task_timeout_ms: int = DEFAULT_TASK_TIMEOUT_MS,
    passes: int = 1,
    member_ttl_ms: int = DEFAULT_MEMBER_TTL_MS,
    repl_lease_ms: int = 3000,
    health_port: int | None = None,
    primary_port: int = 0,
    standby_port: int = 0,
    crash_on_persist: str | None = None,
) -> tuple[ServerHandle, ServerHandle]:
    """Start a replicated coordinator pair: a warm standby first, then a
    primary streaming to it.  Returns ``(primary, standby)``; point a
    multi-endpoint :class:`~edl_tpu_torch.coord.client.CoordClient` at both.
    Each node persists to its own state file under ``state_dir``, so a
    SIGKILLed member can be respawned (as a standby of whoever is primary
    then, re-attached via the REPLICATE verb) without losing its fence or
    stream position.  ``crash_on_persist`` goes to the PRIMARY (the
    "N:repl" stream-window injection).  A fixed nonzero ``health_port``
    goes to the primary; the standby gets ``health_port + 1`` (two
    processes cannot share one port — pass 0 for ephemeral both)."""
    os.makedirs(state_dir, exist_ok=True)
    standby_health = health_port
    if health_port is not None and health_port > 0:
        standby_health = health_port + 1
    standby = spawn_server(
        port=standby_port, task_timeout_ms=task_timeout_ms, passes=passes,
        member_ttl_ms=member_ttl_ms, standby=True,
        state_file=os.path.join(state_dir, "coord-b.state"),
        repl_lease_ms=repl_lease_ms, health_port=standby_health)
    try:
        primary = spawn_server(
            port=primary_port, task_timeout_ms=task_timeout_ms,
            passes=passes, member_ttl_ms=member_ttl_ms,
            state_file=os.path.join(state_dir, "coord-a.state"),
            replicate_to=f"127.0.0.1:{standby.port}",
            repl_lease_ms=repl_lease_ms, health_port=health_port,
            crash_on_persist=crash_on_persist)
    except Exception:
        standby.stop()
        raise
    return primary, standby


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="edl_tpu_torch coordination server")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("EDL_COORD_PORT", "7164")))
    # env-tunable so a deployed coordinator pod can be tuned through the
    # manifest's env block without changing the container command
    ap.add_argument("--task-timeout-ms", type=int,
                    default=int(os.environ.get("EDL_COORD_TASK_TIMEOUT_MS",
                                               str(DEFAULT_TASK_TIMEOUT_MS))))
    ap.add_argument("--passes", type=int,
                    default=int(os.environ.get("EDL_PASSES", "1")))
    ap.add_argument("--member-ttl-ms", type=int,
                    default=int(os.environ.get("EDL_COORD_MEMBER_TTL_MS",
                                               str(DEFAULT_MEMBER_TTL_MS))))
    ap.add_argument("--state-file",
                    default=os.environ.get("EDL_COORD_STATE_FILE", ""),
                    help="write-through durability file; restart with the "
                         "same path to resume the job's coordination state")
    ap.add_argument("--standby", action="store_true",
                    default=os.environ.get("EDL_COORD_STANDBY", "") == "1",
                    help="start as a warm HA standby: mirror a primary's "
                         "replication stream, answer every client verb "
                         "ERR fenced until promoted "
                         "(doc/coordinator_ha.md)")
    ap.add_argument("--replicate-to",
                    default=os.environ.get("EDL_COORD_REPLICATE_TO", ""),
                    help="host:port[,host:port] standby set this primary "
                         "streams its versioned state to before acking "
                         "any mutation")
    ap.add_argument("--repl-lease-ms", type=int,
                    default=int(os.environ.get("EDL_COORD_REPL_LEASE_MS",
                                               "3000")),
                    help="staleness bound on the replication lease before "
                         "a primary re-verifies its claim (split-brain "
                         "read guard)")
    ap.add_argument("--repl-lease-strict", action="store_true",
                    default=os.environ.get("EDL_COORD_REPL_LEASE_STRICT",
                                           "") == "1",
                    help="consistency over availability under partition: "
                         "a primary with no reachable standby SUSPENDS "
                         "(recoverable) once the lease lapses, instead "
                         "of continuing to serve")
    ap.add_argument("--health-port", type=int, default=None,
                    help="HTTP GET /healthz port (the probe target the "
                         "compiled coordinator manifest points at); "
                         "default from EDL_HEALTH_PORT, -1 disables, "
                         "0 = OS-assigned")
    args = ap.parse_args(argv)
    if args.health_port is None:
        # resolved after parse so a malformed env value degrades to
        # disabled instead of a parser-build traceback
        try:
            args.health_port = int(os.environ.get("EDL_HEALTH_PORT", "-1"))
        except ValueError:
            args.health_port = -1
    try:
        ensure_built()
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    cmd = [
        str(SERVER_PATH),
        "--port", str(args.port),
        "--task-timeout-ms", str(args.task_timeout_ms),
        "--passes", str(args.passes),
        "--member-ttl-ms", str(args.member_ttl_ms),
    ]
    if args.state_file:
        cmd += ["--state-file", args.state_file]
    if args.standby:
        cmd += ["--standby", "1"]
    if args.replicate_to:
        cmd += ["--replicate-to", args.replicate_to]
    cmd += ["--repl-lease-ms", str(args.repl_lease_ms)]
    if args.repl_lease_strict:
        cmd += ["--repl-lease-strict", "1"]
    if args.health_port >= 0:
        cmd += ["--health-port", str(args.health_port)]
    os.execv(str(SERVER_PATH), cmd)
    return 0  # unreachable


if __name__ == "__main__":
    raise SystemExit(main())
