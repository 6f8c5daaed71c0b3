"""Helpers for the port's kill-and-reform drills: real supervisors
(``python -m edl_tpu_torch.runtime.multihost_worker --device cpu``, one
process tree each) against the port's native coordination server.

Each supervisor's world children join a gloo process group through a file
store in the drill's ``tmp_path`` (the rendezvous ``ElasticWorld`` claims
when every member is on one host), so xdist workers never race for a TCP
port.  ``EDL_MH_DIE_WITH_PARENT`` reaps every tree with the test process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from edl_tpu_torch.coord.server import spawn_server

ROOT = Path(__file__).resolve().parent.parent
#: a member is pruned this long after its last heartbeat, and a dead
#: worker's leased task is dispatched again after the task timeout
MEMBER_TTL_MS, TASK_TIMEOUT_MS = 2000, 3000


def worker_env(examples: int, shards: int, batch: int = 32,
               **extra: str) -> dict:
    env = dict(os.environ)
    env.update(
        EDL_MH_EXAMPLES=str(examples), EDL_MH_SHARDS=str(shards),
        EDL_MH_BATCH=str(batch), EDL_MH_DIE_WITH_PARENT="1",
        EDL_MH_DIGEST="1", OMP_NUM_THREADS="1",
        PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def spawn_worker(port: int, name: str, ckpt_dir, min_members: int,
                 env: dict, log_path, extra=()) -> subprocess.Popen:
    log = open(log_path, "w")
    return subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.runtime.multihost_worker",
         "--coord", f"127.0.0.1:{port}", "--name", name,
         "--ckpt-dir", str(ckpt_dir), "--min-members", str(min_members),
         "--settle-s", "0.3", "--heartbeat-timeout-s", "5",
         "--device", "cpu", *extra],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))


def wait_all(procs: dict, timeout_s: float) -> dict:
    """Wait for every worker; returns {name: returncode}.  A worker past
    the deadline is killed (its tree with it) and the wait fails."""
    deadline = time.monotonic() + timeout_s
    rcs = {}
    try:
        for name, p in procs.items():
            rcs[name] = p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return rcs


def wait_for_line(path: Path, needle: str, timeout_s: float) -> str:
    """Poll a worker log until a line containing ``needle`` appears."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if path.exists():
            for line in path.read_text().splitlines():
                if needle in line:
                    return line
        time.sleep(0.1)
    raise TimeoutError(f"{needle!r} never appeared in {path}")


def field(line: str, key: str) -> str:
    """``key=value`` from a log line."""
    return line.split(f"{key}=", 1)[1].split()[0]


def lines(path: Path, needle: str) -> list[str]:
    return [ln for ln in path.read_text().splitlines() if needle in ln]


def losses(text: str) -> list:
    """[(step, loss)] from 'step N world=W ... loss=L' progress lines."""
    out = []
    for line in text.splitlines():
        if " loss=" in line and " step " in line:
            step = int(line.split(" step ", 1)[1].split()[0])
            out.append((step, float(line.rsplit("loss=", 1)[1])))
    return out


def saved_digests(*paths: Path) -> dict:
    """{generation file: digest} from every worker's save lines."""
    out = {}
    for p in paths:
        for ln in lines(p, "saved generation"):
            if "digest=" in ln:
                out[ln.split("saved generation ", 1)[1].split()[0]] = \
                    field(ln, "digest")
    return out


def assert_exactly_once(client, shards: int) -> None:
    """Every shard completed exactly once, none dropped — across any
    number of crashes and resizes."""
    s = client.stats()
    assert s.todo == 0 and s.leased == 0, s
    assert s.done == shards, s
    assert s.dropped == 0, s
    assert client.all_done()


@pytest.fixture
def coord_server():
    handle = spawn_server(member_ttl_ms=MEMBER_TTL_MS,
                          task_timeout_ms=TASK_TIMEOUT_MS)
    yield handle
    handle.stop()
