"""ctypes bindings to the native coordination core (libedlcoord.so) — the
port's copy of edl_tpu.coord.bindings, over the port's own copy of the C++
sources (``edl_tpu_torch/coord/native/``).

The core builds at first use through the directory's Makefile, with g++,
into ``build/edl_tpu_torch/coord/<hash>/`` at the repository root, or
``$EDL_COMPILE_CACHE/edl_tpu_torch/coord/<hash>/`` (the Makefile's
``BUILD=`` variable), where the hash covers every file of the
native directory: an edited source rebuilds, an unchanged one is reused, and
nothing is written into the source tree.  A failed build raises with the
compiler's output; :func:`native_available` turns that into False for
callers that may use :class:`~edl_tpu_torch.coord.service.PyCoordService`
instead (:func:`edl_tpu_torch.coord.local_service`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from edl_tpu_torch.coord.service import (
    DEFAULT_MEMBER_TTL_MS,
    DEFAULT_TASK_TIMEOUT_MS,
    LeaseStatus,
    QueueStats,
)

NATIVE_DIR = Path(__file__).resolve().parent / "native"
#: under ``EDL_COMPILE_CACHE`` when it is set, as the kernels' build root
#: (ops/_build.py)
BUILD_ROOT = (Path(os.environ.get("EDL_COMPILE_CACHE")
                   or Path(__file__).resolve().parents[2] / "build")
              / "edl_tpu_torch" / "coord")


def build_dir(native: Path = NATIVE_DIR) -> Path:
    """Where this exact set of native sources builds to: a hash of every
    file's name and bytes (the Makefile, with its flags, included)."""
    h = hashlib.sha256()
    for path in sorted(p for p in native.iterdir() if p.is_file()):
        h.update(path.name.encode() + b"\0")
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


BUILD_DIR = build_dir()
LIB_PATH = BUILD_DIR / "libedlcoord.so"
SERVER_PATH = BUILD_DIR / "edl-coord-server"

_build_lock = threading.Lock()
_built = False
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build in this process took (0.0 when it was reused)
last_build_s = 0.0


def ensure_built() -> bool:
    """Build the native core into :data:`BUILD_DIR` unless it is there
    already; returns True.  Raises ``RuntimeError`` with make's output when
    the build fails (no g++, a compile error).  Processes take turns on a
    lock file in the build directory and look for the artifacts only while
    holding it, so none writes an object another is writing or loads one
    half linked."""
    global _built, last_build_s
    with _build_lock:
        if _built:
            return True
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not (LIB_PATH.exists() and SERVER_PATH.exists()):
                    _make()
                    last_build_s = time.perf_counter() - t0
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        _built = True
    return True


def _make() -> None:
    try:
        proc = subprocess.run(
            ["make", "-C", str(NATIVE_DIR), f"BUILD={BUILD_DIR}"],
            capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(
            f"cannot build the native coordination core: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(
            "cannot build the native coordination core (make exit "
            f"{proc.returncode}):\n{proc.stdout[-2000:]}"
            f"{proc.stderr[-4000:]}")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    ensure_built()
    lib = ctypes.CDLL(str(LIB_PATH))
    i64, i32, vp, cp = (ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_char_p)
    pi64 = ctypes.POINTER(i64)
    sigs = {
        "edl_service_new": ([i64, i32, i64], vp),
        "edl_service_free": ([vp], None),
        "edl_now_ms": ([], i64),
        "edl_tq_add": ([vp, cp, i64], i64),
        "edl_tq_lease": ([vp, cp, i64, pi64, cp, i64, pi64], i32),
        "edl_tq_complete": ([vp, i64, cp], i32),
        "edl_tq_fail": ([vp, i64, cp], i32),
        "edl_tq_renew": ([vp, i64, cp, i64], i32),
        "edl_tq_peek_leased": ([vp, i64, cp, i64], i64),
        "edl_tq_redispatch": ([vp, i64], i32),
        "edl_tq_release_worker": ([vp, cp], i32),
        "edl_tq_all_done": ([vp], i32),
        "edl_tq_pass": ([vp], i32),
        "edl_tq_stats": ([vp, pi64, pi64, pi64, pi64], None),
        "edl_mb_join": ([vp, cp, cp, i64], i64),
        "edl_mb_heartbeat": ([vp, cp, i64], i32),
        "edl_mb_leave": ([vp, cp], i32),
        "edl_mb_expire": ([vp, i64], i32),
        "edl_mb_epoch": ([vp], i64),
        "edl_mb_members": ([vp, i64, cp, i64], i64),
        "edl_kv_set": ([vp, cp, cp, i64], None),
        "edl_kv_get": ([vp, cp, cp, i64], i64),
        "edl_kv_del": ([vp, cp], i32),
        "edl_kv_cas": ([vp, cp, cp, i64, cp, i64], i32),
        "edl_kv_keys": ([vp, cp, cp, i64], i64),
        "edl_svc_snapshot": ([vp, cp, i64], i64),
        "edl_svc_snapshot_repl": ([vp, i64, cp, i64], i64),
        "edl_svc_restore": ([vp, cp, i64], i32),
        "edl_svc_restore_repl": ([vp, cp, i64, i64], i32),
        "edl_svc_apply_delta": ([vp, cp, i64, i64], i64),
        "edl_svc_fence": ([vp], i64),
        "edl_svc_stream_version": ([vp], i64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def native_available() -> bool:
    """True when the native core builds and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def _default_clock() -> int:
    return time.monotonic_ns() // 1_000_000


class NativeCoordService:
    """In-process handle over the C++ core; method surface identical to
    :class:`~edl_tpu_torch.coord.service.PyCoordService` (the canonical spec)."""

    _INITIAL_BUF = 1 << 16

    def __init__(
        self,
        task_timeout_ms: int = DEFAULT_TASK_TIMEOUT_MS,
        passes: int = 1,
        member_ttl_ms: int = DEFAULT_MEMBER_TTL_MS,
        clock=_default_clock,
    ) -> None:
        self._lib = _load()
        self._clock = clock
        self._buf_cap = self._INITIAL_BUF
        self._h = self._lib.edl_service_new(task_timeout_ms, passes,
                                            member_ttl_ms)
        self._member_ttl_ms = member_ttl_ms

    def member_ttl_ms(self) -> int:
        return self._member_ttl_ms

    def close(self) -> None:
        if self._h:
            self._lib.edl_service_free(self._h)
            self._h = None

    def __del__(self) -> None:  # best-effort
        try:
            self.close()
        except Exception:
            pass

    # -- task queue --------------------------------------------------------

    def add_task(self, payload: bytes) -> int:
        return self._lib.edl_tq_add(self._h, payload, len(payload))

    def lease(self, worker: str) -> tuple[LeaseStatus, int, bytes]:
        task_id = ctypes.c_int64(-1)
        plen = ctypes.c_int64(0)
        buf = ctypes.create_string_buffer(self._buf_cap)
        rc = self._lib.edl_tq_lease(
            self._h, worker.encode(), self._clock(),
            ctypes.byref(task_id), buf, self._buf_cap, ctypes.byref(plen),
        )
        if rc != 0:
            return (LeaseStatus(rc), -1, b"")
        if plen.value > self._buf_cap:
            # Payload didn't fit: the task is leased to us, so re-read it
            # through the peek API with a big-enough buffer.
            self._buf_cap = max(self._buf_cap * 2, plen.value)
            buf = ctypes.create_string_buffer(self._buf_cap)
            n = self._lib.edl_tq_peek_leased(self._h, task_id.value, buf,
                                             self._buf_cap)
            return (LeaseStatus.OK, task_id.value, buf.raw[:max(n, 0)])
        return (LeaseStatus.OK, task_id.value, buf.raw[: plen.value])

    def complete(self, task_id: int, worker: str | None = None) -> bool:
        w = (worker or "").encode()
        return bool(self._lib.edl_tq_complete(self._h, task_id, w))

    def fail(self, task_id: int, worker: str | None = None) -> bool:
        w = (worker or "").encode()
        return bool(self._lib.edl_tq_fail(self._h, task_id, w))

    def renew(self, task_id: int, worker: str = "") -> bool:
        return bool(self._lib.edl_tq_renew(self._h, task_id, worker.encode(),
                                           self._clock()))

    def redispatch(self) -> int:
        return self._lib.edl_tq_redispatch(self._h, self._clock())

    def release_worker(self, worker: str) -> int:
        return self._lib.edl_tq_release_worker(self._h, worker.encode())

    def all_done(self) -> bool:
        return bool(self._lib.edl_tq_all_done(self._h))

    def current_pass(self) -> int:
        return self._lib.edl_tq_pass(self._h)

    def stats(self) -> QueueStats:
        vals = [ctypes.c_int64(0) for _ in range(4)]
        self._lib.edl_tq_stats(self._h, *[ctypes.byref(v) for v in vals])
        return QueueStats(vals[0].value, vals[1].value, vals[2].value,
                          vals[3].value, self.current_pass())

    # -- membership --------------------------------------------------------

    def join(self, name: str, address: str = "") -> int:
        return self._lib.edl_mb_join(self._h, name.encode(), address.encode(),
                                     self._clock())

    def heartbeat(self, name: str) -> bool:
        return bool(self._lib.edl_mb_heartbeat(self._h, name.encode(),
                                               self._clock()))

    def leave(self, name: str) -> bool:
        return bool(self._lib.edl_mb_leave(self._h, name.encode()))

    def expire_members(self) -> int:
        return self._lib.edl_mb_expire(self._h, self._clock())

    def epoch(self) -> int:
        return self._lib.edl_mb_epoch(self._h)

    def members(self) -> tuple[int, list[tuple[str, str]]]:
        n, buf = self._grown(lambda b, cap: self._lib.edl_mb_members(
            self._h, self._clock(), b, cap))
        out = []
        for line in buf.raw[:n].decode().splitlines():
            if "=" in line:
                name, addr = line.split("=", 1)
                out.append((name, addr))
        return self.epoch(), out

    # -- long-poll waits ---------------------------------------------------
    #
    # Interface parity with PyCoordService/CoordClient.  The C core has no
    # condition variable surface, so these wait on a short in-process poll
    # — no network round-trips are being saved here anyway (the remote
    # path, where request load matters, parks on the native SERVER's cv);
    # 5 ms keeps in-process wakeup latency negligible against the 50 ms
    # sleep loops these calls replace.

    _WAIT_POLL_S = 0.005

    def wait_epoch(self, known_epoch: int, timeout_s: float) -> int:
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            self.expire_members()
            e = self.epoch()
            if e != known_epoch or time.monotonic() >= deadline:
                return e
            time.sleep(self._WAIT_POLL_S)

    def kv_wait(self, key: str, timeout_s: float,
                known_epoch: Optional[int] = None
                ) -> tuple[Optional[bytes], Optional[int]]:
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            self.expire_members()
            v = self.kv_get(key)
            if v is not None:
                return v, self.epoch()
            e = self.epoch()
            if known_epoch is not None and e != known_epoch:
                return None, e
            if time.monotonic() >= deadline:
                return None, e
            time.sleep(self._WAIT_POLL_S)

    def kv_wait_changed(self, key: str, old: Optional[bytes],
                        timeout_s: float
                        ) -> tuple[bool, Optional[bytes]]:
        """Until ``key``'s value differs from ``old`` (None: absent, so an
        appearance fires) or the timeout: ``(True, value)`` on a change,
        ``(True, None)`` on a delete, ``(False, None)`` on timeout — the
        :class:`PyCoordService` method, on the same short poll."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            v = self.kv_get(key)
            if v is not None and (old is None or v != old):
                return True, v
            if v is None and old is not None:
                return True, None
            if time.monotonic() >= deadline:
                return False, None
            time.sleep(self._WAIT_POLL_S)

    def server_metrics(self) -> dict:
        return {"requests_served": 0, "longpolls_parked": 0,
                "longpolls_fired": 0}

    # -- kv ----------------------------------------------------------------

    def kv_set(self, key: str, value: bytes) -> None:
        self._lib.edl_kv_set(self._h, key.encode(), value, len(value))

    def kv_get(self, key: str) -> Optional[bytes]:
        n, buf = self._grown(lambda b, cap: self._lib.edl_kv_get(
            self._h, key.encode(), b, cap))
        if n < 0:
            return None
        return buf.raw[:n]

    def kv_del(self, key: str) -> bool:
        return bool(self._lib.edl_kv_del(self._h, key.encode()))

    def kv_cas(self, key: str, expect: bytes, value: bytes) -> bool:
        return bool(self._lib.edl_kv_cas(self._h, key.encode(), expect,
                                         len(expect), value, len(value)))

    def kv_keys(self, prefix: str = "") -> list[str]:
        n, buf = self._grown(lambda b, cap: self._lib.edl_kv_keys(
            self._h, prefix.encode(), b, cap))
        return [k for k in buf.raw[:max(n, 0)].decode().splitlines() if k]

    # -- snapshot / restore (HA replication + durability parity) -----------
    #
    # The native snapshot format is THE format (coord.cc Snapshot) —
    # PyCoordService.snapshot() emits the same text, and the cross-backend
    # tests in tests/test_torch_coord_native.py restore each one into the
    # other, across the two packages too.

    def snapshot(self, include_members: bool = False) -> str:
        if include_members:
            n, buf = self._grown(lambda b, cap: self._lib.edl_svc_snapshot_repl(
                self._h, self._clock(), b, cap))
        else:
            n, buf = self._grown(lambda b, cap: self._lib.edl_svc_snapshot(
                self._h, b, cap))
        return buf.raw[:max(n, 0)].decode()

    def restore(self, blob: str) -> bool:
        data = blob.encode()
        return bool(self._lib.edl_svc_restore(self._h, data, len(data)))

    def restore_repl(self, blob: str) -> bool:
        """Clear-then-restore including members (fresh TTLs) — the
        standby-side apply the native server runs per SYNC."""
        data = blob.encode()
        return bool(self._lib.edl_svc_restore_repl(self._h, data, len(data),
                                                   self._clock()))

    def apply_delta(self, blob: str) -> int:
        """Apply a framed EDLDELTA1 op-log blob (the log-structured
        replication stream — doc/coordinator_scale.md).  Returns the new
        stream position; raises ValueError on a torn/unreplayable blob
        (position NOT ratcheted for a torn one) and a position-mismatch
        ValueError("behind") when the blob's ``from`` is not this
        mirror's position (the caller falls back to a checkpoint)."""
        data = blob.encode()
        rc = self._lib.edl_svc_apply_delta(self._h, data, len(data),
                                           self._clock())
        if rc == -2:
            raise ValueError("behind: delta does not start at this "
                             "mirror's position")
        if rc < 0:
            raise ValueError("torn or unreplayable delta blob rejected")
        return rc

    def fence(self) -> int:
        return self._lib.edl_svc_fence(self._h)

    def stream_version(self) -> int:
        return self._lib.edl_svc_stream_version(self._h)

    def _grown(self, call):
        """Run a fill-buffer C call, growing the buffer until it fits."""
        while True:
            buf = ctypes.create_string_buffer(self._buf_cap)
            n = call(buf, self._buf_cap)
            if n <= self._buf_cap:
                return n, buf
            self._buf_cap = max(self._buf_cap * 2, n)
