"""Coordination service: task-lease queue + membership epochs + KV — the
port's copy of edl_tpu.coord.

A native C++ core (``edl_tpu_torch/coord/native/``, built with g++ at first
use into ``build/edl_tpu_torch/coord/``) in the role of the reference's
external Go master task-queue server and etcd sidecar (reference
docker/paddle_k8s:26-32, pkg/jobparser.go:167-184).  Three ways to hold it:

* :func:`local_service` — in-process via ctypes (tests, single-host runs);
* :class:`CoordClient` — TCP client to an ``edl-coord-server`` process, or
  to an HA pair of them (multi-process / multi-host;
  ``python -m edl_tpu_torch.coord.server``, :func:`spawn_server`,
  :func:`spawn_ha_pair`);
* :class:`PyCoordService` — the pure-Python backend where no C++ toolchain
  exists (same semantics, same tests).

All three expose the same method surface (see :class:`PyCoordService` for
the canonical signatures).
"""

from edl_tpu_torch.coord.service import (
    DEFAULT_MEMBER_TTL_MS,
    DEFAULT_TASK_TIMEOUT_MS,
    CoordBehind,
    CoordFenced,
    LeaseStatus,
    PyCoordService,
    QueueStats,
)
from edl_tpu_torch.coord.bindings import NativeCoordService, native_available
from edl_tpu_torch.coord.client import (
    CoordClient,
    CoordMux,
    CoordUnavailable,
    MuxCoordClient,
)
from edl_tpu_torch.coord.server import spawn_ha_pair, spawn_server


def local_service(task_timeout_ms: int = DEFAULT_TASK_TIMEOUT_MS,
                  passes: int = 1,
                  member_ttl_ms: int = DEFAULT_MEMBER_TTL_MS,
                  prefer_native: bool = True):
    """In-process coordination service: native if buildable, else Python."""
    if prefer_native and native_available():
        return NativeCoordService(task_timeout_ms, passes, member_ttl_ms)
    return PyCoordService(task_timeout_ms, passes, member_ttl_ms)


__all__ = [
    "CoordBehind",
    "CoordClient",
    "CoordFenced",
    "CoordMux",
    "CoordUnavailable",
    "MuxCoordClient",
    "DEFAULT_MEMBER_TTL_MS",
    "DEFAULT_TASK_TIMEOUT_MS",
    "LeaseStatus",
    "NativeCoordService",
    "PyCoordService",
    "QueueStats",
    "local_service",
    "native_available",
    "spawn_ha_pair",
    "spawn_server",
]
