"""Coordination service: task-lease queue + membership epochs + KV — the
port's copy of edl_tpu.coord.

The JAX package holds the service three ways: in-process through a native
C++ core, over TCP through ``CoordClient`` to a coordinator server (with
an HA pair), or as the pure-Python :class:`PyCoordService`.  The port has
the Python backend alone: :func:`local_service` returns it whatever
``prefer_native`` says.  The native core, ``CoordClient``, the server and
the HA pair are a later item (ROADMAP.md, queue 1 item 4's second bullet),
which the multi-process world (item 6) needs.
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


def local_service(task_timeout_ms: int = DEFAULT_TASK_TIMEOUT_MS,
                  passes: int = 1,
                  member_ttl_ms: int = DEFAULT_MEMBER_TTL_MS,
                  prefer_native: bool = True) -> PyCoordService:
    """In-process coordination service (the reference's signature; the
    port has no native core, so ``prefer_native`` changes nothing)."""
    return PyCoordService(task_timeout_ms, passes, member_ttl_ms)


__all__ = [
    "CoordBehind",
    "CoordFenced",
    "DEFAULT_MEMBER_TTL_MS",
    "DEFAULT_TASK_TIMEOUT_MS",
    "LeaseStatus",
    "PyCoordService",
    "QueueStats",
    "local_service",
]
