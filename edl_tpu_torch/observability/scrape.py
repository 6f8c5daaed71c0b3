"""Metrics-address publication — the publishing half of
edl_tpu.observability.scrape.

A process that serves ``/metrics`` (a serving replica, a multi-process
supervisor) publishes its bound address under a coordinator KV key, with an
expiry stamp in the value (plain KV has no TTL), refreshed by
:class:`AddrPublisher` so the key outlives exactly its publisher.  The
consuming half — ``MetricsScraper``, ``FleetView`` and the alert rules —
waits for ROADMAP.md queue 1 item 11.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from edl_tpu_torch.observability.logging import get_logger

log = get_logger("observability.scrape")

#: coordinator-KV prefix serving replicas publish their /metrics address
#: under (``serving-metrics-addr/<job>/<replica>``); TTL'd via an expiry
#: stamp in the value, refreshed by :class:`AddrPublisher`, swept with
#: the job's other KV state by coord/gc.py JOB_KV_PREFIXES
SERVING_METRICS_ADDR_PREFIX = "serving-metrics-addr/"
#: coordinator-KV key prefix multihost supervisors publish under
#: (``metrics-addr-<member>``) — the KV twin of the ckpt-dir address file
SUPERVISOR_METRICS_ADDR_PREFIX = "metrics-addr-"
#: default publication TTL: a crashed publisher's key stops being a
#: target within this window even though plain KV has no expiry
DEFAULT_ADDR_TTL_S = 30.0


def format_addr_value(addr: str, ttl_s: Optional[float]) -> bytes:
    """KV value for a published /metrics address: ``host:port`` plus an
    optional unix-time expiry stamp (how the scrape plane TTLs keys on a
    KV store that has none)."""
    if ttl_s is None:
        return addr.encode()
    return f"{addr} {time.time() + ttl_s:.3f}".encode()


def parse_addr_value(value: bytes) -> tuple[Optional[str], bool]:
    """``(addr, expired)`` from a published value; addr None when the
    value is unparseable."""
    try:
        parts = value.decode().split()
    except UnicodeDecodeError:
        return None, True
    if not parts or ":" not in parts[0]:
        return None, True
    if len(parts) > 1:
        try:
            if time.time() > float(parts[1]):
                return parts[0], True
        except ValueError:
            pass
    return parts[0], False


def publish_host(bind_host: str = "") -> str:
    """The host other machines should dial to reach a port this process
    bound: a SPECIFIC bind address is publishable as-is; a wildcard
    bind publishes the pod IP (``EDL_POD_IP``, the jobparser's downward
    API field) when set, else loopback (the single-host harness case).
    Publishing a raw ``127.0.0.1`` from a pod would point every
    cross-host scraper at its own loopback."""
    import os

    if bind_host and bind_host not in ("0.0.0.0", "::", "*"):
        return bind_host
    return os.environ.get("EDL_POD_IP") or "127.0.0.1"


def publish_serving_metrics_addr(kv, job: str, replica: str, addr: str,
                                 ttl_s: Optional[float] = DEFAULT_ADDR_TTL_S
                                 ) -> str:
    """Write one serving replica's /metrics address to coordinator KV
    (TTL'd; see :data:`SERVING_METRICS_ADDR_PREFIX`).  Returns the key."""
    key = f"{SERVING_METRICS_ADDR_PREFIX}{job}/{replica}"
    kv.kv_set(key, format_addr_value(addr, ttl_s))
    return key


class AddrPublisher(threading.Thread):
    """Background refresher for a TTL'd published address: re-stamps the
    expiry every ``ttl_s/3`` so the key outlives exactly its publisher
    (a crashed process's key expires; a live one's never does), and
    best-effort deletes it on :meth:`stop` (clean shutdown leaves no
    tombstone to wait out)."""

    def __init__(self, kv, key: str, addr: str,
                 ttl_s: float = DEFAULT_ADDR_TTL_S,
                 value_fn: Optional[Callable[[], bytes]] = None) -> None:
        super().__init__(name=f"addr-publish-{key}", daemon=True)
        self.kv = kv
        self.key = key
        self.addr = addr
        self.ttl_s = max(float(ttl_s), 1.0)
        #: value factory — default is the plain TTL'd address
        self.value_fn = value_fn
        self._halt = threading.Event()
        self._kick = threading.Event()

    def publish_now(self) -> None:
        """Republish out of band (e.g. on a ready-gate transition) —
        the run loop wakes immediately instead of at the next ttl/3."""
        self._kick.set()

    def _put(self) -> None:
        try:
            value = (self.value_fn() if self.value_fn is not None
                     else format_addr_value(self.addr, self.ttl_s))
            self.kv.kv_set(self.key, value)
        except Exception as exc:  # coordinator blip: keep refreshing
            log.warn("addr publish failed", key=self.key,
                     error=str(exc)[:120])

    def run(self) -> None:
        self._put()
        while True:
            self._kick.wait(self.ttl_s / 3.0)
            self._kick.clear()
            if self._halt.is_set():
                return
            self._put()

    def stop(self) -> None:
        self._halt.set()
        self._kick.set()
        self.join(timeout=5)
        try:
            self.kv.kv_del(self.key)
        except Exception:
            pass
