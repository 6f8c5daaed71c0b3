"""Shared helpers of the serving data-plane port tests (front door, LB,
serving chaos): raw-socket HTTP/1.1 clients, the coordinator-KV fakes the
replicas publish their ready gates to, and constructors of one MLP
replica on either package from one set of weights, so a test can put the
reference's front door and the port's behind the same bytes."""

from __future__ import annotations

import re
import socket
import threading
import time

import jax
import numpy as np
import torch

from edl_tpu.models import mlp as jmlp
from edl_tpu_torch import interop
from edl_tpu_torch.models import mlp

#: the MLP of the carried scenarios, at the JAX init from key 0
SIZES = [16, 32, 4]
JPARAMS = jmlp.init(jax.random.key(0), SIZES)
#: fp32 MLP forwards of the two packages on the same rows (np.allclose's
#: rule at 1e-5)
ATOL = 1e-5


def module(params=JPARAMS) -> mlp.MLP:
    """The port's MLP on the CPU holding the JAX ``params``."""
    return interop.params_from_numpy(mlp.MLP(SIZES, device="cpu"),
                                     jax.tree.map(np.asarray, params))


MODEL = module()


def ref_out(rows) -> np.ndarray:
    """The JAX package's ``mlp.apply`` on ``rows`` [n, SIZES[0]]."""
    return np.asarray(jmlp.apply(JPARAMS, np.asarray(rows, np.float32)))


_REF: dict[float, np.ndarray] = {}


def ref_row(v: float) -> np.ndarray:
    """The ground-truth output for a constant-``v`` row — what an answer
    must decode to, or it counts as a wrong payload."""
    if v not in _REF:
        _REF[v] = ref_out(np.full((1, SIZES[0]), v, np.float32))[0]
    return _REF[v]


def payload_ok(body: bytes, v: float) -> bool:
    out = np.frombuffer(body, "<f4")
    exp = ref_row(v)
    return out.shape == exp.shape and bool(np.allclose(out, exp, atol=1e-4))


def port_server(params=None):
    """The port's ``ElasticServer`` over the MLP on the CPU."""
    import copy

    from edl_tpu_torch.runtime.serving import ElasticServer

    return ElasticServer(lambda p, b: mlp.apply(p, b[0]),
                         copy.deepcopy(MODEL if params is None else params),
                         devices=[torch.device("cpu")])


def ref_server():
    """The reference's ``ElasticServer`` over the same MLP weights."""
    from edl_tpu.runtime.serving import ElasticServer

    return ElasticServer(lambda p, b: jmlp.apply(p, b[0]), JPARAMS)


def read_responses(sock, n, timeout=30.0):
    """Read ``n`` HTTP responses off one socket: (status, body) in
    arrival order."""
    return [(st, body) for st, _h, body in read_raw_responses(sock, n,
                                                              timeout)]


def read_raw_responses(sock, n, timeout=30.0):
    """Like :func:`read_responses` but keeps the head bytes:
    (status, head, body)."""
    sock.settimeout(timeout)
    buf = b""
    out = []
    while len(out) < n:
        idx = buf.find(b"\r\n\r\n")
        if idx < 0:
            chunk = sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError(f"closed after {len(out)} of {n}")
            buf += chunk
            continue
        head = buf[:idx + 4]
        status = int(head.split(b" ", 2)[1])
        m = re.search(rb"\r\n[Cc]ontent-[Ll]ength: (\d+)", head)
        clen = int(m.group(1)) if m else 0
        while len(buf) < idx + 4 + clen:
            chunk = sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError(f"closed inside response {len(out)}")
            buf += chunk
        out.append((status, head, buf[idx + 4:idx + 4 + clen]))
        buf = buf[idx + 4 + clen:]
    return out


def connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def json_request(row, headers: bytes = b"") -> bytes:
    import json

    body = json.dumps({"inputs": np.asarray(row).tolist()}).encode()
    return (b"POST /predict HTTP/1.1\r\nHost: t\r\n"
            b"Content-Type: application/json\r\n" + headers
            + b"Content-Length: %d\r\n\r\n" % len(body)) + body


class FakeKV:
    """Thread-safe dict with the coordinator KV verbs discovery and the
    state publisher use."""

    def __init__(self):
        self._d = {}
        self._lock = threading.Lock()

    def kv_set(self, key, value):
        with self._lock:
            self._d[key] = bytes(value)

    def kv_get(self, key):
        with self._lock:
            return self._d.get(key)

    def kv_del(self, key):
        with self._lock:
            return self._d.pop(key, None) is not None

    def kv_keys(self, prefix=""):
        with self._lock:
            return [k for k in self._d if k.startswith(prefix)]


class PartitionableKV(FakeKV):
    """FakeKV whose discovery reads can be severed for a window: the
    raising mode is the coordinator RPC timing out mid-partition, the
    empty mode a server-side KV wipe."""

    def __init__(self):
        super().__init__()
        self._until = 0.0
        self._mode = "raise"

    def partition(self, duration_s, mode="raise"):
        self._mode = mode
        self._until = time.monotonic() + duration_s

    def partitioned(self):
        return time.monotonic() < self._until

    def kv_keys(self, prefix=""):
        if self.partitioned():
            if self._mode == "raise":
                raise OSError("coordinator unreachable (injected)")
            return []
        return super().kv_keys(prefix)


def spin_replica(kv, job, replica, fd=None, **kw):
    """One MLP replica (``BatchApp`` behind a started ``FrontDoor``),
    built and warm; ``fd`` picks the package (default: the port's)."""
    if fd is None:
        from edl_tpu_torch.runtime import frontdoor as fd
    build = ref_server if fd.__name__.startswith("edl_tpu.") else port_server
    app = fd.BatchApp(build, SIZES[0], job=job, replica=replica, kv=kv,
                      max_batch=kw.pop("max_batch", 16),
                      max_queue_ms=kw.pop("max_queue_ms", 0.5),
                      addr_ttl_s=kw.pop("addr_ttl_s", 5.0), **kw)
    door = fd.FrontDoor(app, host="127.0.0.1", job=f"{job}-{replica}").start()
    assert app.wait_ready(120)
    return app, door


def wait_routable(lb, n, deadline_s=30.0):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if sum(1 for u in lb.app.upstreams.values() if u.routable()) >= n:
            return True
        time.sleep(0.05)
    return False
