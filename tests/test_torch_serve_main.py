"""The port's model-server entry point, ``serve_main(env, device)``, as a
pod runs it: ``python -m edl_tpu_torch.runtime.serving --device cpu`` in a
subprocess over an ``ElasticCheckpointer`` lineage holding the MLP at the
JAX init, on the legacy front door.  ``/healthz`` answers 200 once ready,
``/predict`` answers the JAX package's ``mlp.apply`` on the same rows
within 1e-5, a generation saved into the lineage is picked up by the
watcher, and SIGTERM drains and exits 0.  The default (async) front door
answers pipelined JSON and raw-f32 ``/predict`` over one socket in order,
each within 1e-5 of the JAX package's ``mlp.apply``, and exits 0 on
SIGTERM; a front door it does not know raises before any port is
bound."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from edl_tpu.models import mlp as jmlp
from edl_tpu_torch import interop
from edl_tpu_torch.models import mlp
from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
from edl_tpu_torch.runtime.serving import serve_main

ROOT = Path(__file__).resolve().parent.parent
SIZES = [16, 64, 4]
#: fp32 MLP forwards of the two packages on the same rows (np.allclose's
#: rule at 1e-5)
ATOL = 1e-5


def _module(params) -> mlp.MLP:
    return interop.params_from_numpy(mlp.MLP(SIZES, device="cpu"),
                                     jax.tree.map(np.asarray, params))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, row) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps({"inputs": [float(v) for v in row]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _wait_ready(proc, log: Path, timeout_s: float) -> int:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for line in log.read_text().splitlines():
            if line.startswith("model server ready port="):
                return int(line.split("port=")[1].split()[0])
        if proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}:\n"
                                 f"{log.read_text()[-3000:]}")
        time.sleep(0.1)
    raise AssertionError(f"no ready line:\n{log.read_text()[-3000:]}")


@pytest.mark.timeout_s(180)
def test_serve_main_serves_reloads_and_drains(tmp_path):
    p1 = jmlp.init(jax.random.key(0), SIZES)
    p2 = jax.tree.map(lambda a: a * 2.0 + 0.5, p1)
    lineage = tmp_path / "lineage"
    ckpt = ElasticCheckpointer(lineage, max_to_keep=3)
    ckpt.save(1, {"params": _module(p1)})
    health_port = _free_port()
    env = dict(os.environ)
    env.update(
        EDL_SERVING_MODEL_DIR=str(lineage), EDL_SERVING_MODEL="mlp:16,64,4",
        EDL_SERVING_FRONTDOOR="legacy", EDL_SERVING_PORT="0",
        EDL_HEALTH_PORT=str(health_port), EDL_SERVING_RELOAD_POLL_S="0.5",
        EDL_JOB_NAME="mlp", OMP_NUM_THREADS="1",
        PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    log = tmp_path / "server.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch.runtime.serving",
             "--device", "cpu"], stdout=out, stderr=subprocess.STDOUT,
            env=env, cwd=str(ROOT))
    try:
        port = _wait_ready(proc, log, 120)
        assert "generation=1" in log.read_text()
        # the readiness gate: both the predict port and the probe port
        for p in (port, health_port):
            with urllib.request.urlopen(f"http://127.0.0.1:{p}/healthz",
                                        timeout=10) as r:
                assert r.status == 200
        rows = np.random.default_rng(3).normal(size=(16, 16)).astype(
            np.float32)
        want1 = np.asarray(jmlp.apply(p1, rows))
        for row, want in zip(rows, want1):
            doc = _post(port, row)
            assert doc["generation"] == 1
            assert np.allclose(doc["outputs"], want, atol=ATOL, rtol=ATOL)
        # generation 2 lands in the lineage; the watcher ships it
        ckpt.save(2, {"params": _module(p2)})
        want2 = np.asarray(jmlp.apply(p2, rows))
        deadline = time.monotonic() + 20
        doc = _post(port, rows[0])
        while doc["generation"] != 2 and time.monotonic() < deadline:
            time.sleep(0.1)
            doc = _post(port, rows[0])
        assert doc["generation"] == 2
        for row, want in zip(rows, want2):
            doc = _post(port, row)
            assert doc["generation"] == 2
            assert np.allclose(doc["outputs"], want, atol=ATOL, rtol=ATOL)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        ckpt.close()


def test_async_front_door_raises_before_binding(tmp_path):
    """The async front door serves now (the test below); what still
    raises before binding is a front door serve_main does not know."""
    port, health_port = _free_port(), _free_port()
    env = {"EDL_SERVING_MODEL_DIR": str(tmp_path / "none"),
           "EDL_SERVING_PORT": str(port),
           "EDL_HEALTH_PORT": str(health_port)}
    for kind in ("asyncio", "threaded"):
        env["EDL_SERVING_FRONTDOOR"] = kind
        with pytest.raises(ValueError, match="'async' and 'legacy'"):
            serve_main(env, device="cpu")
    # neither port was bound, and no lineage directory was made
    for p in (port, health_port):
        with socket.socket() as s:
            s.bind(("0.0.0.0", p))
    assert not (tmp_path / "none").exists()


def test_serve_main_refuses_a_bad_env(tmp_path, capsys):
    base = {"EDL_SERVING_FRONTDOOR": "legacy"}
    assert serve_main(base, device="cpu") == 2
    assert "EDL_SERVING_MODEL_DIR" in capsys.readouterr().out
    assert serve_main({**base, "EDL_SERVING_MODEL_DIR": str(tmp_path),
                       "EDL_SERVING_MODEL": "resnet:50"},
                      device="cpu") == 2
    assert "unknown EDL_SERVING_MODEL kind" in capsys.readouterr().out


@pytest.mark.timeout_s(180)
def test_serve_main_async_front_door_pipelines_in_order(tmp_path):
    """The default front door: JSON and raw-f32 ``/predict`` pipelined
    over ONE socket come back in request order, each row within 1e-5 of
    the JAX package's ``mlp.apply``; SIGTERM exits 0."""
    from edl_tpu_torch.runtime.frontdoor import build_predict_request
    from tests.torch_wire import connect, read_responses

    p1 = jmlp.init(jax.random.key(0), SIZES)
    lineage = tmp_path / "lineage"
    ckpt = ElasticCheckpointer(lineage)
    ckpt.save(1, {"params": _module(p1)})
    env = dict(os.environ)
    env.pop("EDL_SERVING_FRONTDOOR", None)
    env.update(
        EDL_SERVING_MODEL_DIR=str(lineage), EDL_SERVING_MODEL="mlp:16,64,4",
        EDL_SERVING_PORT="0", EDL_HEALTH_PORT="-1",
        EDL_SERVING_RELOAD_POLL_S="0", OMP_NUM_THREADS="1",
        PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    log = tmp_path / "server.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch.runtime.serving",
             "--device", "cpu"], stdout=out, stderr=subprocess.STDOUT,
            env=env, cwd=str(ROOT))
    try:
        port = _wait_ready(proc, log, 120)
        assert "frontdoor=async" in log.read_text()
        rows = np.random.default_rng(5).normal(size=(6, 16)).astype(
            np.float32)
        want = np.asarray(jmlp.apply(p1, rows))
        blob, kinds = b"", []
        for i, row in enumerate(rows):
            if i % 2:
                body = json.dumps({"inputs": row.tolist()}).encode()
                blob += (b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(body)) + body
                kinds.append("json")
            else:
                blob += build_predict_request(row)
                kinds.append("f32")
        s = connect(port)
        s.sendall(blob)
        resps = read_responses(s, len(rows))
        s.close()
        assert [st for st, _ in resps] == [200] * len(rows)
        for (_, body), kind, w in zip(resps, kinds, want):
            got = (np.asarray(json.loads(body.decode())["outputs"])
                   if kind == "json" else np.frombuffer(body, "<f4"))
            assert np.allclose(got, w, atol=ATOL, rtol=ATOL), (kind, got, w)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        ckpt.close()
