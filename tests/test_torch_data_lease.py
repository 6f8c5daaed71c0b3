"""The lease half of the port's runtime/data.py held against the JAX
package's on the same data and the same queue sequences
(tests/test_runtime.py's task-lease cases): a pass covers the dataset once,
two workers partition it, a straggler's late completion is refused, a dead
worker's shard is redispatched, ``FileShardStore`` round-trips its shards
and ``fetch_payload`` resolves both payload kinds, and ``ensure_seeded``
takes over a dead seeder's claim but not a live one's."""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from edl_tpu.coord import PyCoordService as JaxCoord
from edl_tpu.runtime import data as jdata
from edl_tpu_torch.coord import PyCoordService
from edl_tpu_torch.runtime import data


def synthetic_classification(n=512, dim=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, dim)) * 3
    y = rng.integers(0, classes, size=n)
    x = centers[y] + rng.normal(size=(n, dim))
    return x.astype(np.float32), y.astype(np.int32)


def _batches(mod, coord_cls, worker="w0", clock=None, **kw) -> tuple:
    """(the rows of every batch one worker streams from a fresh queue of
    8 shards of 256 rows, the queue drained)."""
    coord = coord_cls(**({} if clock is None else dict(clock=clock)))
    reg = mod.ShardRegistry()
    x, y = synthetic_classification(n=256)
    reg.add_arrays(coord, (x, y), num_shards=8)
    rows = [np.concatenate([bx, by[:, None].astype(np.float32)], axis=1)
            for bx, by in mod.TaskLeaseBatches(coord, worker, reg.fetch,
                                               batch_size=32, **kw)]
    return rows, coord.all_done()


def test_task_lease_batches_cover_dataset_once():
    got, done = _batches(data, PyCoordService)
    want, jdone = _batches(jdata, JaxCoord)
    assert done and jdone and len(got) == 8
    assert all(b.shape == (32, 17) for b in got)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)  # the same rows, in the same order


def test_task_lease_batches_two_workers_partition_work():
    coord = PyCoordService()
    reg = data.ShardRegistry()
    x, y = synthetic_classification(n=256)
    reg.add_arrays(coord, (x, y), num_shards=8)
    counts = {"w0": 0, "w1": 0}
    seen: list = []
    lock = threading.Lock()

    def run(w):
        for bx, _ in data.TaskLeaseBatches(coord, w, reg.fetch,
                                           batch_size=32,
                                           poll_seconds=0.005):
            with lock:
                counts[w] += bx.shape[0]
                seen.extend(map(bytes, bx))

    threads = [threading.Thread(target=run, args=(w,)) for w in counts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts["w0"] + counts["w1"] == 256
    assert sorted(seen) == sorted(map(bytes, x))  # every row exactly once
    assert coord.all_done()


@pytest.mark.parametrize("coord_cls", [PyCoordService, JaxCoord],
                         ids=["port", "reference"])
def test_stale_worker_completion_rejected_after_redispatch(coord_cls):
    clock_ms = [0]
    coord = coord_cls(task_timeout_ms=16_000, clock=lambda: clock_ms[0])
    coord.add_task(b"t")
    _, tid, _ = coord.lease("straggler")
    clock_ms[0] += 16_001
    _, tid2, _ = coord.lease("fresh")
    assert tid2 == tid
    assert not coord.complete(tid, "straggler")
    assert coord.complete(tid2, "fresh")
    assert coord.all_done()


def test_dead_worker_shard_is_redispatched():
    """A worker leases a shard and vanishes; after the 16 s bound the live
    worker streams it too, and nothing is lost — the same rows as the
    reference's."""
    outs = []
    for mod, coord_cls in ((data, PyCoordService), (jdata, JaxCoord)):
        clock_ms = [1_000_000]
        coord = coord_cls(task_timeout_ms=16_000,
                          clock=lambda: clock_ms[0])
        reg = mod.ShardRegistry()
        x, y = synthetic_classification(n=64)
        reg.add_arrays(coord, (x, y), num_shards=2)
        coord.lease("dead")
        clock_ms[0] += 16_001
        outs.append([bx for bx, _ in mod.TaskLeaseBatches(
            coord, "alive", reg.fetch, batch_size=32)])
        assert sum(b.shape[0] for b in outs[-1]) == 64
        assert coord.all_done()
    assert all(np.array_equal(a, b) for a, b in zip(*outs))


def test_file_shard_store_round_trip(tmp_path):
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.arange(10, dtype=np.float32)
    paths = data.FileShardStore.write_shards(str(tmp_path / "port"), (x, y),
                                             3)
    ref = jdata.FileShardStore.write_shards(str(tmp_path / "ref"), (x, y), 3)
    assert len(paths) == 3 and all(p.endswith(".npz") for p in paths)
    for a, b in zip(paths, ref):  # the same shards
        for u, v in zip(data.FileShardStore.fetch_path(a),
                        jdata.FileShardStore.fetch_path(b)):
            assert np.array_equal(u, v)
    coord = PyCoordService()
    data.FileShardStore.enqueue(coord, paths)
    rows = []
    while True:
        status, tid, payload = coord.lease("w0")
        if status.name != "OK":
            break
        sx, sy = data.fetch_payload(payload)
        assert sx.shape[0] == sy.shape[0]
        rows.extend(sy.tolist())
        coord.complete(tid, "w0")
    assert sorted(rows) == y.tolist()
    reg = data.ShardRegistry()
    reg.register_arrays((x, y), 2)
    got = data.fetch_payload(json.dumps({"shard": 0}).encode(), registry=reg)
    assert got[0].shape[0] == 5
    with pytest.raises(ValueError, match="registry"):
        data.fetch_payload(json.dumps({"shard": 0}).encode())


def test_ensure_seeded_survives_dead_seeder():
    coord = PyCoordService()
    seeded_by = []

    def seed(name):
        def fn(beat):
            beat()
            coord.add_task(b"t0")
            coord.add_task(b"t1")
            seeded_by.append(name)
        return fn

    assert coord.kv_cas("data-seeder", b"", b"seeding:w0:0")
    data.ensure_seeded(coord, "w1", seed("w1"), stale_ms=1, poll_s=0.01)
    assert seeded_by == ["w1"]
    assert coord.kv_get("data-seeder") == b"seeded"
    assert coord.stats().todo == 2
    data.ensure_seeded(coord, "w2", seed("w2"))
    assert seeded_by == ["w1"]


def test_ensure_seeded_does_not_steal_live_claim():
    coord = PyCoordService()
    now = int(time.time() * 1000)
    assert coord.kv_cas("data-seeder", b"", f"seeding:w0:{now}".encode())
    stolen = []
    t = threading.Thread(
        target=lambda: data.ensure_seeded(coord, "w1",
                                          lambda beat: stolen.append(1),
                                          stale_ms=60_000, poll_s=0.01),
        daemon=True)
    t.start()
    time.sleep(0.2)
    assert not stolen and t.is_alive()
    coord.kv_set("data-seeder", b"seeded")
    t.join(timeout=5)
    assert not t.is_alive() and not stolen
