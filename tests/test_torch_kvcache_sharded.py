"""The port's sharded KV pool (edl_tpu_torch.runtime.kvcache over several
devices, edl_tpu_torch.models.llama's ShardedCache) on the CPU:
tests/test_decode_v2.py's TestShardedPool on ``[cpu, cpu]`` and
``[cpu] * 3`` (the axis, ``per_device_used_bytes`` and
``reserved_bytes_per_device`` equal to the JAX package's pool on as many
virtual CPU devices), decode over heads, pages and int8 shards token-equal
to the JAX package's greedy continuation (tests/torch_decode_ref.py), the
entry points' logits over every split equal to one device's, copy-on-write,
forks, prefix sharing, host and D2D moves across splits, evacuation between
a sharded replica and a one-device replica with no session dropped, and the
JAX package's under-count of a replicated pool shown beside the port's."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from edl_tpu.models.transformer import TINY as JTINY
from edl_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from edl_tpu.runtime import kvcache as jkv
from edl_tpu_torch.models import llama
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.observability.metrics import MetricsRegistry
from edl_tpu_torch.runtime.kvcache import KVBlockPool
from edl_tpu_torch.runtime.serving import DecodeFleet, DecodeReplica
from tests.torch_decode_ref import MODEL, ref_decode, ref_decode_many

PERIODIC = [11, 4, 11, 4, 11, 4, 11, 4]
CPU2, CPU3 = ["cpu"] * 2, ["cpu"] * 3
PROMPTS = [[5, 9, 17, 33], list(PERIODIC), list(range(40, 61)),
           [200, 3, 3, 90, 17, 1, 250]]


def make_pool(num_blocks=16, block_size=8, cap=8, devices=None, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return KVBlockPool(tfm.TINY, num_blocks, block_size, cap, job="t/kvs",
                       device="cpu", devices=devices, **kw)


def ref_pool(num_blocks=16, block_size=8, cap=8, n=2, **kw):
    return jkv.KVBlockPool(JTINY, num_blocks, block_size, cap,
                           job="t/kvs-ref", registry=JaxRegistry(),
                           devices=jax.devices()[:n], **kw)


def make_fleet(**kw) -> DecodeFleet:
    kw.setdefault("job", "t/kvs-fleet")
    kw.setdefault("roles", {"decode": 1})
    kw.setdefault("slots", 4)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("kv_blocks", 48)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("max_blocks_per_session", 8)
    return DecodeFleet(MODEL, tfm.TINY, device="cpu", **kw)


def pool_prefill(pool: KVBlockPool, sid: int, toks: list) -> torch.Tensor:
    pool.ensure_capacity(sid, len(toks))
    logits, _ = llama.prefill(MODEL, pool.cache, list(toks),
                              pool.block_table(sid), 0, len(toks))
    return logits[:len(toks)]


# -- test_decode_v2.py: TestShardedPool ---------------------------------------


class TestShardedPool:
    def test_heads_sharded_fleet_matches_reference(self):
        fl = make_fleet(devices_per_replica=2)
        try:
            pool = fl._replicas[0].pool
            assert len(pool.devices) == 2
            assert pool.shard_axis == "heads"  # n_kv_heads 2 % 2 == 0
            ss = [fl.submit(list(p), max_new_tokens=8) for p in PROMPTS[:2]]
            assert [s.wait(120) for s in ss] \
                == [ref_decode(p, 8) for p in PROMPTS[:2]]
            assert fl.chips() == 2
        finally:
            fl.stop(drain=False)

    @pytest.mark.parametrize("n,num_blocks,axis", [
        (2, 16, "heads"), (3, 15, "pages")])
    def test_per_device_accounting_equals_the_reference(self, n, num_blocks,
                                                        axis):
        """The reference's accounting test, held to the reference's pool on
        as many virtual devices: the axis, each device's used bytes and the
        reservation, after every allocation and free."""
        pool = make_pool(num_blocks=num_blocks, devices=["cpu"] * n)
        ref = ref_pool(num_blocks=num_blocks, n=n)
        assert pool.shard_axis == ref.shard_axis == axis
        for step in (lambda p: p.ensure_capacity(1, 20),
                     lambda p: p.ensure_capacity(2, 41),
                     lambda p: p.free_session(1),
                     lambda p: p.ensure_capacity(3, 64)):
            step(pool)
            step(ref)
            per = pool.per_device_used_bytes()
            assert set(per) == set(range(n))
            assert per == ref.per_device_used_bytes()
            assert sum(per.values()) == pool.used_bytes()
        assert pool.reserved_bytes_per_device() \
            == ref.reserved_bytes_per_device() \
            == -(-pool.total_bytes() // n)
        # what the shards' tensors hold, device by device
        for shard in pool.cache.shards:
            assert sum(t.numel() * t.element_size()
                       for t in shard.values()) \
                == pool.reserved_bytes_per_device()

    def test_shards_are_tensors_of_their_own(self):
        pool = make_pool(devices=CPU2)
        k0, k1 = (s["k"] for s in pool.cache.shards)
        assert k0.shape == k1.shape == (2, 16, 8, 1, 16)  # a kv head each
        assert k0.untyped_storage().data_ptr() \
            != k1.untyped_storage().data_ptr()
        assert make_pool(num_blocks=15, devices=CPU3).cache.shards[0][
            "k"].shape == (2, 5, 8, 2, 16)  # 5 of 15 blocks, every head


class TestReplicatedReservation:
    def test_reference_under_counts_a_replicated_pool(self):
        """TINY's 2 kv heads and 16 blocks divide by neither 3: the pool
        is replicated, each device holding all of it.  The reference
        divides by the device count anyway; the port counts the tensors."""
        ref = ref_pool(num_blocks=16, block_size=16, cap=8, n=3)
        pool = make_pool(num_blocks=16, block_size=16, cap=8, devices=CPU3)
        assert ref.shard_axis == pool.shard_axis == "replicated"
        whole = pool.total_bytes()
        assert whole == 131_072
        shard0 = ref.cache["k"].addressable_shards[0].data
        assert shard0.nbytes == ref.cache["k"].nbytes  # every device: all
        assert ref.reserved_bytes_per_device() == 43_691  # ⌈131 072 / 3⌉
        assert pool.reserved_bytes_per_device() == whole
        ref.ensure_capacity(1, 20)
        pool.ensure_capacity(1, 20)
        assert ref.per_device_used_bytes() == {i: 5_461 for i in range(3)}
        assert pool.per_device_used_bytes() == {i: 16_384 for i in range(3)}

    @pytest.mark.parametrize("n,num_blocks", [(2, 16), (3, 15), (3, 16)])
    def test_reserved_bytes_tighten_replan_filter(self, n, num_blocks):
        """tests/test_kvcache.py's: the pool's residency shrinks what the
        resize planner thinks fits; the port's and the reference's planners
        take each pool's reservation.  A heads or pages split reserves what
        the reference reserves, so both plan alike; a replicated pool
        reserves the whole pool on every device, so the port's plan moves
        more of the state into fsdp where the reference's would not fit."""
        from edl_tpu.parallel.replan import propose_shape as jpropose
        from edl_tpu_torch.parallel.replan import propose_shape

        loose = propose_shape(8, state_bytes=100, max_bytes_per_device=100)
        assert (loose.fsdp, loose.dp) == (1, 8)
        for reserved, fsdp in ((60, 4), (75, 4)):
            got = propose_shape(8, state_bytes=100, max_bytes_per_device=100,
                                reserved_bytes_per_device=reserved)
            want = jpropose(8, state_bytes=100, max_bytes_per_device=100,
                            reserved_bytes_per_device=reserved)
            assert (got.dp, got.fsdp) == (want.dp, want.fsdp)
            assert got.fsdp >= 3 and (reserved != 75 or got.fsdp == fsdp)
        pool = make_pool(num_blocks=num_blocks, block_size=16,
                         devices=["cpu"] * n)
        ref = ref_pool(num_blocks=num_blocks, block_size=16, n=n)
        state, budget = 2 * pool.total_bytes(), 200_000
        plans = [p(8, state_bytes=state, max_bytes_per_device=budget,
                   reserved_bytes_per_device=r.reserved_bytes_per_device())
                 for p, r in ((propose_shape, pool), (jpropose, ref))]
        if pool.shard_axis == "replicated":
            assert plans[0].fsdp > plans[1].fsdp
        else:
            assert (plans[0].dp, plans[0].fsdp) \
                == (plans[1].dp, plans[1].fsdp)

    def test_int8_heads_pool_holds_every_scale_on_each_device(self):
        pool = make_pool(devices=CPU2, quantize="int8")
        shard = pool.cache.shards[0]
        held = sum(t.numel() * t.element_size() for t in shard.values())
        int8 = 2 * shard["k"].numel()
        scales = 2 * 4 * shard["k_scale"].numel()
        assert held == int8 + scales == pool.reserved_bytes_per_device()
        assert held > -(-pool.total_bytes() // 2)  # the reference's figure


# -- the entry points over the shards -----------------------------------------


@pytest.mark.parametrize("devices,num_blocks,quantize", [
    (CPU2, 16, None), (CPU3, 15, None), (CPU3, 16, None),
    (CPU2, 16, "int8"), (CPU3, 15, "int8")])
def test_sharded_steps_equal_one_device(devices, num_blocks, quantize):
    """prefill, decode_step and verify_step over each split give one
    device's logits (heads: the same arithmetic head by head; pages: the
    partials merged by their log-sum-exp; replicated: the home attends) and
    the same session K/V (a pages split within 1e-5: its merge rounds each
    layer's attention otherwise, and the next layer's K/V with it)."""
    pools = [make_pool(num_blocks=num_blocks, quantize=quantize),
             make_pool(num_blocks=num_blocks, quantize=quantize,
                       devices=devices)]
    out = []
    for pool in pools:
        pre = [pool_prefill(pool, sid, p) for sid, p in
               enumerate(PROMPTS[:3], 1)]
        tables = np.stack([pool.block_table(sid) for sid in (1, 2, 3)])
        pos = np.asarray([len(p) for p in PROMPTS[:3]])
        dec, _ = llama.decode_step(MODEL, pool.cache, [7, 8, 9], pos,
                                   tables, [True, False, True])
        ver, _ = llama.verify_step(MODEL, pool.cache, [[1, 2], [3, 4],
                                                       [5, 6]],
                                   pos, [2, 0, 1], tables)
        kv = pool.export_session(3, len(PROMPTS[2]) + 1)
        out.append((pre, dec, ver, kv))
    (pre0, dec0, ver0, kv0), (pre1, dec1, ver1, kv1) = out
    exact = pools[1].shard_axis != "pages"
    for a, b in zip(pre0 + [dec0, ver0], pre1 + [dec1, ver1]):
        if exact:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        if exact:
            assert torch.equal(kv0[name], kv1[name])
        else:
            torch.testing.assert_close(kv0[name], kv1[name], rtol=1e-5,
                                       atol=1e-5)


def test_one_decode_step_counts_its_cross_shard_bytes():
    pool = make_pool(devices=CPU2)
    pool_prefill(pool, 1, PROMPTS[0])
    before = pool.cache.cross_bytes
    tables = pool.block_table(1)[None]
    llama.decode_step(MODEL, pool.cache, [5], [len(PROMPTS[0])], tables,
                      [True])
    moved = pool.cache.cross_bytes - before
    cfg, L = tfm.TINY, tfm.TINY.n_layers
    # shard 1's index tensors once (cells of one row, its table, its
    # mask), then a layer: its 2 query heads, the row's k and v of its kv
    # head, and its heads' output back (fp32 TINY)
    index = 2 * 8 + tables.size * 8 + pool.block_table(1).size * 8
    per_layer = 4 * (2 * cfg.head_dim + 2 * cfg.head_dim + 2 * cfg.head_dim)
    assert moved == index + L * per_layer


def fleet_tokens(devices_per_replica: int, quantize, max_new: int = 10):
    fl = make_fleet(devices_per_replica=devices_per_replica,
                    kv_quantize=quantize,
                    job=f"t/kvs-{devices_per_replica}-{quantize}")
    try:
        ss = [fl.submit(list(p), max_new_tokens=max_new) for p in PROMPTS]
        tokens = [s.wait(120) for s in ss]
        pool = fl._replicas[0].pool
        assert fl.kv_reserved_bytes_per_device() \
            == pool.reserved_bytes_per_device()
        assert fl.chips() == max(devices_per_replica, 1)
        return tokens, pool.shard_axis
    finally:
        fl.stop(drain=False)


@pytest.mark.parametrize("d,axis", [(2, "heads"), (3, "pages")])
def test_sharded_fleet_decodes_token_equal_to_reference(d, axis):
    tokens, got_axis = fleet_tokens(d, None)
    assert got_axis == axis
    assert tokens == ref_decode_many(PROMPTS, 10)


def test_int8_sharded_fleet_decodes_as_one_device_int8():
    """int8 K/V rounds every cached row, so a greedy token may leave the
    fp32 reference's where its top two logits are close (on one device
    too: the fourth prompt's fourth token); the heads split and the pages
    split decode token-equal to the one-device int8 pool, and to the
    reference wherever one device's int8 does."""
    one, _ = fleet_tokens(0, "int8")
    ref = ref_decode_many(PROMPTS, 10)
    for d in (2, 3):
        tokens, _ = fleet_tokens(d, "int8")
        assert tokens == one
    assert [t for t, r in zip(one, ref) if t == r] == one[:3]


class TestPoolOpsOverShards:
    @pytest.mark.parametrize("devices,num_blocks", [
        (CPU2, 16), (CPU3, 15), (CPU3, 16)])
    def test_fork_and_copy_on_write(self, devices, num_blocks):
        pool = make_pool(num_blocks=num_blocks, devices=devices)
        toks = list(range(1, 13))
        pool_prefill(pool, 1, toks)
        pool.fork_session(1, 2)
        before = pool.export_session(1, len(toks))
        assert pool.make_writable(2, 8, 12) == 1  # the shared tail block
        assert pool.session_blocks(1)[1] != pool.session_blocks(2)[1]
        for sid in (1, 2):
            got = pool.export_session(sid, len(toks))
            for name in ("k", "v"):
                assert torch.equal(got[name], before[name])

    def test_prefix_sharing_over_pages(self):
        pool = make_pool(num_blocks=15, devices=CPU3)
        toks = list(range(1, 25))
        pool_prefill(pool, 1, toks)
        assert pool.register_prefix(1, toks) > 0
        blocks, covered = pool.admit_with_prefix(2, toks, 32)
        assert covered == 16 and blocks[:2] == pool.session_blocks(1)[:2]

    @pytest.mark.parametrize("src,dst", [
        (CPU2, None), (None, CPU2), (CPU2, CPU2), (CPU3, CPU2),
        (CPU2, CPU3), (CPU3, None)])
    @pytest.mark.parametrize("quantize", [None, "int8"])
    def test_device_and_host_moves_across_splits(self, src, dst, quantize):
        """A D2D payload and a host export leave one split and land in
        another bitwise (heads keep the payload heads-split, pages and
        replicated take it whole)."""
        nb = lambda d: 15 if d is CPU3 else 16  # noqa: E731
        a = make_pool(num_blocks=nb(src), devices=src, quantize=quantize)
        b = make_pool(num_blocks=nb(dst), devices=dst, quantize=quantize)
        toks = list(range(1, 19))
        pool_prefill(a, 1, toks)
        want = a.export_session(1, len(toks))
        payload = a.export_session_device(1, len(toks))
        assert len(payload.parts) == (2 if a.shard_axis == "heads" else 1)
        b.ensure_capacity(9, 4)  # the import lands on other block ids
        blocks = b.reserve_import_device(1, payload)
        where = b.payload_shardings(len(blocks))
        if b.shard_axis == "heads":
            assert where["k"] == (b.devices, 3)
        b.apply_import_device(1, blocks, payload)
        got = b.export_session(1, len(toks))
        b.import_session(2, want)
        again = b.export_session(2, len(toks))
        for name in ("k", "v"):
            assert torch.equal(got[name], want[name])
            if quantize is None:
                assert torch.equal(again[name], want[name])


@pytest.mark.parametrize("sharded_first", [True, False],
                         ids=["sharded-to-one", "one-to-sharded"])
@pytest.mark.parametrize("d", [2, 3])
def test_evacuation_between_sharded_and_one_device_replicas(sharded_first,
                                                            d):
    """scale_to(1) evacuates the newest replica into the other, D2D, across
    a sharded and a one-device pool; no session drops and every one is
    token-equal to the reference."""
    fl = make_fleet(devices_per_replica=0 if sharded_first else d,
                    job=f"t/kvs-evac-{d}-{sharded_first}")
    try:
        fl.devices_per_replica = d if sharded_first else 0
        assert fl.scale_to(2) == 2
        widths = [len(r.pool.devices) for r in fl._replicas]
        assert widths == ([1, d] if sharded_first else [d, 1])
        ss = [fl.submit(list(p), max_new_tokens=12) for p in PROMPTS]
        for s in ss:
            s.wait_first_token(60)
        assert fl.scale_to(1) == 1
        assert [s.wait(120) for s in ss] == ref_decode_many(PROMPTS, 12)
        assert fl.sessions_failed == 0
        assert fl.migration_bytes_d2d > 0 or fl.migrations == 0
    finally:
        fl.stop(drain=False)


def test_replica_on_shards_warms_up_on_its_own_split():
    r = DecodeReplica("t/kvs/solo", MODEL, tfm.TINY, job="t/kvs-solo",
                      device="cpu", devices=CPU3, kv_blocks=15,
                      kv_block_size=8, max_blocks_per_session=5).start()
    try:
        assert r.wait_ready(60)
        assert r.pool.shard_axis == "pages"
        assert all(torch.count_nonzero(s["k"]) == 0
                   for s in r.pool.cache.shards)  # warm-up used a scratch
    finally:
        r.stop(drain=False)
