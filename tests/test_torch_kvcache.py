"""The port's paged KV pool (edl_tpu_torch.runtime.kvcache): the scenarios
of tests/test_kvcache.py and of test_decode_v2.py's prefix-sharing,
quantized-pool, D2D-migration and churn classes, a 500-operation churn
driven through the JAX package's KVBlockPool and the port's side by side
(the same block tables, refcounts, free lists and byte accounting after
every operation), and the move accounting against ``plan_reshard``.

Left out: the sharded-pool cases (a pool here lives on one device) and
``test_reserved_bytes_tighten_replan_filter`` (``replan`` is not
ported)."""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

from edl_tpu.models.transformer import TINY as JTINY
from edl_tpu.observability.collector import get_counters as jax_counters
from edl_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from edl_tpu.observability.metrics import parse_exposition
from edl_tpu.parallel.replan import plan_reshard
from edl_tpu.runtime import kvcache as jkv
from edl_tpu_torch.models import llama
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from edl_tpu_torch.runtime.kvcache import (
    KVBlockPool,
    KVPoolExhausted,
    SessionUnknown,
    plan_move,
)
from edl_tpu_torch.runtime.serving import DecodeFleet
from tests.torch_decode_ref import MODEL, ref_decode, ref_decode_many

PERIODIC = [11, 4, 11, 4, 11, 4, 11, 4]


def make_pool(num_blocks=8, block_size=4, cap=4, job="t/kv", **kw):
    kw.setdefault("registry", MetricsRegistry())
    return KVBlockPool(tfm.TINY, num_blocks, block_size, cap, job=job,
                       device="cpu", **kw)


def counter_sum(name: str, job: str, match: str = "") -> float:
    """Sum of a port counter across label sets for ``job``, read through
    the JAX package's strict exposition parser."""
    series = parse_exposition(get_registry().render())
    return sum(v for k, v in series.items()
               if k.startswith(name) and f'job="{job}"' in k
               and match in k)


def pool_prefill(pool: KVBlockPool, sid: int, toks: list) -> None:
    """A real prefill through the pool's cache for one session."""
    pool.ensure_capacity(sid, len(toks))
    llama.prefill(MODEL, pool.cache, list(toks), pool.block_table(sid), 0,
                  len(toks))


# -- tests/test_kvcache.py ----------------------------------------------------


class TestAllocation:
    def test_lazy_growth_by_block(self):
        pool = make_pool()
        assert pool.ensure_capacity(1, 3) == pool.session_blocks(1)
        assert len(pool.session_blocks(1)) == 1
        pool.ensure_capacity(1, 5)
        assert len(pool.session_blocks(1)) == 2
        pool.ensure_capacity(1, 5)
        assert len(pool.session_blocks(1)) == 2
        assert pool.blocks_used() == 2

    def test_exhaustion_is_typed_never_oom(self):
        pool = make_pool(num_blocks=4, cap=8)
        pool.ensure_capacity(1, 16)
        with pytest.raises(KVPoolExhausted):
            pool.ensure_capacity(2, 1)
        with pytest.raises(SessionUnknown):
            pool.session_blocks(2)
        assert pool.blocks_free() == 0

    def test_failed_growth_keeps_existing_blocks(self):
        pool = make_pool(num_blocks=3, cap=8)
        pool.ensure_capacity(1, 8)
        pool.ensure_capacity(2, 4)
        with pytest.raises(KVPoolExhausted):
            pool.ensure_capacity(1, 16)
        assert len(pool.session_blocks(1)) == 2

    def test_per_session_cap(self):
        pool = make_pool(num_blocks=8, cap=2)
        with pytest.raises(KVPoolExhausted):
            pool.ensure_capacity(1, 100)
        assert pool.blocks_used() == 0

    def test_can_admit_probe(self):
        pool = make_pool(num_blocks=4, cap=4)
        assert pool.can_admit(16)
        assert not pool.can_admit(17)
        pool.ensure_capacity(1, 12)
        assert pool.can_admit(4)
        assert not pool.can_admit(8)


class TestChurn:
    def test_fragmentation_free_reuse(self):
        pool = make_pool(num_blocks=8, cap=8)
        for sid in range(4):
            pool.ensure_capacity(sid, 8)
        assert pool.blocks_free() == 0
        pool.free_session(0)
        pool.free_session(2)
        got = pool.ensure_capacity(9, 16)
        assert len(got) == 4
        assert pool.blocks_free() == 0
        for i in range(20):
            pool.free_session(9 if i == 0 else 100 + i - 1)
            pool.ensure_capacity(100 + i, 16)
        assert pool.blocks_used() == 8

    def test_abandon_frees_idempotently(self):
        pool = make_pool()
        pool.ensure_capacity(7, 10)
        assert pool.free_session(7) == 3 and pool.blocks_used() == 0
        assert pool.free_session(7) == 0
        assert pool.free_session(999) == 0

    def test_block_table_sentinel_padding(self):
        pool = make_pool(num_blocks=8, block_size=4, cap=4)
        pool.ensure_capacity(3, 6)
        table = pool.block_table(3)
        assert table.shape == (4,)
        assert list(table[:2]) == pool.session_blocks(3)
        assert all(t == 8 for t in table[2:])
        with pytest.raises(SessionUnknown):
            pool.block_table(4)


class TestMigration:
    def test_export_import_roundtrip_bitwise(self):
        src = make_pool(num_blocks=8, block_size=4, cap=4)
        dst = make_pool(num_blocks=8, block_size=4, cap=4)
        toks = [3, 5, 7, 11, 13, 17]
        pool_prefill(src, 1, toks)
        blocks = src.session_blocks(1)
        host = src.export_session(1, len(toks))
        assert host["k"].shape[1] == len(toks)
        dst.ensure_capacity(99, 2)  # the import lands non-contiguously
        dst.import_session(1, host)
        back = dst.export_session(1, len(toks))
        assert torch.equal(host["k"], back["k"])
        assert torch.equal(host["v"], back["v"])
        assert src.blocks_used() == len(blocks)
        src.free_session(1)

    def test_import_into_full_pool_is_retriable(self):
        src = make_pool(num_blocks=4, block_size=4, cap=4)
        dst = make_pool(num_blocks=3, block_size=4, cap=4)
        src.ensure_capacity(1, 12)
        host = src.export_session(1, 12)
        dst.ensure_capacity(50, 8)
        with pytest.raises(KVPoolExhausted):
            dst.import_session(1, host)
        assert 1 not in dst.sessions()
        dst.free_session(50)
        assert len(dst.import_session(1, host)) == 3

    def test_import_duplicate_refused(self):
        src = make_pool()
        src.ensure_capacity(1, 4)
        host = src.export_session(1, 4)
        dst = make_pool()
        dst.import_session(1, host)
        with pytest.raises(ValueError):
            dst.import_session(1, host)

    def test_import_duplicate_race_atomic(self):
        src = make_pool(num_blocks=8, block_size=4, cap=4)
        src.ensure_capacity(1, 8)
        host = src.export_session(1, 8)
        dst = make_pool(num_blocks=8, block_size=4, cap=4)
        results: list = []
        barrier = threading.Barrier(4)

        def race():
            barrier.wait()
            try:
                dst.import_session(1, host)
                results.append("ok")
            except ValueError:
                results.append("dup")

        threads = [threading.Thread(target=race) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert sorted(results) == ["dup", "dup", "dup", "ok"]
        assert dst.blocks_used() == 2

    def test_evacuate_exports_everything(self):
        pool = make_pool(num_blocks=8, cap=4)
        pool.ensure_capacity(1, 4)
        pool.ensure_capacity(2, 8)
        out = pool.evacuate({1: 4, 2: 8})
        assert set(out) == {1, 2}
        assert out[2]["k"].shape[1] == 8
        assert pool.blocks_used() == 3


class TestAccounting:
    def test_bytes_accounting_matches_cache(self):
        pool = make_pool(num_blocks=8, block_size=4)
        expect = llama.cache_bytes(tfm.TINY, 8, 4)
        assert pool.total_bytes() == expect
        assert pool.bytes_per_block * 8 == expect
        pool.ensure_capacity(1, 8)
        assert pool.used_bytes() == 2 * pool.bytes_per_block

    def test_gauges_registered_and_live(self):
        reg = MetricsRegistry()
        pool = KVBlockPool(tfm.TINY, 8, 4, 4, job="t/kv", replica="r0",
                           registry=reg, device="cpu")
        pool.ensure_capacity(1, 10)
        text = reg.render()
        parse_exposition(text)
        assert 'edl_serving_kv_blocks_used{job="t/kv",replica="r0"} 3' \
            in text
        assert 'edl_serving_kv_blocks_total{job="t/kv",replica="r0"} 8' \
            in text

    def test_one_device_only_and_no_quiet_cpu(self, monkeypatch):
        with pytest.raises(NotImplementedError):
            make_pool(devices=["cpu", "cpu"])
        assert make_pool(devices=["cpu"]).device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            KVBlockPool(tfm.TINY, 8, 4, 4, registry=MetricsRegistry())


# -- test_decode_v2.py: prefix sharing / CoW ----------------------------------


class TestPrefixSharing:
    def test_pool_admit_with_prefix_adopts_sealed_blocks(self):
        pool = make_pool(num_blocks=16, block_size=8, cap=8, job="t/kv2")
        toks = list(range(1, 25))
        pool_prefill(pool, 1, toks)
        assert pool.register_prefix(1, toks) > 0
        assert pool.match_prefix(toks) == 16
        blocks, covered = pool.admit_with_prefix(2, toks, 32)
        assert covered == 16
        shared = pool.session_blocks(1)[:2]
        assert pool.session_blocks(2)[:2] == shared
        assert all(pool.block_refcount(b) == 2 for b in shared)
        assert blocks == pool.session_blocks(2)

    @pytest.mark.timeout_s(120)
    def test_fleet_prefix_hit_skips_reprefill_and_stays_stable(self):
        job = "t/prefix-fleet"
        fl = DecodeFleet(MODEL, tfm.TINY, job=job, slots=4, prefill_chunk=8,
                         kv_blocks=64, kv_block_size=8,
                         max_blocks_per_session=8, device="cpu")
        p = list(range(7, 31))
        try:
            first = fl.submit(list(p), max_new_tokens=8).wait(60)
            again = fl.submit(list(p), max_new_tokens=8).wait(60)
        finally:
            fl.stop(drain=False)
        assert again == first == ref_decode(p, 8)
        assert counter_sum("edl_kv_prefix_hits_total", job) >= 1
        assert counter_sum("edl_kv_prefix_tokens_saved_total", job) >= 8

    def test_fork_session_cow_preserves_and_diverges(self):
        pool = make_pool(num_blocks=16, block_size=8, cap=8,
                         job="t/kv2-cow")
        toks = list(range(3, 15))
        pool_prefill(pool, 1, toks)
        src = pool.export_session(1, len(toks))
        assert pool.fork_session(1, 2) == pool.session_blocks(1)
        assert all(pool.block_refcount(b) == 2
                   for b in pool.session_blocks(1))
        assert pool.make_writable(2, 8, len(toks)) == 1
        assert pool.session_blocks(2)[1] != pool.session_blocks(1)[1]
        assert pool.block_refcount(pool.session_blocks(1)[1]) == 1
        assert counter_sum("edl_kv_cow_copies_total", "t/kv2-cow") == 1
        for sid in (1, 2):
            got = pool.export_session(sid, len(toks))
            for name in ("k", "v"):
                assert torch.equal(got[name], src[name])


# -- test_decode_v2.py: int8 KV quantization ----------------------------------


class TestQuantizedPool:
    def test_int8_roundtrip_bounded_error_and_smaller_pool(self):
        fp = make_pool(num_blocks=16, block_size=8, cap=8)
        q8 = make_pool(num_blocks=16, block_size=8, cap=8, quantize="int8")
        toks = list(range(1, 13))
        pool_prefill(fp, 1, toks)
        pool_prefill(q8, 1, toks)
        ref = fp.export_session(1, len(toks))
        got = q8.export_session(1, len(toks))
        for name in ("k", "v"):
            r, g = ref[name].numpy(), got[name].numpy()
            # layer 0: the exact symmetric per-row int8 error
            bound = (np.abs(r[0]).max(axis=(-1, -2), keepdims=True)
                     / 127.0) * 0.5 + 1e-6
            assert (np.abs(r[0] - g[0]) <= bound).all()
            assert np.abs(r - g).max() <= 0.05 * np.abs(r).max()
        assert q8.total_bytes() < 0.5 * fp.total_bytes()

    def test_d2d_import_rejects_storage_mode_mismatch(self):
        fp = make_pool(num_blocks=16, block_size=8, cap=8)
        q8 = make_pool(num_blocks=16, block_size=8, cap=8, quantize="int8")
        pool_prefill(fp, 1, list(range(1, 10)))
        payload = fp.export_session_device(1, 9)
        with pytest.raises(ValueError, match="storage modes"):
            q8.reserve_import_device(7, payload)
        assert 7 not in q8.sessions()


# -- test_decode_v2.py: D2D migration -----------------------------------------


class TestD2DMigration:
    def test_pool_roundtrip_bitwise_with_ici_accounting(self):
        src = make_pool(num_blocks=16, block_size=8, cap=8)
        dst = make_pool(num_blocks=16, block_size=8, cap=8, job="t/kv2-d2d")
        toks = list(range(1, 19))
        pool_prefill(src, 1, toks)
        ref = src.export_session(1, len(toks))
        payload = src.export_session_device(1, len(toks))
        blocks = dst.reserve_import_device(1, payload)
        dst.apply_import_device(1, blocks, payload)
        got = dst.export_session(1, len(toks))
        for name in ("k", "v"):
            assert torch.equal(got[name], ref[name])
        assert payload.plan.bytes_total == payload.nbytes
        assert counter_sum("edl_kv_migration_bytes_total", "t/kv2-d2d",
                           'path="ici"') == payload.nbytes

    @pytest.mark.timeout_s(120)
    def test_fleet_scale_down_migrates_d2d_zero_drops(self):
        fl = DecodeFleet(MODEL, tfm.TINY, job="t/d2d-fleet",
                         roles={"decode": 2}, slots=4, prefill_chunk=8,
                         kv_blocks=64, kv_block_size=8,
                         max_blocks_per_session=8, device="cpu")
        ps = [[9, 8, 7, 6], [1, 2, 3], list(PERIODIC), [44, 45]]
        try:
            ss = [fl.submit(list(p), max_new_tokens=48) for p in ps]
            deadline = time.time() + 60
            while (time.time() < deadline
                   and not all(s.ttft_s > 0 for s in ss)):
                time.sleep(0.01)
            assert fl.scale_to(1) == 1
            outs = [s.wait(60) for s in ss]
        finally:
            fl.stop(drain=False)
        assert outs == ref_decode_many(ps, 48)
        assert fl.sessions_failed == 0
        assert fl.migrations >= 1
        assert fl.migration_bytes_d2d > 0
        assert fl.migration_bytes_host == 0
        assert (fl.migration_bytes_d2d
                <= fl.migration_bytes_host_roundtrip_baseline)


def test_plan_move_matches_plan_reshard():
    """A one-device to one-device move priced like ``plan_reshard`` prices
    the same placements: the same device keeps every byte, another device
    fetches every byte from one leaving the destination's mesh."""
    from edl_tpu.runtime.kvcache import _named_view

    pool = make_pool(num_blocks=8, block_size=4, cap=4, quantize="int8")
    pool.ensure_capacity(1, 9)
    payload = pool.export_session_device(1, 9)
    arrays = {n: jax.device_put(t.numpy(), jax.devices()[0])
              for n, t in payload.arrays.items()}
    for dst, port_dst in ((0, "cpu"), (1, "meta")):
        moved = {n: jax.device_put(a, jax.devices()[dst])
                 for n, a in arrays.items()}
        ref = plan_reshard(
            {n: jax.ShapeDtypeStruct(a.shape, a.dtype)
             for n, a in arrays.items()},
            {n: _named_view(a) for n, a in arrays.items()},
            {n: _named_view(moved[n]) for n in arrays})
        got = plan_move(payload.arrays, torch.device(port_dst))
        assert (got.bytes_total, got.bytes_stay, got.bytes_ici,
                got.bytes_dcn) == (ref.bytes_total, ref.bytes_stay,
                                   ref.bytes_ici, ref.bytes_dcn)


# -- churn: the property sweep, and the JAX pool side by side -----------------


def _churn_ops(pools, rng, lengths, prompts, next_sid, exhausted):
    """The randomized operations of test_decode_v2's churn sweep, each
    applied to every pool in ``pools`` with the same draws; ``exhausted``
    holds the pool-exhaustion exception types.  Returns the op list."""

    def each(fn):
        outs = []
        for pool in pools:
            try:
                outs.append(("ok", fn(pool)))
            except exhausted:
                outs.append(("exhausted", None))
        assert all(o == outs[0] for o in outs), outs
        return outs[0][0] == "ok"

    def op_admit():
        sid = next_sid[0]
        next_sid[0] += 1
        n = int(rng.integers(2, 13))
        if each(lambda p: p.ensure_capacity(sid, n)):
            lengths[sid] = n

    def op_extend():
        if not lengths:
            return
        sid = int(rng.choice(list(lengths)))
        n = lengths[sid] + int(rng.integers(1, 5))
        if each(lambda p: p.ensure_capacity(sid, n)):
            lengths[sid] = n

    def op_share():
        if not lengths:
            return
        src = int(rng.choice(list(lengths)))
        if src not in prompts:
            toks = [int(t) for t in rng.integers(1, 255, size=lengths[src])]
            each(lambda p: p.register_prefix(src, toks))
            prompts[src] = toks
            return
        sid = next_sid[0]
        next_sid[0] += 1
        total = len(prompts[src]) + int(rng.integers(1, 5))
        if each(lambda p: p.admit_with_prefix(sid, prompts[src], total)):
            lengths[sid] = len(prompts[src])

    def op_fork():
        if not lengths:
            return
        src = int(rng.choice(list(lengths)))
        sid = next_sid[0]
        next_sid[0] += 1
        each(lambda p: p.fork_session(src, sid))
        lengths[sid] = lengths[src]

    def op_cow():
        if not lengths:
            return
        sid = int(rng.choice(list(lengths)))
        end = lengths[sid]
        each(lambda p: p.make_writable(sid, max(end - 3, 0), end))

    def op_migrate():
        if not lengths:
            return
        sid = int(rng.choice(list(lengths)))
        n = lengths.pop(sid)
        prompts.pop(sid, None)

        def move(pool):
            payload = pool.export_session_device(sid, n)
            pool.free_session(sid)
            blocks = pool.reserve_import_device(sid, payload)
            pool.apply_import_device(sid, blocks, payload)
            return blocks

        if each(move):
            lengths[sid] = n

    def op_free():
        if not lengths:
            return
        sid = int(rng.choice(list(lengths)))
        each(lambda p: p.free_session(sid))
        del lengths[sid]
        prompts.pop(sid, None)

    return [op_admit, op_admit, op_extend, op_share, op_fork, op_cow,
            op_migrate, op_free, op_free]


class TestChurnProperty:
    def test_500_op_churn_conserves_blocks_and_refcounts(self):
        reg = MetricsRegistry()
        pool = make_pool(num_blocks=24, block_size=4, cap=6, job="t/kv2",
                         registry=reg, replica="r0")
        rng = np.random.default_rng(19)
        lengths: dict[int, int] = {}
        ops = _churn_ops([pool], rng, lengths, {}, [1], KVPoolExhausted)

        def check_invariants():
            distinct = set()
            refsum = 0
            for sid in list(lengths):
                bs = pool.session_blocks(sid)
                distinct.update(bs)
                refsum += len(bs)
            assert pool.blocks_used() == len(distinct)
            assert sum(pool.block_refcount(b)
                       for b in range(pool.num_blocks)) == refsum
            assert (f'edl_serving_kv_blocks_used'
                    f'{{job="t/kv2",replica="r0"}} {len(distinct)}'
                    in reg.render())

        for i in range(520):
            ops[int(rng.integers(len(ops)))]()
            if i % 40 == 0:
                check_invariants()
        for sid in list(lengths):
            pool.free_session(sid)
            del lengths[sid]
        check_invariants()
        assert pool.blocks_used() == 0

    @pytest.mark.timeout_s(120)
    def test_500_op_churn_agrees_with_the_jax_pool(self):
        """The same seeded churn through both pools: after every operation
        the same tables, refcounts, free lists and byte accounting."""
        jpool = jkv.KVBlockPool(JTINY, 24, 4, 6, job="t/kv-diff",
                                registry=JaxRegistry())
        tpool = make_pool(num_blocks=24, block_size=4, cap=6,
                          job="t/kv-diff")
        rng = np.random.default_rng(23)
        lengths: dict[int, int] = {}
        ops = _churn_ops([jpool, tpool], rng, lengths, {}, [1],
                         (KVPoolExhausted, jkv.KVPoolExhausted))
        c0 = {name: jax_counters().get(name, job="t/kv-diff")
              for name in ("kv_cow_copies", "kv_prefix_hits",
                           "serving_kv_admission_rejects")}
        for _ in range(500):
            ops[int(rng.integers(len(ops)))]()
            assert jpool.sessions() == tpool.sessions()
            for sid in jpool.sessions():
                assert jpool.session_blocks(sid) == tpool.session_blocks(sid)
                assert np.array_equal(jpool.block_table(sid),
                                      tpool.block_table(sid))
            assert [jpool.block_refcount(b) for b in range(24)] \
                == [tpool.block_refcount(b) for b in range(24)]
            assert list(jpool._free) == list(tpool._free)
            assert list(jpool._cached_free) == list(tpool._cached_free)
            assert (jpool.blocks_used(), jpool.blocks_free(),
                    jpool.blocks_cached()) == (tpool.blocks_used(),
                                               tpool.blocks_free(),
                                               tpool.blocks_cached())
            assert (jpool.used_bytes(), jpool.total_bytes()) \
                == (tpool.used_bytes(), tpool.total_bytes())
        for name, before in c0.items():
            assert (jax_counters().get(name, job="t/kv-diff") - before
                    == get_counters().get(name, job="t/kv-diff"))
        assert (jax_counters().get("kv_migration_bytes", job="t/kv-diff",
                                   path="ici")
                == get_counters().get("kv_migration_bytes", job="t/kv-diff",
                                      path="ici") > 0)
