"""The port's token-level decode serving (edl_tpu_torch.runtime.serving) at
TINY fp32 on the CPU: the scenarios of tests/test_decode.py's parity,
scheduler, bounded-admission, live-resize, rolling-reload, kill-drill,
disaggregation and stats classes, and test_decode_v2.py's speculative and
adaptive-scheduler classes.  Every continuation is held token-equal to the
JAX package's full-context greedy ``apply``; speculative decode to the
port's single-token decode.

``reload_from_lineage`` and ``watch_lineage`` read real lineages: one that
an fsdp-2 trainer wrote on a spawned gloo world of two ranks
(tests/torch_world.py, ``suite_lineage``), decoded token-equal to the JAX
package's ``apply`` on the weights it saved, and ones a one-process trainer
writes while a watcher polls.  Left out: the /generate front door, LB
affinity and the serving scaler (not ported).
The two import-admission scenarios park the source replica at a chosen
point instead of racing its loop, so they hold the contract their
docstrings state, not a timing."""

from __future__ import annotations

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

import torch_world as tw
from edl_tpu.observability.metrics import iter_samples, parse_exposition
from edl_tpu_torch.models import llama, transformer as tfm
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
from edl_tpu_torch.runtime.elastic import ElasticTrainer
from edl_tpu_torch.runtime.kvcache import KVPoolExhausted
from edl_tpu_torch.runtime.serving import (
    PRI_HIGH,
    PRI_LOW,
    PRI_NORMAL,
    S_DECODING,
    S_PREFILL,
    DecodeFleet,
    DecodeSession,
    SessionDropped,
    TokenScheduler,
)
from tests.torch_decode_ref import (
    MODEL,
    PARAMS,
    port_model,
    ref_decode,
    ref_decode_many,
    ref_decode_with,
)

RNG = np.random.default_rng(7)
#: a prompt whose greedy continuation drafts well (test_decode_v2's)
PERIODIC = [11, 4, 11, 4, 11, 4, 11, 4]
fleet_test = pytest.mark.timeout_s(120)


def make_fleet(**kw) -> DecodeFleet:
    kw.setdefault("job", "t/decode")
    kw.setdefault("roles", {"decode": 1})
    kw.setdefault("slots", 4)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("kv_blocks", 32)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("max_blocks_per_session", 8)
    return DecodeFleet(MODEL, tfm.TINY, device="cpu", **kw)


def prompts(n, lo=3, hi=12):
    return [RNG.integers(1, 255, size=int(RNG.integers(lo, hi))).tolist()
            for _ in range(n)]


def counter_sum(name: str, job: str) -> float:
    series = parse_exposition(get_registry().render())
    return sum(v for k, v in series.items()
               if k.startswith(name) and f'job="{job}"' in k)


def park_after_first_token(replica, sess: DecodeSession) -> None:
    """Ask ``replica``'s loop to park at the iteration boundary right after
    ``sess`` emits its first token (the request is made on the loop thread
    inside that iteration, so no second token can land first)."""
    def on_token(s, tok):
        if len(s.generated) == 1:
            with replica._cond:
                replica._quiesced.clear()
                replica._resume.clear()
                replica._quiesce_req = True
    sess.on_token = on_token


class TestDecodeParity:
    @fleet_test
    def test_single_session_matches_reference(self):
        fleet = make_fleet()
        try:
            p = [5, 9, 17, 33]
            assert fleet.submit(p, max_new_tokens=8).wait(60) \
                == ref_decode(p, 8)
        finally:
            fleet.stop()

    @fleet_test
    def test_concurrent_sessions_all_match(self):
        fleet = make_fleet(slots=3)
        try:
            ps = prompts(8)
            ss = [fleet.submit(p, max_new_tokens=6) for p in ps]
            assert [s.wait(60) for s in ss] == ref_decode_many(ps, 6)
            assert fleet.sessions_failed == 0
        finally:
            fleet.stop()

    @fleet_test
    def test_eos_frees_slot_early(self):
        fleet = make_fleet(eos_id=ref_decode([5, 9, 17, 33], 3)[2])
        try:
            out = fleet.submit([5, 9, 17, 33], max_new_tokens=50).wait(60)
            assert out == ref_decode([5, 9, 17, 33], 3)
            assert fleet.sessions_active() == 0
            assert fleet.kv_blocks()[0] == 0
        finally:
            fleet.stop()

    @fleet_test
    def test_chunked_prefill_long_prompt(self):
        fleet = make_fleet(prefill_chunk=4, kv_block_size=4, kv_blocks=64,
                           max_blocks_per_session=16)
        try:
            p = RNG.integers(1, 255, size=30).tolist()  # 8 chunks
            assert fleet.submit(p, max_new_tokens=5).wait(60) \
                == ref_decode(p, 5)
        finally:
            fleet.stop()


class TestScheduler:
    def test_wfq_favors_high_priority(self):
        sched = TokenScheduler()
        order = []
        pend = []
        for i in range(12):
            s = DecodeSession([1] * 8, 4,
                              priority=[PRI_HIGH, PRI_LOW][i % 2], id=i)
            sched.stamp(s)
            pend.append(s)
        while pend:
            s = sched.pick_prefill(pend)
            order.append(s.priority)
            pend.remove(s)
        assert order[:6].count(PRI_HIGH) >= 4
        assert PRI_LOW in order[:8]

    def test_interleave_budget_protects_decode(self):
        sched = TokenScheduler(decode_per_prefill=3)
        assert sched.allow_prefill(decoding=0, prefill_pending=1)
        assert not sched.allow_prefill(decoding=2, prefill_pending=1)
        for _ in range(3):
            sched.note_decode()
        assert sched.allow_prefill(decoding=2, prefill_pending=1)
        sched.note_prefill()
        assert not sched.allow_prefill(decoding=2, prefill_pending=1)
        assert not sched.allow_prefill(decoding=0, prefill_pending=0)

    @fleet_test
    def test_priorities_complete_under_load(self):
        fleet = make_fleet(slots=2)
        try:
            ps = prompts(6)
            ss = [fleet.submit(p, max_new_tokens=5,
                               priority=[PRI_HIGH, PRI_NORMAL,
                                         PRI_LOW][i % 3])
                  for i, p in enumerate(ps)]
            assert [s.wait(60) for s in ss] == ref_decode_many(ps, 5)
        finally:
            fleet.stop()


class TestBoundedAdmission:
    @fleet_test
    def test_oversized_session_rejected_typed(self):
        fleet = make_fleet(kv_blocks=8, max_blocks_per_session=2,
                           kv_block_size=4, max_queued_sessions=2)
        try:
            with pytest.raises(KVPoolExhausted):
                fleet.submit([1] * 20, max_new_tokens=20)
            assert fleet.sessions_active() == 0
        finally:
            fleet.stop()

    @fleet_test
    def test_pool_pressure_queues_then_drains(self):
        fleet = make_fleet(kv_blocks=8, kv_block_size=4,
                           max_blocks_per_session=4, slots=4)
        try:
            ps = prompts(6, 3, 6)
            ss = [fleet.submit(p, max_new_tokens=4) for p in ps]
            assert [s.wait(60) for s in ss] == ref_decode_many(ps, 4)
        finally:
            fleet.stop()

    @fleet_test
    def test_token_outside_the_vocabulary_rejected(self):
        fleet = make_fleet()
        try:
            for bad in ([5, tfm.TINY.vocab_size], [-1, 5]):
                with pytest.raises(ValueError, match="vocabulary"):
                    fleet.submit(bad, max_new_tokens=4)
            assert fleet.sessions_active() == 0
            assert fleet.submit([5, 9], max_new_tokens=3).wait(60) \
                == ref_decode([5, 9], 3)
        finally:
            fleet.stop()

    @fleet_test
    def test_queue_cap_sheds(self):
        fleet = make_fleet(kv_blocks=4, kv_block_size=4,
                           max_blocks_per_session=4, max_queued_sessions=2)
        try:
            fleet.submit([1] * 8, max_new_tokens=8)
            fleet.submit([1] * 8, max_new_tokens=8)
            with pytest.raises(KVPoolExhausted):
                for _ in range(8):
                    fleet.submit([1] * 8, max_new_tokens=8)
        finally:
            fleet.stop(drain=False)


class TestLiveResize:
    @fleet_test
    def test_scale_down_zero_drops_bitwise_stable(self):
        """A 2→1 scale-down mid-decode drops no session and every
        continuation equals the undisturbed reference."""
        fleet = make_fleet(roles={"decode": 2}, kv_blocks=64)
        try:
            ps = prompts(6, 6, 10)
            ss = [fleet.submit(p, max_new_tokens=40) for p in ps]
            for s in ss:
                s.wait_first_token(60)
            assert fleet.scale_to(1) == 1
            assert [s.wait(60) for s in ss] == ref_decode_many(ps, 40)
            assert fleet.sessions_failed == 0
            assert fleet.sessions_completed == len(ps)
            assert fleet.migrations >= 1
        finally:
            fleet.stop()

    @fleet_test
    def test_scale_down_after_many_tokens_reserves_the_full_span(self):
        """A session holding 20 generated tokens on the leaving replica
        migrates reserving its prompt plus its max_new_tokens — not its
        resumed history plus max_new_tokens, 19 tokens over the per-session
        cap of 64 here — and finishes token-equal; no session fails, and
        completed + failed equals submitted.  The session's loop is held at
        its 20th token until the scale-down asks the replica to park, so it
        migrates with exactly 20."""
        fleet = make_fleet(roles={"decode": 2}, kv_blocks=64)
        try:
            victim = [r for r in fleet._replicas if r.role == "decode"][-1]
            reached, at_park = threading.Event(), []

            def hold_at_20(s, tok):
                if len(s.generated) == 20:
                    reached.set()
                    while not victim._quiesce_req:
                        time.sleep(0.001)
                    at_park.append(len(s.generated))

            ps = prompts(2, 6, 10)
            stay = fleet.submit(ps[0], max_new_tokens=40)
            moved = fleet.submit(ps[1], max_new_tokens=40,
                                 on_token=hold_at_20)
            assert reached.wait(60)
            assert fleet.scale_to(1) == 1
            assert [stay.wait(60), moved.wait(60)] == ref_decode_many(ps, 40)
            assert at_park == [20]
            assert (stay.migrations, moved.migrations) == (0, 1)
            assert fleet.sessions_failed == 0
            assert (fleet.sessions_completed + fleet.sessions_failed
                    == fleet.sessions_submitted == 2)
        finally:
            fleet.stop()

    @fleet_test
    def test_scale_up_then_down_conserves_sessions(self):
        fleet = make_fleet(roles={"decode": 1})
        try:
            ss = [fleet.submit(p, max_new_tokens=12) for p in prompts(4)]
            assert fleet.scale_to(3) == 3
            assert fleet.scale_to(1) == 1
            for s in ss:
                s.wait(60)
            assert (fleet.sessions_completed + fleet.sessions_failed
                    == fleet.sessions_submitted)
            assert fleet.sessions_failed == 0
        finally:
            fleet.stop()

    @fleet_test
    def test_mid_prefill_export_resumes_prefill(self):
        """A session evacuated mid-chunked-prefill (cached > 0, no token
        emitted) travels its partial cache and resumes PREFILL on the
        adopter.  The source is parked first and stepped one chunk by
        hand, so the park lands mid-prefill every time."""
        fleet = make_fleet(roles={"decode": 2}, prefill_chunk=2,
                           kv_block_size=4, kv_blocks=64,
                           max_blocks_per_session=32)
        try:
            src, dst = [r for r in fleet._replicas if r.role == "decode"]
            p = RNG.integers(1, 255, size=100).tolist()  # 50 chunks
            assert src.quiesce(30)
            sess = DecodeSession(p, 4, id=90_000)
            src.submit(sess)
            with src._cond:  # the loop is parked: the test owns it
                src._admit_locked()
            src._prefill_one(sess)
            assert sess.cached == 2 and not sess.generated
            (m, kv), = src.export_all()
            src.resume()
            assert m is sess and kv is not None
            assert kv["k"].shape[1] == sess.cached < len(p)
            dst.import_session(sess, kv)
            assert sess.state == S_PREFILL  # NOT decode over nothing
            assert sess.wait(60) == ref_decode(p, 4)
            assert fleet.sessions_failed == 0
        finally:
            fleet.stop()

    @fleet_test
    def test_scale_down_during_prefill_zero_drops(self):
        fleet = make_fleet(roles={"decode": 2}, prefill_chunk=2,
                           kv_block_size=4, kv_blocks=128,
                           max_blocks_per_session=32)
        try:
            ps = prompts(4, 40, 80)
            ss = [fleet.submit(p, max_new_tokens=4) for p in ps]
            assert fleet.scale_to(1) == 1  # mid-prefill for most
            assert [s.wait(60) for s in ss] == ref_decode_many(ps, 4)
            assert fleet.sessions_failed == 0
            assert fleet.sessions_completed == len(ps)
        finally:
            fleet.stop()

    @fleet_test
    def test_admission_defers_until_scatter_applied(self):
        """A session imported with its cache is not slotted before its
        deferred K/V scatter lands: admission skips sids with a pending
        import, and the drain at the next iteration boundary releases
        them."""
        fleet = make_fleet(roles={"decode": 2}, kv_blocks=8,
                           kv_block_size=8, max_blocks_per_session=8)
        try:
            src, dst = [r for r in fleet._replicas if r.role == "decode"]
            p = RNG.integers(1, 255, size=30).tolist()
            sess = DecodeSession(p, 2, id=91_000)
            park_after_first_token(src, sess)
            src.submit(sess)
            sess.wait_first_token(60)
            assert src._quiesced.wait(30)
            (m, kv), = src.export_all()
            src.resume()
            assert m is sess and kv is not None
            assert dst.quiesce(30)
            dst.import_session(sess, kv)
            assert sess.state == S_DECODING
            with dst._cond:
                dst._admit_locked()
            # the scatter is still pending: no slot
            assert sess.slot is None and sess in dst._queue
            dst._drain_imports()  # the loop is parked
            with dst._cond:
                dst._admit_locked()
            assert sess.slot is not None
            dst.resume()
            assert sess.wait(60) == ref_decode(p, 2)
            assert fleet.sessions_failed == 0
        finally:
            fleet.stop()

    @fleet_test
    def test_can_admit_skips_already_reserved_imports(self):
        """A queued session that already owns its pool blocks (imported
        with its cache) does not also count its full reservation toward
        queued demand."""
        fleet = make_fleet(roles={"decode": 2}, kv_blocks=8,
                           kv_block_size=8, max_blocks_per_session=8)
        try:
            src, dst = [r for r in fleet._replicas if r.role == "decode"]
            p = RNG.integers(1, 255, size=30).tolist()  # a 32-token span
            sess = DecodeSession(p, 2, id=92_000)
            park_after_first_token(src, sess)
            src.submit(sess)
            sess.wait_first_token(60)
            assert src._quiesced.wait(30)
            (m, kv), = src.export_all()
            src.resume()
            assert dst.quiesce(30)
            dst.import_session(sess, kv)  # 4 blocks reserved, queued
            assert dst.pool.blocks_free() == 4
            # an identical 4-block session fits the other half of the pool
            assert dst.can_admit(30, 2)
            dst.resume()
            assert sess.wait(60) == ref_decode(p, 2)
        finally:
            fleet.stop()

    @fleet_test
    def test_full_survivor_adopts_session_by_reprefill(self):
        """A survivor too full to adopt the cache still adopts the SESSION
        (re-prefill of its known history)."""
        fleet = make_fleet(roles={"decode": 2}, kv_blocks=8,
                           kv_block_size=4, max_blocks_per_session=8)
        try:
            ps = prompts(4, 4, 7)
            ss = [fleet.submit(p, max_new_tokens=10) for p in ps]
            for s in ss:
                s.wait_first_token(60)
            fleet.scale_to(1)
            assert [s.wait(60) for s in ss] == ref_decode_many(ps, 10)
            assert fleet.sessions_failed == 0
        finally:
            fleet.stop()


class TestRollingReload:
    @fleet_test
    def test_rolling_reload_live_decode(self):
        """A reload lands at an iteration boundary with every in-flight
        session's cache kept: no session dropped, and the same values in
        fresh tensors give the same continuations."""
        fleet = make_fleet(roles={"decode": 2})
        try:
            ps = prompts(5, 5, 9)
            ss = [fleet.submit(p, max_new_tokens=14) for p in ps]
            for s in ss:
                s.wait_first_token(60)
            p2 = port_model(jax.tree.map(lambda a: a * 1.0, PARAMS))
            assert fleet.rolling_reload(p2, generation=3) == 2
            assert fleet.generation == 3
            assert all(r.generation == 3 for r in fleet._replicas)
            assert [s.wait(60) for s in ss] == ref_decode_many(ps, 14)
            assert fleet.sessions_failed == 0
        finally:
            fleet.stop()


class TestReloadFromLineage:
    """The reference's lineage reloads (test_decode.py::TestRollingReload),
    and the same on real lineages."""

    @fleet_test
    def test_reload_from_lineage_verified_only(self):
        class FakeCkpt:
            def latest_verified_step(self):
                return 5

            def manifest_verified(self, step):
                return True

            def restore(self, template, step=None):
                self.last_restored_step = step
                return {"params": llama.param_tree(MODEL)}

        fleet = make_fleet()
        try:
            ck = FakeCkpt()
            assert fleet.reload_from_lineage(ck) == 5
            assert fleet.generation == 5
            # not newer → no-op
            assert fleet.reload_from_lineage(ck) is None
        finally:
            fleet.stop()

    @fleet_test
    def test_reload_skips_unverified(self):
        class BadCkpt:
            def latest_verified_step(self):
                return 9

            def manifest_verified(self, step):
                return False

            def restore(self, template, step=None):  # pragma: no cover
                raise AssertionError("must not restore unverified")

        fleet = make_fleet()
        skipped = get_counters().get("serving_reload_skipped_unverified")
        try:
            assert fleet.reload_from_lineage(BadCkpt()) is None
            assert fleet.generation == 0
            assert get_counters().get(
                "serving_reload_skipped_unverified") == skipped + 1
        finally:
            fleet.stop()

    @pytest.mark.timeout_s(240)
    def test_reload_from_an_fsdp_lineage_decodes_token_equal(self,
                                                           tmp_path):
        """An fsdp-2 trainer's lineage (two steps from the JAX init): the
        fleet ships its newest step and decodes as the JAX package's
        ``apply`` does on the weights saved."""
        directory = tmp_path / "lineage"
        saved = tw.scenario(tw.run(
            "lineage", 2, tmp_path, 180, tiny_params=tw_params(),
            batches=[_rows(1), _rows(2)], directory=str(directory)),
            "write")[0]
        jparams = jax.tree_util.tree_map_with_path(
            lambda path, _: saved["['params']" + jax.tree_util.keystr(path)],
            PARAMS)
        fleet = make_fleet()
        try:
            assert fleet.reload_from_lineage(
                ElasticCheckpointer(directory)) == 2
            assert fleet.generation == 2
            assert all(r.generation == 2 for r in fleet._replicas)
            ps = prompts(4, 5, 9)
            ss = [fleet.submit(p, max_new_tokens=10) for p in ps]
            got = [s.wait(60) for s in ss]
            assert got == ref_decode_with(jparams, ps, 10)
            assert got != ref_decode_many(ps, 10)  # the weights changed
        finally:
            fleet.stop()

    @fleet_test
    def test_watch_lineage_picks_up_a_step_while_sessions_decode(
            self, tmp_path):
        ck = ElasticCheckpointer(tmp_path)
        fleet = make_fleet(roles={"decode": 2}, max_blocks_per_session=12)
        try:
            watcher = fleet.watch_lineage(ElasticCheckpointer(tmp_path),
                                          poll_s=0.1)
            # each token waits 5 ms on its replica's loop: the sessions
            # outlast the save and the pickup
            ss = [fleet.submit(p, max_new_tokens=80,
                               on_token=lambda s, tok: time.sleep(0.005))
                  for p in prompts(4, 5, 9)]
            for s in ss:
                s.wait_first_token(60)
            t = _trainer()
            t.step(_rows(1))
            ck.save(1, t.whole_state)
            t0 = time.monotonic()
            while fleet.generation != 1 and time.monotonic() - t0 < 5:
                time.sleep(0.02)
            assert fleet.generation == 1
            assert any(not s.done for s in ss)  # picked up mid-decode
            for s in ss:
                assert len(s.wait(60)) == 80
            assert fleet.sessions_failed == 0
            assert all(r.generation == 1 for r in fleet._replicas)
        finally:
            fleet.stop()
        assert not watcher.is_alive()  # the fleet's stop stopped it

    @fleet_test
    def test_step_without_its_manifest_yet_is_left_for_later(self,
                                                             tmp_path):
        """A step whose files are down but whose manifest is still owed
        (its writer has not fingerprinted it) is neither shipped nor
        counted; once the manifest lands it ships."""
        ck = ElasticCheckpointer(tmp_path)
        t = _trainer()
        t.step(_rows(1))
        ck.save(1, t.whole_state, wait=False)
        ck.wait_pending()
        assert (tmp_path / "1").is_dir() and ck.manifest(1) is None
        fleet = make_fleet()
        skipped = get_counters().get("serving_reload_skipped_unverified")
        try:
            assert fleet.reload_from_lineage(ElasticCheckpointer(tmp_path)) \
                is None
            assert fleet.generation == 0
            ck.finalize()
            assert fleet.reload_from_lineage(ElasticCheckpointer(tmp_path)) \
                == 1
            assert get_counters().get(
                "serving_reload_skipped_unverified") == skipped
        finally:
            fleet.stop()

    @fleet_test
    def test_forged_step_is_not_shipped(self, tmp_path):
        """A step whose manifest claims other leaves than its files hold
        restores as the step before it, so it is skipped and counted."""
        ck = ElasticCheckpointer(tmp_path)
        t = _trainer()
        fleet = make_fleet()
        try:
            for step in (1, 2):
                t.step(_rows(step))
                ck.save(step, t.whole_state)
                if step == 1:
                    assert fleet.reload_from_lineage(ck) == 1
            path = tmp_path / ".integrity" / "2.json"
            manifest = json.loads(path.read_text())
            key = "['params']['embed']"
            forged = int(manifest["leaves"][key], 16) ^ 1
            manifest["leaves"][key] = f"{forged:016x}"
            path.write_text(json.dumps(manifest))
            skipped = get_counters().get("serving_reload_skipped_unverified")
            assert fleet.reload_from_lineage(ck) is None
            assert fleet.generation == 1
            assert get_counters().get(
                "serving_reload_skipped_unverified") == skipped + 1
        finally:
            fleet.stop()


@fleet_test
def test_flagship_decode_fleet_serves_the_weights_it_is_given():
    """The entry point takes a model's weights nested as a checkpoint
    restores them."""
    from edl_tpu_torch.entry import flagship_decode_fleet

    fleet = flagship_decode_fleet(device="cpu", cfg=tfm.TINY,
                                  params=llama.param_tree(MODEL), slots=4,
                                  prefill_chunk=8, kv_block_size=8,
                                  max_blocks_per_session=8, kv_blocks=32)
    try:
        ps = prompts(3, 5, 9)
        assert [fleet.submit(p, max_new_tokens=8).wait(60) for p in ps] \
            == ref_decode_many(ps, 8)
    finally:
        fleet.stop()


def tw_params():
    return jax.tree.map(np.asarray, PARAMS)


def _rows(seed, b=4, s=32):
    tokens = np.random.default_rng(seed).integers(0, 256, (b, s),
                                                  dtype=np.int64)
    return tokens, np.roll(tokens, -1, axis=1)


def _trainer() -> ElasticTrainer:
    """A one-process trainer on the fleet's TINY weights."""
    return ElasticTrainer(tfm.loss_fn, port_model(), optim.adamw(1e-3),
                          devices=[torch.device("cpu")])


class TestKillDrill:
    @fleet_test
    def test_kill_rescues_by_recompute(self):
        """A killed replica's cache is gone; survivors re-prefill each
        session's known history and continue token-equal.  Both loops are
        parked before the kill, so the victim still holds sessions."""
        fleet = make_fleet(roles={"decode": 2}, kv_blocks=64)
        try:
            ps = prompts(6, 5, 9)
            ss = [fleet.submit(p, max_new_tokens=12) for p in ps]
            for s in ss:
                s.wait_first_token(60)
            assert all(r.quiesce(30) for r in fleet._replicas)
            victim = next(r for r in fleet._replicas
                          if r.sessions_active() > 0)
            assert fleet.kill_replica(victim.name) >= 1
            for r in fleet._replicas:
                r.resume()
            assert [s.wait(60) for s in ss] == ref_decode_many(ps, 12)
            assert fleet.sessions_failed == 0
        finally:
            fleet.stop()

    @fleet_test
    def test_kill_last_replica_fails_typed(self):
        fleet = make_fleet(roles={"decode": 1})
        try:
            ss = [fleet.submit(p, max_new_tokens=30) for p in prompts(3)]
            for s in ss:
                s.wait_first_token(60)
            only = fleet._replicas[0]
            assert only.quiesce(30)  # no session may finish first
            assert fleet.kill_replica(only.name) == 0
            for s in ss:
                with pytest.raises(SessionDropped):
                    s.wait(10)
            assert fleet.sessions_failed == len(ss)
        finally:
            fleet.stop()

    @fleet_test
    def test_abandoned_sessions_free_on_stop(self):
        fleet = make_fleet()
        try:
            ss = [fleet.submit(p, max_new_tokens=50) for p in prompts(2)]
            for s in ss:
                s.wait_first_token(60)
            assert fleet._replicas[0].quiesce(30)  # none may finish first
        finally:
            fleet.stop(drain=False)
        for s in ss:
            with pytest.raises(SessionDropped):
                s.wait(10)
        assert fleet.kv_blocks()[0] == 0


class TestDisaggregation:
    @fleet_test
    def test_prefill_decode_handoff_parity(self):
        fleet = make_fleet(roles={"prefill": 1, "decode": 2})
        try:
            ps = prompts(5, 5, 10)
            ss = [fleet.submit(p, max_new_tokens=8) for p in ps]
            assert [s.wait(60) for s in ss] == ref_decode_many(ps, 8)
            assert all(s.replica.split("/")[-1].startswith("d") for s in ss)
            assert fleet.migrations >= len(ps)
        finally:
            fleet.stop()


class TestStatsAndMetrics:
    @fleet_test
    def test_fleet_stats_shape(self):
        fleet = make_fleet()
        try:
            ss = [fleet.submit(p, max_new_tokens=8) for p in prompts(4)]
            for s in ss:
                s.wait(60)
            st = fleet.stats(window_s=600)
            assert st.ttft_p99_ms > 0
            assert st.requests_windowed == 4
            assert st.kv_blocks_total == 32
            assert st.replicas_ready == 1
        finally:
            fleet.stop()

    @fleet_test
    def test_histograms_preregistered(self):
        """The JAX package's strict exposition parser sees the full
        TTFT/TPOT bucket blocks of every priority class in the port's
        exposition from the first scrape."""
        fleet = make_fleet(job="t/prereg")
        try:
            text = get_registry().render()
            parse_exposition(text)
            samples = list(iter_samples(text))
            names = {s[0] for s in samples}
            for fam in ("edl_serving_ttft_seconds",
                        "edl_serving_tpot_seconds"):
                assert fam + "_bucket" in names
                assert fam + "_count" in names
            for pri in ("high", "normal", "low"):
                assert any(name == "edl_serving_ttft_seconds_count"
                           and labels.get("priority") == pri
                           and labels.get("job") == "t/prereg"
                           for name, labels, _ in samples)
            assert "edl_serving_kv_blocks_total" in names
            assert "edl_serving_sessions_active" in names
        finally:
            fleet.stop()


class TestSpeculativeDecode:
    @fleet_test
    def test_lossless_vs_single_token_greedy(self):
        ps = [PERIODIC, [5, 9, 17, 33], [200, 3, 77, 4, 11, 4],
              list(PERIODIC) + [7]]
        outs = {}
        for k in (0, 4):
            fl = make_fleet(job=f"t/spec-lossless{k}", spec_tokens=k,
                            spec_ngram=3, kv_blocks=48)
            try:
                ss = [fl.submit(list(p), max_new_tokens=10) for p in ps]
                outs[k] = [s.wait(60) for s in ss]
            finally:
                fl.stop(drain=False)
        assert outs[4] == outs[0]
        assert outs[0] == ref_decode_many(ps, 10)

    @fleet_test
    def test_acceptance_counters(self):
        fl = make_fleet(job="t/spec-counters", spec_tokens=4, spec_ngram=3,
                        kv_blocks=48)
        try:
            ss = [fl.submit(list(PERIODIC), max_new_tokens=12)
                  for _ in range(3)]
            for s in ss:
                s.wait(60)
            rep = fl._replicas[0]
            assert rep.spec_drafted > 0
            assert 0 < rep.spec_accepted <= rep.spec_drafted
        finally:
            fl.stop(drain=False)
        assert counter_sum("edl_decode_spec_accepted_total",
                           "t/spec-counters") > 0
        assert (counter_sum("edl_decode_spec_drafted_total",
                            "t/spec-counters")
                >= counter_sum("edl_decode_spec_accepted_total",
                               "t/spec-counters"))

    @fleet_test
    def test_eos_mid_draft_truncates_identically(self):
        eos = ref_decode(PERIODIC, 1)[0]
        outs = {}
        for k in (0, 4):
            fl = make_fleet(job=f"t/spec-eos{k}", spec_tokens=k,
                            spec_ngram=3, eos_id=eos, kv_blocks=48)
            try:
                outs[k] = fl.submit(list(PERIODIC),
                                    max_new_tokens=8).wait(60)
            finally:
                fl.stop(drain=False)
        assert outs[4] == outs[0]
        assert len(outs[0]) < 8


class TestAdaptiveScheduler:
    def test_cold_and_budgetless_fall_back_to_static(self):
        assert TokenScheduler(
            decode_per_prefill=3).effective_decode_per_prefill() == 3
        ts = TokenScheduler(decode_per_prefill=3, tpot_budget_ms=10.0)
        ts.note_decode(5.0)
        assert ts.effective_decode_per_prefill() == 3
        ts2 = TokenScheduler(decode_per_prefill=5)
        ts2.note_decode(100.0)
        ts2.note_prefill(100.0)
        assert ts2.effective_decode_per_prefill() == 5

    def test_slow_decode_rations_prefill_hard(self):
        ts = TokenScheduler(decode_per_prefill=2, tpot_budget_ms=10.0)
        ts.note_decode(9.5)
        ts.note_prefill(5.0)
        assert ts.effective_decode_per_prefill() == 10
        ts.note_prefill(None)
        for _ in range(9):
            ts.note_decode()
            assert not ts.allow_prefill(decoding=1, prefill_pending=1)
        ts.note_decode()
        assert ts.allow_prefill(decoding=1, prefill_pending=1)

    def test_fast_decode_lets_prefill_run_every_iteration(self):
        ts = TokenScheduler(decode_per_prefill=4, tpot_budget_ms=10.0)
        ts.note_decode(1.0)
        ts.note_prefill(0.5)
        assert ts.effective_decode_per_prefill() == 1

    def test_no_headroom_clamps_to_ceiling(self):
        ts = TokenScheduler(decode_per_prefill=2, tpot_budget_ms=10.0)
        ts.note_decode(12.0)
        ts.note_prefill(5.0)
        assert ts.effective_decode_per_prefill() == 64


@fleet_test
def test_calibration_ledger_pairs_the_scheduler_predictions():
    """With a ledger armed, the replica loop records the interleave
    EWMAs against the measured iterations."""
    from edl_tpu_torch.observability import calib

    led = calib.set_process_calib(calib.CalibrationLedger(job="t/calib"))
    fleet = make_fleet(job="t/calib")
    try:
        fleet.submit([5, 9, 17, 33], max_new_tokens=8).wait(60)
    finally:
        fleet.stop()
        calib.set_process_calib(None)
    assert led.sample_count("interleave_decode_ms") >= 5
    assert led.factor("interleave_decode_ms") > 0
