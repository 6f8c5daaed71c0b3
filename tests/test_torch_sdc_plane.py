"""The port's SDC defense plane against tests/test_sdc.py: the anomaly gate,
the cross-check's minority vote, the quarantine markers, the seeded SDC
fault plans (drawn as the reference draws them), and the three end-to-end
drills — detect → shadow recompute → rollback → bitwise replay — on the
MLP [16, 32, 4] holding the JAX init, against an uninjected control.

The reference's drill 1 flips bit 30 of leaf 0 and has failed in every
recorded run; :class:`TestReferenceDrillFault` shows why in both packages
(a dead ReLU unit, no loss trip, no peer to cross-check), and the port's
drill 1 is held to the reference test's docstring with a flip that does
explode the next loss.

Scenarios that need two ranks run once in one spawned gloo world
(tests/torch_world.py::suite_sdc): the three drills on a job that grows
1→2, where the replicas cross-check their fingerprints, rank 0 judges and
both ranks take its verdict, and the trainer's seams on replicated, fsdp
and tp trainers."""

import json
import math

import jax
import numpy as np
import optax
import pytest
import torch

import torch_world as tw
from edl_tpu.models import mlp as jmlp
from edl_tpu.models import transformer as jtfm
from edl_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from edl_tpu.runtime import faults as jfaults
from edl_tpu.runtime import virtual as jvirtual
from edl_tpu.runtime.data import ShardRegistry as JaxShardRegistry
from edl_tpu.runtime.elastic import ElasticTrainer as JaxTrainer
from edl_tpu_torch import interop
from edl_tpu_torch.models import mlp
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
from edl_tpu_torch.runtime.data import ShardRegistry
from edl_tpu_torch.runtime.elastic import ElasticTrainer
from edl_tpu_torch.runtime.faults import (
    ACTION_TYPES,
    SDC_KINDS,
    SERVING_KINDS,
    TRAINING_KINDS,
    CorruptGradient,
    FaultContext,
    FaultPlan,
    FaultPlanEngine,
    FlipParamBits,
    PoisonLoss,
)
from edl_tpu_torch.runtime.sdc import (
    AnomalyDetector,
    MemoryKV,
    SdcPlane,
    ShadowRecompute,
    UpdateFingerprinter,
    clear_quarantine,
    flip_tree_bit,
    quarantine_worker,
    quarantined_names,
)
from edl_tpu_torch.runtime.virtual import (
    VirtualBatches,
    VirtualConfig,
    VirtualWorkerLoop,
)

SEED = 3
CFG = VirtualConfig(vw_count=8, global_batch=64, job_seed=SEED)
STEPS = 14
MLP_PARAMS = jax.tree.map(np.asarray, jmlp.init(jax.random.key(0),
                                                [16, 32, 4]))
#: the port's drill 1: bit 30 of w1[0, 0] (leaf 3 in flatten order: b0, b1,
#: w0, w1), the exponent's top bit of an output weight below 2 in
#: magnitude — it multiplies the weight by 2^128, and every row whose first
#: hidden unit is live then carries a logit near 1e38, so the next loss
#: explodes and the anomaly gate trips
EXPLODING_FLIP = dict(leaf=3, bit=30)
#: the reference's drill 1 flip: bit 30 of leaf 0, b0[0]
REFERENCE_FLIP = dict(leaf=0, bit=30)
WORLD_DEADLINE_S = 180


def _dataset(n=2048):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, n).astype(np.int32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    return x, y


def _batches():
    reg = ShardRegistry()
    ids = reg.register_arrays(_dataset(), num_shards=16)
    return VirtualBatches(CFG, ids, reg.get, passes=2)


def _trainer(**kw):
    model = interop.params_from_numpy(mlp.MLP([16, 32, 4], device="cpu"),
                                      MLP_PARAMS)
    return ElasticTrainer(mlp.loss_fn, model, optim.adam(1e-2),
                          devices=[torch.device("cpu")],
                          accum_mode="replicated", **kw)


@pytest.fixture(scope="module")
def control():
    """The uninjected trajectory every drill compares against."""
    return VirtualWorkerLoop(_trainer(), CFG, _batches()).run(max_steps=STEPS)


def _plane(ck=None, kv=None, job="job", worker="w0", flight_dir=None):
    shadow = ShadowRecompute(_trainer, _batches, CFG, checkpointer=ck)
    return SdcPlane(
        fingerprinter=UpdateFingerprinter(kv=kv, job=job, worker=worker),
        detector=AnomalyDetector(), shadow=shadow, checkpointer=ck,
        flight_dir=flight_dir)


# -- anomaly gate -------------------------------------------------------------


class TestAnomalyDetector:
    def test_clean_stream_never_trips(self):
        det = AnomalyDetector()
        rng = np.random.default_rng(0)
        for _ in range(200):
            assert det.observe(1.5 + 0.05 * rng.standard_normal()) is None

    def test_nan_and_inf_always_trip(self):
        det = AnomalyDetector()
        assert det.observe(float("nan")) == "nan"
        assert det.observe(float("inf")) == "nan"

    def test_spike_trips_after_warmup(self):
        det = AnomalyDetector(z=6.0, warmup=8)
        for i in range(20):
            det.observe(1.0 + 0.01 * math.sin(i))
        assert det.observe(3.0) == "loss_spike"

    def test_explosion_trips_even_during_warmup(self):
        det = AnomalyDetector(warmup=8)
        det.observe(1.8)
        assert det.observe(8.5e36) == "loss_spike"

    def test_anomaly_not_folded_into_baseline(self):
        det = AnomalyDetector(z=6.0, warmup=4)
        for i in range(10):
            det.observe(1.0 + 0.01 * math.sin(i))
        assert det.observe(50.0) == "loss_spike"
        # the spike did NOT teach the detector that 50 is normal
        assert det.observe(50.0) == "loss_spike"
        assert det.observe(1.0) is None


# -- cross-check --------------------------------------------------------------


class TestCrossCheck:
    def _fp(self, kv, job, worker, cadence=1):
        return UpdateFingerprinter(kv=kv, job=job, worker=worker,
                                   cadence=cadence)

    def test_majority_names_the_minority(self):
        kv = MemoryKV()
        t = {"w": np.ones(4, np.float32)}
        bad = flip_tree_bit(t, bit=5)
        for worker, tree in (("w0", t), ("w1", t), ("w2", bad)):
            self._fp(kv, "j", worker).record(3, tree)
        check = self._fp(kv, "j", "w0").cross_check(3)
        assert check.mismatch and check.suspects == ["w2"]

    def test_even_split_is_mismatch_without_suspects(self):
        kv = MemoryKV()
        t = {"w": np.ones(4, np.float32)}
        self._fp(kv, "j", "w0").record(3, t)
        self._fp(kv, "j", "w1").record(3, flip_tree_bit(t, bit=5))
        check = self._fp(kv, "j", "w0").cross_check(3)
        assert check.mismatch and check.suspects == []

    def test_agreement_and_singleton(self):
        kv = MemoryKV()
        t = {"w": np.ones(4, np.float32)}
        fp0 = self._fp(kv, "j", "w0")
        fp0.record(3, t)
        assert fp0.cross_check(3) is None  # alone: nothing to check
        self._fp(kv, "j", "w1").record(3, t)
        check = fp0.cross_check(3)
        assert check is not None and not check.mismatch

    def test_cadence_skips_off_steps(self):
        fp = UpdateFingerprinter(cadence=5)
        t = {"w": np.ones(4, np.float32)}
        assert fp.record(3, t) is None
        assert fp.record(5, t) is not None
        assert get_counters().get("sdc_fingerprints") >= 1


# -- quarantine ---------------------------------------------------------------


class TestQuarantine:
    def test_marker_written_listed_and_lifted_by_amnesty(self):
        """The marker's write, list and amnesty.  Declining a marked
        worker's rejoin is the membership machinery's (ElasticWorld), which
        comes with ROADMAP.md queue 1 item 6; it is not tested here."""
        kv = MemoryKV()
        assert quarantine_worker(kv, "w1", reason="sdc step 9")
        assert quarantined_names(kv) == {"w1"}
        assert kv.kv_get("sdc-quarantine/w1") == b"sdc:sdc step 9"
        assert clear_quarantine(kv, "w1") is True
        assert quarantined_names(kv) == set()
        assert quarantine_worker(None, "w1") is False

    def test_clear_quarantine_idempotent(self):
        kv = MemoryKV()
        quarantine_worker(kv, "w9")
        assert clear_quarantine(kv, "w9") is True
        assert clear_quarantine(kv, "w9") is False


# -- seeded SDC fault plans ---------------------------------------------------


class TestSdcFaultPlans:
    def test_kinds_registered_and_frozen(self):
        assert SDC_KINDS == ("corrupt_gradient", "flip_param_bits",
                             "poison_loss") == jfaults.SDC_KINDS
        for kind in SDC_KINDS:
            assert kind in ACTION_TYPES
        assert TRAINING_KINDS == jfaults.TRAINING_KINDS
        assert SERVING_KINDS == jfaults.SERVING_KINDS

    def test_seeded_plan_is_deterministic_and_the_references(self):
        a = FaultPlan.random(11, n_faults=3, kinds=SDC_KINDS)
        b = FaultPlan.random(11, n_faults=3, kinds=SDC_KINDS)
        assert a.describe() == b.describe()
        assert {d["kind"] for d in a.describe()} == set(SDC_KINDS)
        for seed, n in ((11, 3), (5, 7), (0, 2)):
            assert FaultPlan.random(seed, n_faults=n,
                                    kinds=SDC_KINDS).describe() == \
                jfaults.FaultPlan.random(seed, n_faults=n,
                                         kinds=SDC_KINDS).describe()

    def test_actions_require_a_trainer_in_ctx(self):
        with pytest.raises(RuntimeError, match="trainer"):
            CorruptGradient().fire(FaultContext())
        with pytest.raises(RuntimeError, match="trainer"):
            FlipParamBits().fire(FaultContext())
        with pytest.raises(RuntimeError, match="trainer"):
            PoisonLoss().fire(FaultContext())

    @pytest.mark.parametrize("kinds, item", [
        (TRAINING_KINDS, "item 6"), (SERVING_KINDS, "item 11"),
        (("poison_loss", "gray_replica"), "item 11")])
    def test_unported_kinds_raise_naming_their_item(self, kinds, item):
        with pytest.raises(ValueError, match=item):
            FaultPlan.random(1, n_faults=3, kinds=kinds)


# -- the drills ---------------------------------------------------------------


class TestEndToEndDrills:
    def test_flip_param_bits_confirmed_rolled_back_bitwise(
            self, tmp_path, control):
        """Drill 1 (single worker): a live parameter bit flip explodes the
        next loss → anomaly gate → shadow recompute from the last verified
        checkpoint CONFIRMS → rollback and cursor replay.  The final
        trajectory is bitwise the uninjected control's, the ledger
        balances, and the flight record carries the verdict trail."""
        ck = ElasticCheckpointer(tmp_path / "ck")
        tr = _trainer()
        plane = _plane(ck=ck, flight_dir=str(tmp_path / "fr"))
        loop = VirtualWorkerLoop(tr, CFG, _batches(), checkpointer=ck,
                                 ckpt_every=5, sdc=plane)
        fired = []

        def strike(step, loss, world):
            if step == 7 and not fired:
                fired.append(step)
                tr.flip_param_bits(**EXPLODING_FLIP)

        before = get_counters().total("sdc_rollbacks")
        rep = loop.run(max_steps=STEPS, on_step=strike)
        assert rep.rollbacks == 1
        assert get_counters().total("sdc_rollbacks") == before + 1
        conf = [v for v in plane.verdicts if v.outcome == "confirmed"]
        assert conf and conf[0].rollback_step == 5 and conf[0].step == 8
        assert conf[0].anchor_step == 5 and conf[0].replayed_steps == 3
        assert not plane.healthy()
        assert rep.losses == control.losses  # BITWISE continuity
        assert rep.rows_trained == control.rows_trained  # exactly-once
        recs = list((tmp_path / "fr").glob("*.json"))
        assert recs
        payload = json.loads(recs[0].read_text())["extra"]
        assert payload["sdc"]["outcome"] == "confirmed"
        assert payload["sdc"]["trigger"] in ("loss_spike", "nan")
        trail = payload["sdc_verdict_trail"]
        assert trail[-1]["rollback_step"] == 5
        ck.close()

    def test_corrupt_gradient_cross_checked_and_quarantined(
            self, tmp_path, control):
        """Drill 2 (two workers in lock-step in one process, one in-memory
        KV): one worker's summed gradient is corrupted before the update.
        Its published fingerprint splits from its peer's; the shadow
        recomputation breaks the 2-way tie, names the corrupt worker,
        quarantines it and rolls it back — BOTH workers end bitwise the
        control, and the fired CorruptGradient's recovery predicate
        observes the rollback.  ``run(max_steps=1)`` advances a worker one
        step net, its replay included."""
        kv = MemoryKV()
        rigs = {}
        for worker in ("wA", "wB"):
            ck = ElasticCheckpointer(tmp_path / worker)
            tr = _trainer()
            plane = _plane(ck=ck, kv=kv, job="drill2", worker=worker)
            loop = VirtualWorkerLoop(tr, CFG, _batches(), checkpointer=ck,
                                     ckpt_every=5, sdc=plane)
            rigs[worker] = (tr, loop, plane, ck)
        plan = FaultPlan(actions=[CorruptGradient(at_step=7)], seed=SEED)
        engine = FaultPlanEngine(plan, FaultContext(trainer=rigs["wB"][0]))
        for i in range(1, STEPS + 1):
            engine(i)
            rigs["wA"][1].run(max_steps=1)
            rigs["wB"][1].run(max_steps=1)
        _, loopA, planeA, ckA = rigs["wA"]
        _, loopB, planeB, ckB = rigs["wB"]
        conf = [v for v in planeB.verdicts if v.outcome == "confirmed"]
        assert conf and conf[0].trigger == "fp_mismatch"
        assert conf[0].quarantined == "wB"
        assert "wB" in quarantined_names(kv)
        assert loopB.report.rollbacks == 1
        assert loopA.report.rollbacks == 0  # the honest peer never rolls
        assert planeA.verdicts == []
        assert loopB.report.losses == control.losses
        assert loopA.report.losses == control.losses
        assert engine.quiescent() and engine.recovered == ["corrupt_gradient"]
        clear_quarantine(kv, "wB")
        ckA.close()
        ckB.close()

    def test_poison_loss_refuted_and_metric_repaired(self, control):
        """Drill 3: a NaN loss REPORT over clean parameters.  The shadow
        recompute refutes it, nothing rolls back, no one is quarantined,
        and the trajectory carries the repaired honest loss, bitwise the
        control's."""
        tr = _trainer()
        plane = _plane()
        loop = VirtualWorkerLoop(tr, CFG, _batches(), sdc=plane)
        plan = FaultPlan(actions=[PoisonLoss(at_step=6)], seed=SEED)
        engine = FaultPlanEngine(plan, FaultContext(trainer=tr))
        before = get_counters().get("sdc_losses_repaired")
        rep = loop.run(max_steps=STEPS, on_step=engine)
        ref = [v for v in plane.verdicts if v.outcome == "refuted"]
        assert ref and ref[0].trigger == "nan"
        assert rep.rollbacks == 0
        assert plane.healthy()  # a refuted episode is not ill health
        assert rep.losses == control.losses
        assert get_counters().get("sdc_losses_repaired") == before + 1
        assert engine.quiescent() and engine.recovered == ["poison_loss"]


class TestReferenceDrillFault:
    """The reference's drill 1 (tests/test_sdc.py) flips bit 30 of leaf 0
    after step 7 and expects a rollback.  Leaf 0 is ``b0`` (the flatten
    order sorts b0, b1, w0, w1); after 7 steps ``b0[0]`` is about -0.056,
    and setting the exponent's top bit makes it about -1.9e37.  Being
    negative, it only kills hidden unit 0 through the ReLU: the next loss
    moves by about 1 %, the anomaly gate never trips, and a single worker
    has no peer to cross-check its fingerprint against — so nothing rolls
    back.  The port shows the same case (ROADMAP.md, queue 3)."""

    def test_reference_flip_kills_a_relu_unit_and_goes_unseen(
            self, tmp_path, control):
        ck = ElasticCheckpointer(tmp_path / "ck")
        tr = _trainer()
        plane = _plane(ck=ck)
        loop = VirtualWorkerLoop(tr, CFG, _batches(), checkpointer=ck,
                                 ckpt_every=5, sdc=plane)
        seen = {}

        def strike(step, loss, world):
            if step == 7 and not seen:
                seen["before"] = float(tr.state.params.b0[0])
                tr.flip_param_bits(**REFERENCE_FLIP)
                seen["after"] = float(tr.state.params.b0[0])

        rep = loop.run(max_steps=STEPS, on_step=strike)
        assert -0.06 < seen["before"] < -0.05
        assert seen["after"] == pytest.approx(seen["before"] * 2.0 ** 128)
        assert rep.rollbacks == 0 and plane.verdicts == []
        assert rep.losses[:7] == control.losses[:7]
        assert rep.losses[7:] != control.losses[7:]
        assert all(math.isfinite(v) for v in rep.losses)
        assert max(abs(a - b) / b for a, b in
                   zip(rep.losses[7:], control.losses[7:])) < 0.1
        ck.close()

    def test_the_reference_trainer_takes_the_same_flip(self):
        """The JAX trainer's leaf 0 after the same 7 steps holds the same
        b0[0], and the reference's flip_tree_bit lands on the same bit."""
        jcfg = jvirtual.VirtualConfig(vw_count=8, global_batch=64,
                                      job_seed=SEED)
        reg = JaxShardRegistry()
        ids = reg.register_arrays(_dataset(), num_shards=16)
        jt = JaxTrainer(jmlp.loss_fn, jmlp.init(jax.random.key(0),
                                                [16, 32, 4]),
                        optax.adam(1e-2), spec=JaxMeshSpec(dp=-1),
                        initial_world_size=1, accum_mode="replicated")
        jvirtual.VirtualWorkerLoop(jt, jcfg, jvirtual.VirtualBatches(
            jcfg, ids, reg.get, passes=2)).run(max_steps=7)
        tr = _trainer()
        VirtualWorkerLoop(tr, CFG, _batches()).run(max_steps=7)
        want = float(np.asarray(jt.state.params["b0"])[0])
        assert float(tr.state.params.b0[0]) == pytest.approx(want, abs=1e-6)
        jt.flip_param_bits(**REFERENCE_FLIP)
        tr.flip_param_bits(**REFERENCE_FLIP)
        assert float(tr.state.params.b0[0]) == pytest.approx(
            float(np.asarray(jt.state.params["b0"])[0]), rel=1e-5)


class TestPlaneOnTheLoop:
    def test_non_plane_refused_and_sharded_trainer_taken(self):
        """``sdc=`` must be a plane; a sharded trainer's loop takes one and
        fingerprints its blocks as the whole tree (one rank holds them all
        here; two ranks in the world below)."""
        with pytest.raises(TypeError, match="SdcPlane"):
            VirtualWorkerLoop(_trainer(), CFG, _batches(), sdc=object())
        plane = _plane()
        rep = VirtualWorkerLoop(_trainer(param_sharding="fsdp"), CFG,
                                _batches(), sdc=plane).run(max_steps=2)
        tr = _trainer()
        VirtualWorkerLoop(tr, CFG, _batches()).run(max_steps=2)
        assert rep.rollbacks == 0 and plane.verdicts == []
        assert plane.fingerprinter.local[2] == \
            UpdateFingerprinter().fingerprint(tr.state.params)

    def test_device_fold_disagreement_raises(self, monkeypatch):
        """No hidden fallback: a device fold that disagrees with the host
        fold raises, the first time it is checked."""
        from edl_tpu_torch.runtime import sdc

        fp = UpdateFingerprinter()
        fp._prefer_device = True  # the device path, on CPU tensors
        tree = {"w": torch.arange(8, dtype=torch.float32)}
        assert fp.record(1, tree) == sdc.tree_fingerprint(tree)
        bad = UpdateFingerprinter()
        bad._prefer_device = True
        monkeypatch.setattr(sdc, "device_tree_folds",
                            lambda t: [0] * len(list(
                                sdc._leaves_with_path(t))))
        with pytest.raises(RuntimeError, match="disagrees"):
            bad.record(1, tree)
        monkeypatch.undo()
        with pytest.raises(NotImplementedError, match="16-bit"):
            fp.record(2, {"b": torch.zeros(3, dtype=torch.int8)})


# -- the two-rank world -------------------------------------------------------


#: the seams struck on each layout of the two-rank world: two gradient
#: strikes (a byte of layers[0].w1 at row 3, column 100 — rank 1's tp and
#: fsdp block — then column 10, rank 0's) and two parameter flips (embed row
#: 200, rank 1's vocabulary half, and row 3)
SEAMS = [dict(leaf=3, bit=8 * ((3 * 128 + 100) * 4 + 2) + 1),
         dict(leaf=3, bit=8 * ((3 * 128 + 10) * 4 + 2) + 1),
         dict(leaf=0, bit=8 * ((200 * 64 + 5) * 4 + 2) + 6),
         dict(leaf=0, bit=8 * ((3 * 64 + 9) * 4 + 1) + 4)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tiny = jax.tree.map(np.asarray, jtfm.init(jax.random.key(0), jtfm.TINY))
    return tw.run("sdc", 2, tmp_path_factory.mktemp("sdc2"),
                  WORLD_DEADLINE_S, mlp_params=MLP_PARAMS, tiny_params=tiny,
                  data=_dataset(), seed=SEED, strike=EXPLODING_FLIP,
                  seams=SEAMS)


@pytest.mark.timeout_s(240)
def test_world_flip_drill_one_verdict_bitwise_its_control(world, control):
    """A job growing 1→2: the flip after step 7 lands on both live
    replicas, rank 0 judges, both ranks take one verdict and roll back to
    step 5 together, and rank 0's trajectory is bitwise the one-process
    control's (replicated accumulation is layout-free)."""
    ctrl = tw.scenario(world, "control")
    got = tw.scenario(world, "flip_drill")
    assert ctrl[0]["losses"] == control.losses
    assert got[0]["verdicts"] == got[1]["verdicts"]
    (step, trigger, outcome, target), = got[0]["verdicts"]
    assert (step, outcome, target) == (8, "confirmed", 5)
    assert trigger in ("loss_spike", "nan")
    for g, c in zip(got, ctrl):
        assert g["rollbacks"] == 1 and g["fired"] == [7]
        assert g["losses"] == c["losses"] and g["rows"] == c["rows"]
    assert got[0]["losses"] == control.losses


@pytest.mark.timeout_s(240)
def test_world_flip_drill_on_fsdp_trainers(world, control):
    """The flip drill on fsdp MLP trainers (world 2 is fsdp 2): the flip
    lands on the rank whose block holds it, rank 0's fingerprint is the
    whole tree's from both ranks' block folds, the world-1 replicated
    shadow confirms, both ranks restore step 5 into their blocks, and the
    trajectory and the final whole params are the replicated drill's."""
    got = tw.scenario(world, "fsdp_flip_drill")
    repl = tw.scenario(world, "flip_drill")
    assert got[0]["verdicts"] == got[1]["verdicts"] == repl[0]["verdicts"]
    for g, r in zip(got, repl):
        assert g["rollbacks"] == 1 and g["losses"] == r["losses"]
        assert g["rows"] == r["rows"] and g["params"] == r["params"]
    assert got[0]["losses"] == control.losses


@pytest.mark.timeout_s(240)
def test_sharded_fingerprints_are_the_whole_trees(world):
    """fsdp 2, tp 2 and an fsdp-2 trainer of odd-shaped bf16 and fp32
    leaves: the block folds combined across the ranks fingerprint as the
    host fold of the whole parameters, on both ranks."""
    got = tw.scenario(world, "sharded_fingerprints")
    for g in got:
        for name, r in g.items():
            assert r["fp"] == r["host"], name
            assert r["split"], name  # some leaf is really split
        assert g["odd"]["split"] == ["a", "c"]
    assert got[0] == got[1]


@pytest.mark.timeout_s(240)
def test_world_poison_drill_refuted_on_both_ranks(world, control):
    got = tw.scenario(world, "poison_drill")
    assert got[0]["verdicts"] == got[1]["verdicts"]
    (_, trigger, outcome, _), = got[0]["verdicts"]
    assert (trigger, outcome) == ("nan", "refuted")
    assert all(g["rollbacks"] == 0 for g in got)
    assert got[0]["losses"] == control.losses
    assert all(g["quiescent"] and g["recovered"] == ["poison_loss"]
               for g in got)


@pytest.mark.timeout_s(240)
def test_world_corrupt_gradient_on_one_replica_named_and_rolled_back(
        world, control):
    """Drill 2 on the world of 2: a corrupt gradient on rank 1's replica
    alone (fired after step 7, so step 8's update).  The replicas'
    fingerprints split, rank 0's shadow agrees with its own and names rank
    1, both ranks roll back to step 5, and both end bitwise the control,
    their params equal."""
    ctrl = tw.scenario(world, "control")
    got = tw.scenario(world, "corrupt_drill")
    assert got[0]["verdicts"] == got[1]["verdicts"] == [
        (8, "fp_mismatch", "confirmed", 5)]
    assert got[0]["suspects"] == [["rank1"]]
    for g, c in zip(got, ctrl):
        assert g["rollbacks"] == 1
        assert g["losses"] == c["losses"] and g["rows"] == c["rows"]
        assert g["digest"] == c["digest"]
    assert got[0]["losses"] == control.losses
    assert got[0]["digest"] == got[1]["digest"]
    assert got[1]["quiescent"] and got[1]["recovered"] == ["corrupt_gradient"]


@pytest.mark.timeout_s(240)
def test_seams_strike_one_element_wherever_it_lives(world):
    """On replicated, fsdp and tp trainers of two ranks, each seam strikes
    the element the reference's one tree would, whichever rank's block
    holds it: the whole params differ from the unstruck run's at exactly
    the struck element, the same on every layout, and an fsdp trainer's
    struck params are bitwise a replicated trainer's."""
    got = tw.scenario(world, "seams_by_layout")
    want = {"grad0": {("layers.0.w1", (3, 100))},
            "grad1": {("layers.0.w1", (3, 10))},
            "flipped": {("embed", (200, 5)), ("embed", (3, 9))}}

    def diff(a, b):
        return {(n, tuple(int(i) for i in idx)) for n in a
                for idx in zip(*np.nonzero(a[n] != b[n]))}

    for g in got:
        for layout, runs in g.items():
            for run, base in (("grad0", "clean"), ("grad1", "clean"),
                              ("flipped", "init")):
                assert diff(runs[run], runs[base]) == want[run], (layout,
                                                                  run)
        for run in ("grad0", "grad1", "flipped"):
            for n, a in g["replicated"][run].items():
                assert np.array_equal(a, g["fsdp"][run][n]), (run, n)
