"""The port's fleet simulation (edl_tpu_torch/scheduler/sim.py) against the
JAX package's: ``compare_objectives`` at tests/test_sched_sim.py's fleet
(120 jobs, 16 × 8 cards in 4 NVLink domains, seed 17) returns the
reference's dict exactly — both simulations iterate in one order over the
same seeded ``random`` and ``crc32`` jitter, through each package's own
planner — then that file's invariants on the port's simulation."""

import statistics

import pytest

import edl_tpu.scheduler.sim as jsim
import edl_tpu_torch.scheduler.sim as tsim
from edl_tpu_torch.scheduler.sim import (CURVE_TEMPLATES, FleetSim,
                                         SimConfig, compare_objectives)

#: the reference test fleet: moderate contention, 4 domains, mixed curve
#: classes, ~15% serving fleets, seeded
FLEET = dict(n_jobs=120, hosts=16, chips_per_host=8, domains=4,
             horizon_s=900.0, arrival_spread_s=700.0, seed=17)
CFG = SimConfig(**FLEET)


@pytest.fixture(scope="module")
def comparison():
    return compare_objectives(CFG, register=True)


def test_compare_objectives_equals_the_reference(comparison):
    want = jsim.compare_objectives(jsim.SimConfig(**FLEET), register=False)
    assert comparison == want


@pytest.mark.parametrize("fleet", [
    dict(n_jobs=40, hosts=8, chips_per_host=4, domains=2, horizon_s=300.0,
         arrival_spread_s=200.0, seed=5),
    dict(n_jobs=60, hosts=8, chips_per_host=8, domains=4, horizon_s=400.0,
         arrival_spread_s=150.0, seed=29, serve_fraction=0.4)])
def test_other_fleets_equal_the_reference(fleet):
    """Two more seeds and shapes, one at heavy contention with many
    serving fleets: the dicts are equal, run by run."""
    want = jsim.compare_objectives(jsim.SimConfig(**fleet), register=False)
    assert tsim.compare_objectives(tsim.SimConfig(**fleet),
                                   register=False) == want


def test_templates_equal_the_reference():
    assert CURVE_TEMPLATES == jsim.CURVE_TEMPLATES


def test_goodput_objective_beats_count_on_aggregate_goodput(comparison):
    assert comparison["sched_goodput_uplift_pct"] > 0, comparison


def test_admission_p99_not_regressed(comparison):
    assert (comparison["sched_admission_p99_s"]
            <= comparison["sched_admission_p99_s_count"] + 1e-9), comparison


def test_gang_and_min_invariants(comparison):
    assert comparison["sched_gang_strandings"] == 0
    assert comparison["sched_min_violations"] == 0


def test_priorities_buy_admission_latency():
    """Under heavy contention HIGH-priority gangs preempt their way in
    under the goodput objective and are admitted faster on average than
    under count packing, which never preempts."""
    hot = SimConfig(n_jobs=120, hosts=16, chips_per_host=8, domains=4,
                    horizon_s=900.0, arrival_spread_s=500.0, seed=17)
    waits, preemptions = {}, {}
    for objective in ("goodput", "count"):
        sim = FleetSim(hot)
        out = sim.run(objective)
        assert out["gang_strandings"] == 0
        assert out["min_violations"] == 0
        preemptions[objective] = out["preemptions"]
        waits[objective] = statistics.mean(
            (j.admitted_at if j.admitted_at is not None
             else hot.horizon_s) - j.arrival_s
            for j in sim.jobs if j.priority == 2
            and j.arrival_s < hot.horizon_s)
    assert preemptions["goodput"] > 0
    assert preemptions["count"] == 0
    assert waits["goodput"] <= waits["count"], waits


def test_sim_drives_the_real_planner(monkeypatch):
    """The simulation's plans come from the port's planner.plan_cluster."""
    calls = []
    orig = tsim.plan_cluster

    def spy(jobs, r, mld=1.0, **kw):
        plan = orig(jobs, r, mld, **kw)
        calls.append(plan.mode)
        return plan

    monkeypatch.setattr(tsim, "plan_cluster", spy)
    cfg = SimConfig(n_jobs=12, hosts=4, domains=2, horizon_s=120.0,
                    arrival_spread_s=60.0, seed=3)
    FleetSim(cfg).run("goodput")
    assert calls and set(calls) <= {"goodput", "degraded"}
    assert "goodput" in calls


def test_curves_are_sampled_from_recorded_template_shapes():
    sim = FleetSim(CFG)
    assert {j.template for j in sim.jobs} <= set(CURVE_TEMPLATES)
    sim.run("goodput")
    for j in sim.jobs:
        for ws in j.measured.world_sizes():
            assert j.lo <= ws or ws <= j.hi


def test_identical_fleet_across_objectives():
    a, b = FleetSim(CFG), FleetSim(CFG)
    key = [(j.name, j.arrival_s, j.priority, j.chips, j.lo, j.hi,
            j.template, j.work, j.demand) for j in a.jobs]
    assert key == [(j.name, j.arrival_s, j.priority, j.chips, j.lo, j.hi,
                    j.template, j.work, j.demand) for j in b.jobs]
    ref = jsim.FleetSim(jsim.SimConfig(**FLEET))
    assert key == [(j.name, j.arrival_s, j.priority, j.chips, j.lo, j.hi,
                    j.template, j.work, j.demand) for j in ref.jobs]


def test_sched_metrics_strict_exposition(comparison):
    from edl_tpu_torch.observability.metrics import (get_registry,
                                                     parse_exposition)

    series = parse_exposition(get_registry().render())
    assert series["edl_sched_goodput_uplift_pct"] == pytest.approx(
        comparison["sched_goodput_uplift_pct"])
    assert series['edl_sched_admission_p99_s{objective="goodput"}'] == \
        pytest.approx(comparison["sched_admission_p99_s"])
    assert series["edl_sched_gang_strandings"] == 0.0
    if comparison["sched_preemptions"]:
        assert series["edl_sched_preemptions_total"] >= \
            comparison["sched_preemptions"]
