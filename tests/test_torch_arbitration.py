"""chip_smoke's phase (x), train+serve card arbitration, rehearsed on the
CPU at TINY: two spawned gloo ranks (tests/torch_world.py::
suite_arbitrated) run ``entry.flagship_arbitrated_job`` under
``entry.arbitrated_campaign`` with the TINY scoring fleet beside rank 0,
and the phase's gates are held here: the goodput planner decides every
tick once both curves resolve (each moving plan re-planned equal on its
recorded inputs), the cards granted never exceed three, the trainer goes
1 → 2 → 1 and the fleet 1 → 2 by one rebalance plan, the fleet's dial is
the planner's (observe-only SLO policy that hints and never actuates),
every leased task trains once with the losses of a one-rank control, no
request is lost and the answers are the plain path's, the scraped view
agrees with the fleet's own stats, and both alert drills fire."""

import collections
import math

import numpy as np
import pytest

import torch_world as tw
from edl_tpu_torch.entry import flagship_local_job
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.observability.metrics import SERVING_LATENCY_BUCKETS

#: the rehearsal's data (more tasks than the run leases), rows, schedule,
#: and the sleep after each world-2 step that gives world 2 the card's
#: cost over world 1 (suite_arbitrated)
ROWS, SHARDS, SEQ = 4 * 600, 600, 32
SCHEDULE = dict(pace_s=0.1, capacity_s=1.0, settle_s=20.0,
                windows=(("steady", 0.25, 2.0), ("burst", 1.25, 3.0),
                         ("trickle", 0.1, 2.0)))
WORLD2_SLEEP_S = 0.1


@pytest.fixture(scope="module")
def arbitrated(tmp_path_factory):
    got = tw.run("arbitrated", 2, tmp_path_factory.mktemp("arbitrated"),
                 180, rows=ROWS, shards=SHARDS, seq=SEQ, schedule=SCHEDULE,
                 world2_sleep_s=WORLD2_SLEEP_S)
    return tw.scenario(got, "arbitrated")


def control(order: list) -> list:
    """The one-rank control fed rank 0's batches in its order."""
    runner, reg, _ = flagship_local_job(0, 1, None, device="cpu",
                                        cfg=tfm.TINY, global_batch=4,
                                        seq=SEQ, rows=ROWS, shards=SHARDS)
    return [runner.trainer.step(reg.get(i)) for i in order]


def bucket(ms: float) -> int:
    edges = list(SERVING_LATENCY_BUCKETS) + [math.inf]
    return next(i for i, e in enumerate(edges) if ms / 1e3 <= e)


@pytest.mark.timeout_s(300)
def test_the_planner_decides_and_re_plans_equal(arbitrated):
    r0, _ = arbitrated
    assert not r0["errors"], r0["errors"]
    both = next(t for w, _, _, t in r0["curve_points"] if w == 2)
    after = [m for t, m in r0["modes"] if t > both]
    assert after and set(after) == {"goodput"}, collections.Counter(after)
    assert r0["ticks"] and all(t["audit_ok"] for t in r0["ticks"])
    assert r0["ticks"][0]["mode"] == "goodput"  # the grow is priced
    assert r0["curves"][r0["trainer_job"]].keys() == {1, 2}


@pytest.mark.timeout_s(300)
def test_card_accounting_and_the_rebalance(arbitrated):
    r0, r1 = arbitrated
    uid_t, uid_f = r0["trainer_job"], r0["fleet_job"]
    for t, train, fleet, held, pending in r0["card_samples"]:
        assert train + fleet + held <= 3 and train >= 1, (t, train, fleet)
    assert r0["card_samples"][-1][4] == 0  # nothing stranded pending
    worlds = r0["worlds"]
    assert r1["worlds"] == worlds and min(worlds) >= 1
    i2 = worlds.index(2)
    assert worlds[0] == 1 and 1 in worlds[i2:] and worlds[-1] == 1
    assert [(a, b) for a, b, _, _ in r0["fleet_resizes"]] == [(1, 2)]
    rebalance = [t for t in r0["ticks"] if t["reclaims"]]
    assert len(rebalance) == 1, (r0["curve_points"], r0["ticks"])
    tick = rebalance[0]
    assert tick["target"] == {uid_t: 1, uid_f: 2}
    assert tick["reclaims"] == [(uid_t, uid_f, 2, 1, "rebalance")]
    assert tick["marginals"][uid_f] > 0 > (
        r0["curves"][uid_t][2] - r0["curves"][uid_t][1])
    assert r0["settled"]


@pytest.mark.timeout_s(300)
def test_the_fleet_dial_is_the_planners(arbitrated):
    r0, _ = arbitrated
    uid_f = r0["fleet_job"]
    assert r0["observe_only"] and r0["in_autoscaler"]
    assert r0["serving_plans"] == []  # the SLO policy actuated nothing
    slo = [h for h in r0["hints"] if h[0] == "slo_policy" and h[1] == uid_f]
    planner = [h for h in r0["hints"] if h[0] == "planner" and h[1] == uid_f]
    # the SLO policy's prewarm hint came before the planner's decision
    assert slo and planner and slo[0][3] <= planner[0][3]
    assert r0["fleet_prewarm"]["hits"] >= 1


@pytest.mark.timeout_s(300)
def test_the_trainer_is_the_controls(arbitrated):
    r0, r1 = arbitrated
    assert r0["stats"]["leased"] == 0 and r0["stats"]["dropped"] == 0
    assert r0["stats"]["done"] == len(r0["order"])
    assert len(set(r0["order"])) == len(r0["order"])
    np.testing.assert_allclose(r0["losses"], control(r0["order"]),
                               atol=2e-2, rtol=0)
    assert [x is None for x in r1["losses"]] == [w == 1
                                                  for w in r0["worlds"]]


@pytest.mark.timeout_s(300)
def test_the_fleet_serves_and_the_scrape_plane_agrees(arbitrated):
    r0, _ = arbitrated
    tallies = [w["tally"] for w in r0["windows"].values()]
    tallies += [r0["burn_drill"]["quiet"], r0["burn_drill"]["tally"]]
    for t in tallies:
        assert t["served"] and not (t["dropped"] or t["errors"]
                                    or t["timeouts"]), t
    got, ref = r0["answers"]
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)
    own, seen = r0["compared"]["fleet"], r0["compared"]["scraped"]
    assert abs(seen["qps"] - own["qps"]) <= 0.25 * own["qps"], (own, seen)
    assert abs(bucket(seen["p99_ms"]) - bucket(own["p99_ms"])) <= 1


@pytest.mark.timeout_s(300)
def test_the_alert_rules_fire(arbitrated):
    r0, _ = arbitrated
    burn = r0["burn_drill"]
    assert burn["control_firing"] == []
    assert burn["fired_after"] is not None and burn["fired_after"][0] <= 2
    down = r0["down_drill"]["fired_at_sweep"]
    assert down is not None and down <= 3
    assert r0["leaked"] == 0
