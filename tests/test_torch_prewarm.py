"""Speculative mesh prewarm on the port's SPMD trainer: the scenarios of
tests/test_prewarm.py carried over to spawned gloo worlds of 2 and 4
(tests/torch_world.py::suite_prewarm), with MLP trainers.

The port's stand-in for the reference's ahead-of-time compile is a layout's
mesh and process groups, built on the process's one group-build thread; a
prewarmed layout's groups are warmed by a collective on the step thread
(``prewarm_quiesce``, or the resize that takes it).  In the world of 2 the
trainer grows from 1 to 2; in the world of 4 from 2 to 3, whose prefix
group is a new ``dist.new_group``.  Each world runs every scenario in
sequence, every rank calling prewarm, quiesce and resize at the same
points, within the world's deadline."""

import numpy as np
import pytest

import torch_world as tw

#: each world's children are joined within this deadline
WORLD_DEADLINE_S = 180
WORLDS = {"two": 2, "four": 4}

pytestmark = pytest.mark.timeout_s(240)


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, tmp_path_factory):
    n = WORLDS[request.param]
    x, y = tw.synthetic_classification()
    return n, tw.run("prewarm", n, tmp_path_factory.mktemp(request.param),
                     WORLD_DEADLINE_S, data=(x, y))


def test_prewarm_hit_skips_the_build(world):
    n, results = world
    for rank, g in enumerate(tw.scenario(results, "hit_skips_build")):
        assert g["future"] and g["resized"]
        evt = g["event"]
        assert evt["prewarm_hit"] is True
        # the build happened before the resize: its acquisition is a
        # cache hit
        assert evt["compile_ms"] < 50.0, evt
        assert g["world"] == n // 2 + 1
        assert (g["loss"] is not None) == (rank < g["world"])
        if g["loss"] is not None:
            assert np.isfinite(g["loss"])


def test_resize_mid_prewarm_waits_not_duplicates(world):
    """A resize landing while its layout is still building waits for that
    build, counts as a hit, and builds no group a second time."""
    n, results = world
    for g in tw.scenario(results, "mid_prewarm_waits"):
        assert g["building"] and g["resized"] and g["hit"] is True
        assert g["cached"] and g["in_flight"] == 0
        assert g["prewarms"] == 1
        # the prefix of 3 is the one new group of the world of 4, built
        # once; the world of 2's prefix is the default group
        assert g["new_groups"] == ([[0, 1, 2]] if n == 4 else [])


def test_unused_hints_are_bounded(world):
    """Hints for layouts that never arrive stay bounded: past
    prewarm_cache_limit the oldest unused prewarmed layout is dropped."""
    _, results = world
    for g in tw.scenario(results, "unused_bounded"):
        assert g["speculative"] <= g["limit"]
        assert g["unused"] <= g["limit"]
        assert g["evicted"] >= g["hints"] - g["limit"]


def test_used_prewarm_layout_exempt_from_eviction(world):
    _, results = world
    for g in tw.scenario(results, "used_exempt"):
        assert g["resized"] and g["kept"]


def test_rollback_clean_with_prewarmed_layout(world):
    """An allocation failure staging a resize to a prewarmed layout rolls
    every rank back; the old world keeps training, and the retry is a hit."""
    n, results = world
    for rank, g in enumerate(tw.scenario(results, "rollback")):
        assert g["failed"] is False and g["world"] == n // 2
        assert g["resizes_failed"] == 1
        assert (g["loss"] is not None) == (rank < n // 2)
        assert g["retry"] and g["hit"] is True
        assert (g["after"] is not None) == (rank < n // 2 + 1)


def test_prewarm_skips_invalid_and_current_sizes(world):
    _, results = world
    assert tw.scenario(results, "skips_invalid") == [None] * world[0]


def test_resize_events_record_the_split(world):
    """Each resize's event carries the reference's split; a cold one is a
    miss, a prewarmed one a hit, each counted."""
    _, results = world
    for g in tw.scenario(results, "event_split"):
        for evt in (g["cold"], g["warm"]):
            assert set(evt) >= {"size", "compile_ms", "reshard_ms",
                                "prewarm_hit", "step"}
        assert g["cold"]["prewarm_hit"] is False
        assert g["warm"]["prewarm_hit"] is True
        assert g["hits"] == 1 and g["misses"] == 1


@pytest.mark.parametrize("order", [0, 1])
def test_oscillation_still_correct_with_prewarm(world, order):
    """Grow and shrink through prewarmed layouts keeps learning; the ranks
    live on each layout report the same losses."""
    n, results = world
    got = [g[order] for g in tw.scenario(results, "oscillation")]
    losses = got[0]["losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 2.0
    assert [ok for ok, _ in got[0]["seen"]] == [True] * 3
    assert [hit for _, hit in got[0]["seen"]][:2] == [True, True]
    for g in got[1:]:
        assert all(a == b for a, b in zip(g["losses"], losses)
                   if a is not None)


def test_prewarm_then_inline_build_finishes_bitwise_a_cold_run(world):
    """Speculative builds still queued when a resize builds another layout
    inline: the inline build waits its turn on the build thread, so every
    rank calls new_group in one order and the world finishes within the
    deadline, with the state bitwise that of the same resizes cold."""
    _, results = world
    for g in tw.scenario(results, "prewarm_then_inline"):
        assert g["ok"] == [True] * 4
        assert g["hits"] == [False, True]
        assert g["same"] and g["quiet"]
