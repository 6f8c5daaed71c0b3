"""The port's replan (edl_tpu_torch.parallel.replan) held against the JAX
package's: the pure scenarios of tests/test_replan.py, and plan_reshard's
byte accounting equal to the reference's, field for field, on the same
shapes and layouts (jax device ids 0..n-1 standing for ranks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edl_tpu.parallel import mesh as jmesh
from edl_tpu.parallel import replan as jreplan
from edl_tpu_torch.parallel.mesh import MeshShape, MeshSpec
from edl_tpu_torch.parallel.replan import (
    Placement,
    candidate_shapes,
    choose_shape,
    plan_reshard,
    propose_shape,
    total_collective_counts,
    tree_placements,
)

TREE = {"w": np.zeros((16, 32), np.float32), "b": np.zeros((4,), np.float32)}
FIELDS = ("bytes_total", "bytes_stay", "bytes_ici", "bytes_dcn",
          "bytes_moved", "bytes_naive", "max_device_bytes")


def _port_tree(tree):
    """The tree keyed by the reference's leaf paths, in its leaf order."""
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _jshape(shape: MeshShape):
    return jmesh.MeshShape(**shape.axis_sizes())


def _ref_shardings(shape: MeshShape, tree, kind):
    mesh = jmesh.make_mesh(shape.size, _jshape(shape).to_spec(),
                           devices=jax.devices()[:shape.size])
    return jmesh.tree_shardings(mesh, tree, kind)


def _ref_plan(tree, old: MeshShape, new: MeshShape, kind):
    return jreplan.plan_reshard(
        tree, _ref_shardings(old, tree, kind), _ref_shardings(new, tree, kind),
        _jshape(old), _jshape(new))


def _plan(tree, old: MeshShape, new: MeshShape, kind):
    t = _port_tree(tree)
    return plan_reshard(t, tree_placements(t, old, kind),
                        tree_placements(t, new, kind), old, new)


# -- parity with the reference ------------------------------------------------


@pytest.mark.parametrize("kind, old, new", [
    ("replicated", MeshShape(dp=1), MeshShape(dp=2)),
    ("replicated", MeshShape(dp=2), MeshShape(dp=4)),
    ("replicated", MeshShape(dp=4), MeshShape(dp=2)),
    ("fsdp", MeshShape(fsdp=2), MeshShape(fsdp=4)),
    ("fsdp", MeshShape(fsdp=4), MeshShape(fsdp=2)),
    ("fsdp", MeshShape(dp=4), MeshShape(dp=2, fsdp=2)),
    ("fsdp", MeshShape(dp=3), MeshShape(fsdp=3)),
], ids=lambda v: v.describe() if isinstance(v, MeshShape) else v)
def test_plan_reshard_equals_the_reference(kind, old, new):
    tree = {**TREE, "odd": np.zeros((7, 5), np.float32),
            "half": np.zeros((6, 4), np.float16)}
    want = _ref_plan(tree, old, new, kind)
    got = _plan(tree, old, new, kind)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert [(l.path, l.nbytes, l.bytes_stay, l.bytes_ici, l.bytes_dcn,
             l.bytes_naive) for l in got.leaves] == [
        (l.path, l.nbytes, l.bytes_stay, l.bytes_ici, l.bytes_dcn,
         l.bytes_naive) for l in want.leaves]
    assert got.per_device_bytes == want.per_device_bytes
    assert got.summary() == want.summary()


def test_placements_match_the_reference_blocks():
    """sharded() lays ranks out as the reference lays devices: row-major
    over the axes, the fsdp coordinate varying fastest past dp."""
    shape = MeshShape(dp=2, fsdp=2)
    sh = _ref_shardings(shape, {"w": jnp.zeros((16, 32))}, "fsdp")["w"]
    want = {d.id: tuple((s.start or 0, s.stop or n) for s, n in
                        zip(idx, (16, 32)))
            for d, idx in sh.devices_indices_map((16, 32)).items()}
    assert dict(tree_placements({"w": TREE["w"]}, shape, "fsdp")["w"]
                .blocks) == want


# -- the pure scenarios of tests/test_replan.py -----------------------------


def test_mesh_shape_resolution_paths():
    assert MeshShape.resolve(4, spec=MeshSpec(dp=-1)) == MeshShape(dp=4)
    assert MeshShape.resolve(8, spec=MeshSpec(dp=2, fsdp=-1)) == \
        MeshShape(dp=2, fsdp=4)
    s = MeshShape(dp=2, fsdp=2)
    assert MeshShape.resolve(s) is s
    assert s.size == 4 and s.describe() == "dp2xfsdp2"
    assert MeshShape().describe() == "1"
    with pytest.raises(ValueError):
        MeshShape(dp=-1)
    with pytest.raises(ValueError):
        MeshShape.resolve(6, spec=MeshSpec(dp=4))


def test_candidate_shapes_enumerate_dp_fsdp_splits():
    cands = {c.key() for c in candidate_shapes(4)}
    assert cands == {MeshShape(dp=4).key(), MeshShape(dp=2, fsdp=2).key(),
                     MeshShape(fsdp=4).key()}
    base = MeshShape(tp=2)
    assert all(c.tp == 2 for c in candidate_shapes(8, base=base))
    assert all(c.tp == 1 for c in candidate_shapes(3, base=base))
    assert [c.key() for c in candidate_shapes(6)] == [
        jc.key() for jc in jreplan.candidate_shapes(6)]


def test_shape_preserving_plan_moves_nothing_and_beats_naive():
    shape = MeshShape(dp=2, fsdp=2)
    plan = _plan(TREE, shape, shape, "fsdp")
    assert plan.bytes_moved == 0
    assert 0 < plan.bytes_naive and plan.bytes_moved < plan.bytes_naive


def test_grow_plan_classifies_ici_vs_dcn():
    tree = {"w": TREE["w"]}
    grow = _plan(tree, MeshShape(fsdp=2), MeshShape(fsdp=4), "fsdp")
    assert grow.bytes_ici > 0 and grow.bytes_dcn == 0
    assert grow.bytes_stay + grow.bytes_ici == grow.bytes_total
    shrink = _plan(tree, MeshShape(fsdp=4), MeshShape(fsdp=2), "fsdp")
    assert shrink.bytes_dcn > 0
    assert shrink.bytes_moved < shrink.bytes_naive


def test_plan_handles_uneven_divisibility():
    tree = {"odd": np.zeros((7, 5), np.float32),
            "even": np.zeros((6, 4), np.float32)}
    t = _port_tree(tree)
    placed = tree_placements(t, MeshShape(fsdp=3), "fsdp")
    full = Placement.replicated((7, 5), 3)
    assert placed["['odd']"] == full and placed["['even']"] != full
    plan = _plan(tree, MeshShape(dp=3), MeshShape(fsdp=3), "fsdp")
    odd = next(l for l in plan.leaves if "odd" in l.path)
    even = next(l for l in plan.leaves if "even" in l.path)
    assert odd.bytes_moved == 0 and odd.bytes_stay == 3 * odd.nbytes
    assert even.bytes_moved == 0
    assert plan.max_device_bytes == odd.nbytes + even.nbytes // 3


def test_choose_shape_minimizes_transfer_and_respects_memory():
    t = _port_tree(TREE)
    shape0 = MeshShape(dp=4)
    old = tree_placements(t, shape0, "fsdp")
    best, plan = choose_shape(t, old, 4, "fsdp")
    assert best == shape0 and plan.bytes_moved == 0
    total = sum(x.nbytes for x in TREE.values())
    best2, plan2 = choose_shape(t, old, 4, "fsdp",
                                max_bytes_per_device=total // 2)
    assert best2.fsdp > 1 and plan2.max_device_bytes <= total // 2
    best3, _ = choose_shape(t, old, 4, "fsdp", max_bytes_per_device=1)
    assert best3.fsdp == 4
    # the same choices as the reference's, budget by budget
    jold = _ref_shardings(shape0, TREE, "fsdp")
    for budget in (None, total // 2, 1):
        jbest, jplan = jreplan.choose_shape(
            TREE, jold, 4, jax.devices()[:4], "fsdp",
            max_bytes_per_device=budget)
        best, plan = choose_shape(t, old, 4, "fsdp",
                                  max_bytes_per_device=budget)
        assert best.key() == jbest.key()
        assert plan.bytes_moved == jplan.bytes_moved


def test_choose_shape_ranks_by_calibrated_seconds_like_the_reference():
    t = _port_tree(TREE)
    old = tree_placements(t, MeshShape(fsdp=4), "fsdp")
    jold = _ref_shardings(MeshShape(fsdp=4), TREE, "fsdp")
    for factor in (0.5, 3.0):
        best, _ = choose_shape(t, old, 2, "fsdp",
                               calibration=lambda name: factor)
        jbest, _ = jreplan.choose_shape(TREE, jold, 2, jax.devices()[:2],
                                        "fsdp",
                                        calibration=lambda name: factor)
        assert best.key() == jbest.key()


def test_propose_shape_pivots_dp_to_fsdp_on_memory_pressure():
    assert propose_shape(8, state_bytes=100, max_bytes_per_device=100) == \
        MeshShape(dp=8)
    assert propose_shape(8, 100, 50) == MeshShape(dp=4, fsdp=2)
    assert propose_shape(8, 100, 1) == MeshShape(fsdp=8)
    assert propose_shape(6, 100) == MeshShape(dp=6)
    assert propose_shape(8, 100, 50, base=MeshShape(tp=2)) == \
        MeshShape(dp=2, fsdp=2, tp=2)


def test_propose_shape_uses_ceil_division_at_the_budget_boundary():
    s = propose_shape(8, state_bytes=101, max_bytes_per_device=50)
    assert s.fsdp == 4 and -(-101 // s.fsdp) <= 50
    assert propose_shape(8, 100, 50) == MeshShape(dp=4, fsdp=2)
    for n, b, budget, reserved in ((8, 101, 50, 0), (8, 100, 60, 10),
                                   (12, 1000, 90, 5)):
        assert propose_shape(n, b, budget,
                             reserved_bytes_per_device=reserved).key() == \
            jreplan.propose_shape(n, b, budget,
                                  reserved_bytes_per_device=reserved).key()


def test_total_collective_counts_flattens_a_census_as_the_reference():
    """The trainer's census of a one-rank step (no collective), and a
    dp2×fsdp2×tp2 step's shape of census, flattened alike by both
    packages."""
    from edl_tpu_torch.runtime import elastic

    census = {"dp": {"ops": {"all-reduce": 2}, "bytes": 64},
              "fsdp": {"ops": {"all-gather": 1, "reduce-scatter": 1},
                       "bytes": 96},
              "tp": {"ops": {"all-reduce": 37}, "bytes": 1 << 20},
              "checkpoint": {"ops": {"all-gather": 75}, "bytes": 1 << 24}}
    assert total_collective_counts(census) == \
        jreplan.total_collective_counts(census) == {
            "all-reduce": 39, "all-gather": 76, "reduce-scatter": 1}
    elastic.reset_census()
    assert total_collective_counts(elastic.collective_census()) == {}
