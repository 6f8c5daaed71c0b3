"""The port's memory plan (edl_tpu_torch.models.planning) against the JAX
package's (edl_tpu.models.planning): tests/test_llama8b_plan.py's claims
for H100 meshes of 1 to 32 cards, and every plan equal to the reference's,
leaf by leaf, on LLAMA3_8B, FLAGSHIP and LARGE at each card count and tp
that divides them.  The port's specs are the reference's; where the port's
trainer refuses a layout the reference plans (tp not dividing the kv heads,
ROADMAP.md queue 2 C2) the leaves are named with the reason.  A TINY world
of 2 (tests/torch_world.py, ``suite_plan_two``) holds, rank by rank, the
bytes the plan gives for fsdp 2 and for tp 2."""

from __future__ import annotations

import jax
import numpy as np
import pytest

import torch_world as tw
from edl_tpu.models import planning as jplanning
from edl_tpu.models import transformer as jtfm
from edl_tpu_torch.models import planning
from edl_tpu_torch.models import transformer as tfm
from tests.torch_decode_ref import PARAMS as TINY_PARAMS

BIG_LEAF_BYTES = 32 << 20  # anything larger must not be replicated
CONFIGS = {"llama3_8b": (tfm.LLAMA3_8B, jtfm.LLAMA3_8B),
           "flagship": (tfm.FLAGSHIP, jtfm.FLAGSHIP),
           "large": (tfm.LARGE, jtfm.LARGE)}
MESHES = [(n, tp) for n in (1, 2, 4, 8, 16, 32) for tp in (1, 2, 8)
          if n % tp == 0]


def ref_name(path: str) -> str:
    """``['layers'][0]['wq']`` → ``layers.0.wq``."""
    return ".".join(p.strip("'") for p in path.strip("[]").split("]["))


def ref_plan(cfg, n: int, tp: int):
    """The reference's plan, or None where it refuses the mesh (a dim the
    specs split that the mesh does not divide)."""
    try:
        return jplanning.fsdp_memory_plan(cfg, n, tp)
    except AssertionError:
        return None


@pytest.mark.parametrize("n,tp", MESHES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_equals_the_reference(name, n, tp):
    cfg, jcfg = CONFIGS[name]
    want = ref_plan(jcfg, n, tp)
    if want is None:
        with pytest.raises(AssertionError, match="does not split"):
            planning.fsdp_memory_plan(cfg, n, tp)
        return
    got = planning.fsdp_memory_plan(cfg, n, tp)
    assert (got.n_params, got.param_bytes_per_device,
            got.opt_bytes_per_device, got.fsdp, got.tp) == (
        want.n_params, want.param_bytes_per_device,
        want.opt_bytes_per_device, want.fsdp, want.tp)
    ref_leaves = {ref_name(leaf.name): leaf for leaf in want.leaves}
    assert {leaf.name for leaf in got.leaves} == set(ref_leaves)
    for leaf in got.leaves:
        r = ref_leaves[leaf.name]
        assert (leaf.shape, leaf.bytes_total, leaf.shard_factor,
                leaf.bytes_per_device) == (r.shape, r.bytes_total,
                                           r.shard_factor, r.bytes_per_device)
    # the port's memory is the H100's, the reference's the v5p's
    assert got.hbm_gb == planning.H100_HBM_GB
    assert got.state_gb_per_device == want.state_gb_per_device


@pytest.mark.parametrize("name,tp", [("flagship", 8), ("large", 8),
                                     ("llama3_8b", 8), ("flagship", 2)])
def test_leaves_the_port_refuses_are_named(name, tp):
    """FLAGSHIP's 2 and LARGE's 4 kv heads do not divide by 8: the plan
    (the reference's) splits wk and wv into parts of a head, which the
    port's model refuses (GQA's query groups would straddle two ranks).
    LLAMA3_8B's 8 kv heads divide by 8, and FLAGSHIP's 2 by 2: nothing."""
    cfg, _ = CONFIGS[name]
    named = planning.tp_unsupported_leaves(cfg, tp)
    if cfg.n_kv_heads % tp == 0:
        assert named == []
        return
    assert named == [f"layers.{i}.{w}" for i in range(cfg.n_layers)
                     for w in ("wk", "wv")]
    plan = planning.fsdp_memory_plan(cfg, 8, tp)
    for leaf in plan.leaves:
        if leaf.name in named:
            cols = leaf.shape[1] // tp
            assert cols < cfg.head_dim  # a part of one kv head a rank
            assert leaf.shard_factor == tp


def test_llama8b_is_8b_class():
    plan = planning.fsdp_memory_plan(tfm.LLAMA3_8B, 8)
    assert 7.0e9 < plan.n_params < 8.5e9, plan.n_params
    # fp32 params + 2 Adam moments = 12 bytes/param
    total_state_gb = plan.state_gb_per_device * 8
    assert total_state_gb == pytest.approx(12 * plan.n_params / 1e9,
                                           rel=0.01)


@pytest.mark.parametrize("mesh,n_devices", sorted(
    planning.H100_MESHES.items()))
def test_plan_shards_every_big_leaf_and_fits_memory(mesh, n_devices):
    """Every big leaf sharded beyond one card; the state fits from 2 cards
    on and within a quarter of the card's memory from 8 (the reference's
    smallest slice, v5p-16, is 8 devices); one card would hold 86.9 GB of
    state, more than the card."""
    plan = planning.fsdp_memory_plan(tfm.LLAMA3_8B, n_devices)
    if n_devices > 1:
        big_replicated = [leaf for leaf in plan.leaves
                          if leaf.shard_factor == 1
                          and leaf.bytes_total > BIG_LEAF_BYTES]
        assert big_replicated == []
        for leaf in plan.replicated_leaves():
            assert leaf.bytes_total <= 32 << 10, leaf
    assert plan.fits == (n_devices > 1)
    if n_devices >= 8:
        assert plan.state_gb_per_device < planning.H100_HBM_GB / 4
    if n_devices > 8:
        base = planning.fsdp_memory_plan(tfm.LLAMA3_8B, 8)
        assert plan.state_gb_per_device == pytest.approx(
            base.state_gb_per_device * 8 / n_devices, rel=0.05)


def test_plan_2d_mesh_tp_times_fsdp():
    p1 = planning.fsdp_memory_plan(tfm.LLAMA3_8B, 32, tp=1)
    p2 = planning.fsdp_memory_plan(tfm.LLAMA3_8B, 32, tp=8)
    assert p2.fsdp == 4 and p2.tp == 8
    assert p2.state_gb_per_device == pytest.approx(
        p1.state_gb_per_device, rel=0.05)
    assert planning.tp_unsupported_leaves(tfm.LLAMA3_8B, 8) == []


def test_plan_table_lists_every_mesh():
    rows = [(name, n, 1) for name, n in planning.H100_MESHES.items()]
    table = planning.format_plan_table(tfm.LLAMA3_8B, rows).splitlines()
    assert len(table) == 2 + len(rows)
    assert table[2].startswith("| 1xH100 | 1 | 1×1 | 7.24 B | 86.9 |")
    assert table[2].endswith("| NO |")
    assert all(line.endswith("| yes |") for line in table[3:])


def test_plan_builds_nothing():
    """The plan reads shapes from the meta device: 7.24 B parameters and
    no storage."""
    params = planning._meta_params(tfm.LLAMA3_8B)
    assert sum(int(np.prod(s)) for s, _ in params.values()) \
        == planning.fsdp_memory_plan(tfm.LLAMA3_8B, 1).n_params
    model = tfm.Transformer(tfm.TINY, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.timeout_s(240)
def test_tiny_world_holds_the_planned_bytes(tmp_path):
    """A TINY world of 2 laid out by the specs, fsdp 2 then tp 2: each
    rank's blocks of every parameter are the plan's bytes a device, and
    Adam's moments twice their sum."""
    res = tw.run("plan_two", 2, tmp_path, 180,
                 tiny_params=jax.tree.map(np.asarray, TINY_PARAMS))
    for scen, tp in (("fsdp_2", 1), ("tp_2", 2)):
        plan = planning.fsdp_memory_plan(tfm.TINY, 2, tp)
        want = {leaf.name: leaf.bytes_per_device for leaf in plan.leaves}
        for got in tw.scenario(res, scen):
            assert got["params"] == want
            assert got["moments"] == plan.opt_bytes_per_device
            assert sum(got["params"].values()) \
                == plan.param_bytes_per_device
