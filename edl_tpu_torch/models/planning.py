"""Sharding-plan and memory-fit evidence for large configs — the port of
edl_tpu.models.planning, for H100 cards.

The evidence for a model no single card trains is a *plan*: build the
parameters on the ``meta`` device (shapes, no storage: nothing is
allocated), apply the model's partition specs
(:func:`~edl_tpu_torch.models.transformer.param_partition_specs`) over
candidate meshes, and show arithmetically that every large tensor is
sharded and that each card's bytes of parameters and Adam's two moments
fit its memory with room for gradients and activations.

The meshes are counts of cards: 1, 2, 4 and 8 H100s in one host (NVLink
all to all), and 16 and 32 over hosts.  ``python -m
edl_tpu_torch.models.planning`` prints LLAMA3_8B's table.

The port's specs are the reference's, but the port's model runs tp only
where it divides the kv heads (GQA's query groups would straddle two
ranks): :func:`tp_unsupported_leaves` names the leaves a plan splits that
the port's trainer refuses at that tp.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from math import ceil, prod

#: mesh name → cards: one host's NVLink domain holds up to 8
H100_MESHES = {"1xH100": 1, "2xH100": 2, "4xH100": 4, "8xH100": 8,
               "16xH100 (2 hosts)": 16, "32xH100 (4 hosts)": 32}
#: one card's memory: ``torch.cuda.get_device_properties(0).total_memory``
#: on an NVIDIA H100 80GB HBM3 (85 017 493 504 bytes, read on the card)
H100_MEMORY_BYTES = 85_017_493_504
H100_HBM_GB = H100_MEMORY_BYTES / 1e9


@dataclass(frozen=True)
class LeafPlan:
    name: str
    shape: tuple
    bytes_total: int
    shard_factor: int  # how many ways the leaf is split (1 = replicated)

    @property
    def bytes_per_device(self) -> int:
        return ceil(self.bytes_total / self.shard_factor)


@dataclass(frozen=True)
class MemoryPlan:
    """Per-card accounting of params + Adam(m, v) under the model's
    partition specs on an fsdp×tp mesh."""

    n_devices: int
    tp: int
    n_params: int
    param_bytes_per_device: int
    opt_bytes_per_device: int
    hbm_gb: float
    leaves: list = field(repr=False, default_factory=list)

    @property
    def fsdp(self) -> int:
        return self.n_devices // self.tp

    @property
    def state_gb_per_device(self) -> float:
        return (self.param_bytes_per_device
                + self.opt_bytes_per_device) / 1e9

    @property
    def fits(self) -> bool:
        return self.state_gb_per_device < self.hbm_gb

    def replicated_leaves(self) -> list:
        return [leaf for leaf in self.leaves if leaf.shard_factor == 1]


def _axis_sizes(n_devices: int, tp: int) -> dict:
    if n_devices % tp:
        raise ValueError(f"tp {tp} does not divide {n_devices} cards")
    return {"dp": 1, "fsdp": n_devices // tp, "tp": tp, "sp": 1}


@functools.lru_cache(maxsize=8)
def _meta_params(cfg) -> dict:
    """``cfg``'s parameters by name: (shape, bytes), from the model built
    on the meta device."""
    from edl_tpu_torch.models import transformer as tfm

    return {name: (tuple(p.shape), p.numel() * p.element_size())
            for name, p in tfm.Transformer(cfg, device="meta")
            .named_parameters()}


def _leaf_plans(cfg, n_devices: int, tp: int) -> list:
    from edl_tpu_torch.models import transformer as tfm

    specs = tfm.param_partition_specs(cfg)
    sizes = _axis_sizes(n_devices, tp)
    params = _meta_params(cfg)
    if set(params) != set(specs):
        raise AssertionError("the specs do not name the model's leaves")
    plans = []
    for name in specs:
        shape, nbytes = params[name]
        factor = 1
        for dim, part in enumerate(specs[name]):
            if part is None:
                continue
            axes = (part,) if isinstance(part, str) else part
            dim_factor = prod(sizes[a] for a in axes)
            # the spec only shards what divides evenly: an indivisible dim
            # is a planning error, not padding
            if dim_factor > 1 and shape[dim] % dim_factor:
                raise AssertionError(f"{name} {shape} does not split "
                                     f"{dim_factor} ways on dim {dim}")
            factor *= dim_factor
        plans.append(LeafPlan(name=name, shape=shape, bytes_total=nbytes,
                              shard_factor=factor))
    return plans


def fsdp_memory_plan(cfg, n_devices: int, tp: int = 1,
                     hbm_gb: float = H100_HBM_GB) -> MemoryPlan:
    """Plan params + Adam state over ``n_devices`` cards (fsdp =
    cards/tp).  Adam's two moments are sharded like their parameter (the
    optimizer's state mirrors the parameters, as the trainer lays it out):
    2× the param bytes."""
    leaves = _leaf_plans(cfg, n_devices, tp)
    param_per_dev = sum(leaf.bytes_per_device for leaf in leaves)
    return MemoryPlan(
        n_devices=n_devices, tp=tp,
        n_params=sum(prod(leaf.shape) for leaf in leaves),
        param_bytes_per_device=param_per_dev,
        opt_bytes_per_device=2 * param_per_dev,
        hbm_gb=hbm_gb, leaves=leaves)


def tp_unsupported_leaves(cfg, tp: int) -> list[str]:
    """The leaves a plan at ``tp`` splits that the port's trainer refuses:
    when tp does not divide the kv heads, ``wk`` and ``wv`` of every layer
    would cut a kv head's query group over two ranks (the port's model
    raises; the reference lets GSPMD lay it out).  Empty when tp divides
    them."""
    if tp <= 1 or cfg.n_kv_heads % tp == 0:
        return []
    return [f"layers.{i}.{w}" for i in range(cfg.n_layers)
            for w in ("wk", "wv")]


def format_plan_table(cfg, rows: list[tuple[str, int, int]]) -> str:
    """rows: (mesh name, cards, tp) → markdown table."""
    out = ["| mesh | cards | mesh (fsdp×tp) | params | state GB/card "
           "(params+Adam) | memory | fits |",
           "|---|---|---|---|---|---|---|"]
    for name, n, tp in rows:
        p = fsdp_memory_plan(cfg, n, tp)
        out.append(
            f"| {name} | {n} | {p.fsdp}×{p.tp} | {p.n_params / 1e9:.2f} B "
            f"| {p.state_gb_per_device:.1f} | {p.hbm_gb:.1f} GB "
            f"| {'yes' if p.fits else 'NO'} |")
    return "\n".join(out)


def main() -> int:
    from edl_tpu_torch.models.transformer import LLAMA3_8B

    rows = [(name, n, 1) for name, n in H100_MESHES.items()]
    rows.append(("32xH100 (2-D)", 32, 8))
    print(format_plan_table(LLAMA3_8B, rows))
    plan = fsdp_memory_plan(LLAMA3_8B, 8)
    repl = plan.replicated_leaves()
    print(f"\nreplicated leaves on 8xH100: {len(repl)} (all small norms: "
          f"max {max(leaf.bytes_total for leaf in repl) / 1e6:.3f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
