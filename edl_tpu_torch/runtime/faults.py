"""Fault-plan engine: scripted, seeded chaos campaigns — the port of
edl_tpu.runtime.faults, its silent-data-corruption kinds so far.

A :class:`FaultPlan` is an ordered campaign of typed fault actions fired on
step or wall-clock triggers; :meth:`FaultPlan.random` derives a whole
campaign from a single seed, drawing exactly as the reference draws, so a
drill is reproducible from the integer that named it.  The
:class:`FaultPlanEngine` plugs into a training loop as its
``on_step(step, loss, world)``, fires due actions against a
:class:`FaultContext`, and then watches each recovery: every injected fault
and completed recovery is a chaos trace event and a labeled counter
(``faults_injected{type=...}``, ``recoveries_completed{type=...}``).

The three SDC kinds (:data:`SDC_KINDS`) strike through the trainer's chaos
seams: :class:`CorruptGradient` (one bit of the summed gradient before the
update), :class:`FlipParamBits` (one bit of a live parameter) and
:class:`PoisonLoss` (a NaN loss report over an honest update).  Their
recovery is the SDC plane's own: a rollback for the first two, a refuted
verdict for the third.

The reference's other kinds are later items of the port (ROADMAP.md): the
training eight (:data:`TRAINING_KINDS`, kills, partitions, torn
checkpoints, full disks, stalls and wedges) come with queue-1 item 6, the
serving five (:data:`SERVING_KINDS`) with item 11.  Naming one raises
``ValueError`` with its item.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.tracing import get_tracer

log = get_logger("runtime.faults")


@dataclass
class FaultContext:
    """Everything a campaign may act on.  All fields optional — an action
    whose dependency is absent raises when it fires, which the engine
    records as unfireable."""

    #: ElasticTrainer under drill — the SDC faults strike through its
    #: chaos seams
    trainer: Any = None
    checkpointer: Any = None     # ElasticCheckpointer
    rng: random.Random = field(default_factory=random.Random)


#: fire() outcomes
FIRED, RETRY = "fired", "retry"


@dataclass
class FaultAction:
    """One scheduled fault.  ``at_step`` triggers on the training-loop
    hook; ``at_time_s`` (relative to engine start) triggers on tick().
    Subclasses implement ``fire(ctx) -> (outcome, recovery)`` where
    ``recovery`` is an optional zero-arg predicate that turns true when the
    system has healed from this fault."""

    at_step: Optional[int] = None
    at_time_s: Optional[float] = None
    kind: str = "fault"

    def due(self, step: int, elapsed_s: float) -> bool:
        if self.at_step is not None:
            return step >= self.at_step
        if self.at_time_s is not None:
            return elapsed_s >= self.at_time_s
        return False

    def describe(self) -> dict:
        d = {"kind": self.kind}
        if self.at_step is not None:
            d["at_step"] = self.at_step
        if self.at_time_s is not None:
            d["at_time_s"] = self.at_time_s
        return d

    def fire(self, ctx: FaultContext):  # pragma: no cover - abstract
        raise NotImplementedError


# -- the silent three --------------------------------------------------------
#
# A flipped bit in the gradient or a parameter, or a lying loss report:
# nothing crashes and nothing hangs, the model is just WRONG.  Only the SDC
# plane's fingerprint/anomaly/shadow ladder can see these, so detection and
# repair IS each drill's recovery condition.


def _sdc_rollbacks_total() -> int:
    return get_counters().total("sdc_rollbacks")


def _sdc_refuted_total() -> int:
    return get_counters().get("sdc_verdicts", outcome="refuted")


@dataclass
class CorruptGradient(FaultAction):
    """Flip one bit in the summed gradient BEFORE the optimizer update (a
    miscompiled reduction, a bad ALU lane): the update is silently wrong
    and every later step inherits the drift.  Recovery = the SDC plane
    confirmed the corruption and rolled the trajectory back
    (``sdc_rollbacks`` moved)."""

    kind: str = "corrupt_gradient"

    def fire(self, ctx: FaultContext):
        if ctx.trainer is None:
            raise RuntimeError("CorruptGradient needs a trainer in the ctx")
        before = _sdc_rollbacks_total()
        log.warn("fault: corrupting next accumulated gradient")
        ctx.trainer.inject_update_corruption(1)
        return FIRED, lambda: _sdc_rollbacks_total() > before


@dataclass
class FlipParamBits(FaultAction):
    """Flip one bit of one LIVE parameter leaf (a latent chip writing back
    a wrong word between steps).  Recovery like :class:`CorruptGradient`:
    confirmed and rolled back."""

    leaf: int = 0
    bit: int = 17

    kind: str = "flip_param_bits"

    def fire(self, ctx: FaultContext):
        if ctx.trainer is None:
            raise RuntimeError("FlipParamBits needs a trainer in the ctx")
        before = _sdc_rollbacks_total()
        log.warn("fault: flipping live parameter bit", leaf=self.leaf,
                 bit=self.bit)
        ctx.trainer.flip_param_bits(leaf=self.leaf, bit=self.bit)
        return FIRED, lambda: _sdc_rollbacks_total() > before

    def describe(self) -> dict:
        return {**super().describe(), "leaf": self.leaf, "bit": self.bit}


@dataclass
class PoisonLoss(FaultAction):
    """The metric path lies (NaN loss report) over CLEAN parameters — the
    false-alarm half of the drills.  Recovery = the shadow recompute
    REFUTED it (``sdc_verdicts{outcome=refuted}`` moved): the defense must
    not roll back a healthy trainer."""

    kind: str = "poison_loss"

    def fire(self, ctx: FaultContext):
        if ctx.trainer is None:
            raise RuntimeError("PoisonLoss needs a trainer in the ctx")
        before = _sdc_refuted_total()
        log.warn("fault: poisoning next loss report")
        ctx.trainer.inject_loss_poison(1)
        return FIRED, lambda: _sdc_refuted_total() > before


#: the reference's training eight and serving five, frozen as it freezes
#: them; their actions are later items of the port
TRAINING_KINDS = ("kill_trainer", "kill_coordinator", "network_flake",
                  "preempt_domain", "corrupt_checkpoint", "disk_full",
                  "stall_step", "wedge_collective")
SERVING_KINDS = ("slow_upstream", "gray_replica", "conn_flap",
                 "partial_partition", "coord_partition")

#: the silent three: pass ``kinds=SDC_KINDS`` to :meth:`FaultPlan.random`
#: for a corruption campaign
SDC_KINDS = ("corrupt_gradient", "flip_param_bits", "poison_loss")

#: kind string → action class (the ported kinds)
ACTION_TYPES = {cls.kind: cls  # type: ignore[attr-defined]
                for cls in (CorruptGradient, FlipParamBits, PoisonLoss)}

#: each kind the port lacks → the ROADMAP.md item that brings it
UNPORTED_KINDS = {**{k: "queue 1 item 6" for k in TRAINING_KINDS},
                  **{k: "queue 1 item 11" for k in SERVING_KINDS}}


def _check_ported(kinds) -> None:
    missing = [k for k in kinds if k not in ACTION_TYPES]
    if missing:
        items = sorted({UNPORTED_KINDS.get(k, "no item") for k in missing})
        raise ValueError(
            f"fault kinds {missing} are not ported yet (ROADMAP.md "
            f"{', '.join(items)}); the port has {sorted(ACTION_TYPES)}")


@dataclass
class FaultPlan:
    """An ordered campaign of fault actions plus the seed that named it."""

    actions: list[FaultAction] = field(default_factory=list)
    seed: Optional[int] = None

    def describe(self) -> list[dict]:
        """The reproducible audit view: what fires when, with what params.
        Two plans built from the same seed describe identically."""
        return [a.describe() for a in self.actions]

    @classmethod
    def random(cls, seed: int, *, n_faults: int = 6,
               first_step: int = 5, last_step: int = 120,
               min_gap: int = 8,
               kinds: tuple[str, ...] = TRAINING_KINDS,
               flake_duration_s: float = 1.0) -> "FaultPlan":
        """Derive a whole campaign deterministically from ``seed``, drawing
        exactly as the reference draws: ``n_faults`` actions from ``kinds``
        (each kind at least once when ``n_faults`` allows), at strictly
        increasing steps at least ``min_gap`` apart.  ``kinds`` defaults to
        the reference's training eight, which raise here until item 6
        brings them; pass :data:`SDC_KINDS`.  ``flake_duration_s`` shapes
        the network and serving kinds only."""
        _check_ported(kinds)
        rng = random.Random(seed)
        if n_faults < len(kinds):
            chosen = rng.sample(list(kinds), n_faults)
        else:
            chosen = list(kinds)
            while len(chosen) < n_faults:
                chosen.append(rng.choice(kinds))
        rng.shuffle(chosen)
        span = max(last_step - first_step - min_gap * (n_faults - 1), 1)
        offsets = sorted(rng.randrange(span) for _ in range(n_faults))
        actions: list[FaultAction] = [
            ACTION_TYPES[kind](at_step=first_step + offsets[i] + min_gap * i)
            for i, kind in enumerate(chosen)]
        return cls(actions=actions, seed=seed)


class FaultPlanEngine:
    """Fires a :class:`FaultPlan` against a :class:`FaultContext` and
    audits the recoveries.

    Wire it into a training loop as ``loop.run(on_step=engine)``, or drive
    wall-clock campaigns with periodic :meth:`tick` calls.  Each call fires
    every due, not-yet-fired action (one whose preconditions are not met
    stays armed and retries on the next call), then polls the pending
    recovery predicates.  ``fired`` / ``recovered`` record the audit trail;
    :meth:`quiescent` is the drill's exit condition."""

    def __init__(self, plan: FaultPlan, ctx: FaultContext,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.plan = plan
        self.ctx = ctx
        self._clock = clock
        self._t0 = clock()
        self._armed: list[FaultAction] = list(plan.actions)
        self._pending: list[tuple[str, Callable[[], bool]]] = []
        self._lock = threading.Lock()
        #: (step, kind) of every action actually fired, in firing order
        self.fired: list[tuple[int, str]] = []
        #: kinds whose engine-watched recovery predicate turned true
        self.recovered: list[str] = []

    def __call__(self, step: int, loss: float = 0.0, world: int = 0) -> None:
        self._advance(step)

    def tick(self) -> None:
        """Clock-only advance (time-triggered campaigns, idle polling)."""
        self._advance(-1)

    def quiescent(self) -> bool:
        """True when every action has fired and every engine-watched
        recovery has completed."""
        with self._lock:
            return not self._armed and not self._pending

    def unfired(self) -> list[dict]:
        with self._lock:
            return [a.describe() for a in self._armed]

    # -- internals ----------------------------------------------------------

    def _advance(self, step: int) -> None:
        elapsed = self._clock() - self._t0
        # claim due actions under the lock BEFORE firing: a concurrent
        # on_step/tick caller must not fire the same action twice
        with self._lock:
            due = [a for a in self._armed if a.due(step, elapsed)]
            for a in due:
                self._armed.remove(a)
        for action in due:
            try:
                outcome, recovery = action.fire(self.ctx)
            except Exception as exc:
                # a misconfigured action must not kill the drill loop —
                # surface it in the audit trail and leave it disarmed
                log.warn("fault action failed to fire", kind=action.kind,
                         error=str(exc))
                get_tracer().instant("fault_unfireable", category="chaos",
                                     type=action.kind, error=str(exc)[:120])
                continue
            if outcome == RETRY:
                with self._lock:  # re-arm; strikes when preconditions return
                    self._armed.append(action)
                continue
            with self._lock:
                self.fired.append((step, action.kind))
                if recovery is not None:
                    self._pending.append((action.kind, recovery))
            get_tracer().instant("fault_injected", category="chaos",
                                 type=action.kind, step=step,
                                 elapsed_s=round(elapsed, 3))
            get_counters().inc("faults_injected", type=action.kind)
        self._check_recoveries(step)

    def _check_recoveries(self, step: int) -> None:
        with self._lock:
            pending = list(self._pending)
        for kind, predicate in pending:
            try:
                healed = bool(predicate())
            except Exception:
                healed = False  # probe hiccup ≠ recovery
            if not healed:
                continue
            with self._lock:
                if (kind, predicate) not in self._pending:
                    continue  # a concurrent caller already recorded it
                self._pending.remove((kind, predicate))
                self.recovered.append(kind)
            log.info("recovery completed", type=kind, step=step)
            get_tracer().instant("recovery_completed", category="chaos",
                                 type=kind, step=step)
            get_counters().inc("recoveries_completed", type=kind)
