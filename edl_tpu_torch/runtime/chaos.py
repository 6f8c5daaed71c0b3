"""Chaos injection for elastic-training tests and drills — the port's
copy of edl_tpu.runtime.chaos.

The reference validated fault tolerance manually — killing pods by hand
and watching the job survive (reference doc/boss_tutorial.md:271-301);
SURVEY §5.3 calls for making that programmatic.  :class:`ChaosMonkey` is
the kill-a-trainer-every-N-steps fixture: wired into a training loop's
``on_step`` callback, it periodically fails a trainer pod on the (fake)
cluster, exercising the whole recovery chain — pod replacement by the Job
controller, membership epoch bump, mesh resize at the next step boundary,
and task-queue re-dispatch of the dead trainer's leased shard.

ChaosMonkey automates exactly ONE fault on a fixed cadence.  For scripted
multi-fault campaigns — coordinator kills, network flakes, domain
preemptions, checkpoint corruption — see the fault-plan engine in
:mod:`edl_tpu_torch.runtime.faults`, which generalizes this fixture into seeded,
auditable drills.
"""

from __future__ import annotations

import random
from typing import Optional

from edl_tpu_torch.cluster.base import PodPhase
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.tracing import get_tracer

log = get_logger("runtime.chaos")


class ChaosMonkey:
    """Kill one running trainer pod every ``every_n_steps`` steps.

    ``__call__(step, loss, world)`` matches the ``on_step`` callback
    signature of :class:`~edl_tpu_torch.runtime.local.LocalElasticJob`, so:

        monkey = ChaosMonkey(cluster, job, every_n_steps=10)
        local_job.run(on_step=monkey)
    """

    def __init__(self, cluster, job, every_n_steps: int,
                 max_kills: Optional[int] = None, seed: int = 0,
                 victim_phase: PodPhase = PodPhase.FAILED) -> None:
        self._cluster = cluster
        self._job = job
        self._every = max(every_n_steps, 1)
        self._max_kills = max_kills
        self._rng = random.Random(seed)
        self._phase = victim_phase
        self.kills: list[str] = []

    def __call__(self, step: int, loss: float = 0.0, world: int = 0) -> None:
        if step % self._every != 0:
            return
        if self._max_kills is not None and len(self.kills) >= self._max_kills:
            return
        victims = [
            p for p in self._cluster.list_pods(
                job_uid=self._job.full_name, role="trainer")
            if p.phase == PodPhase.RUNNING
        ]
        if not victims:
            return
        victim = self._rng.choice(victims)
        log.warn("chaos: killing trainer pod", pod=victim.name, step=step)
        get_tracer().instant("chaos_kill", category="chaos",
                             pod=victim.name, step=step)
        get_counters().inc("faults_injected", type="kill_trainer")
        self._cluster.kill_pod(victim.name, self._phase)
        self.kills.append(victim.name)
