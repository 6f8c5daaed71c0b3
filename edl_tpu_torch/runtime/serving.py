"""Elastic inference serving — the port of edl_tpu.runtime.serving: the
single-shot half (one forward a request) and the token-level decode half,
each on torch devices.

The single-shot half:

* :class:`ElasticServer` — the forward-only twin of
  :class:`~edl_tpu_torch.runtime.elastic.ElasticTrainer`: its layouts,
  prewarm and transactional resize, running ``apply_fn(model, batch)``
  under ``torch.inference_mode`` instead of a train step.
* :class:`ServingReplica` — one model-server loop with **continuous
  batching**: every iteration packs whatever requests the admission queue
  holds (up to ``max_batch_size``, padded to the fixed batch shape) into
  one serve step; per-request latency lands in an ms-scale histogram and
  the SLO violation counter.  Weight swaps apply **between** iterations.
* :class:`ServingFleet` — the replica set: least-queue routing over READY
  replicas, **hint→prewarm scale-up** (the autoscaler's plan builds and
  warms the new replica BEFORE traffic shifts — the ready gate opens only
  once its warm-up forward has run), **graceful drain** on scale-down
  (zero dropped requests), and **rolling weight reloads** from a training
  job's checkpoint lineage.  A replica of one device is a thread of the
  fleet's process; a replica of n devices (``chips_per_replica``) is n
  rank processes behind a :class:`RankGroupServer`, each holding the SPMD
  :class:`ElasticServer` over their own process group.
* :class:`PoissonTraffic` — seeded open-loop traffic; :func:`serve_main`
  — one replica's pod entry point (``python -m
  edl_tpu_torch.runtime.serving [--device cpu]``).

The decode half:

* Sessions join and leave the running decode batch at every iteration,
  slot-packed into a fixed batch shape; a finished sequence frees its slot
  and its KV blocks at once.
* Prompt prefill is CHUNKED and interleaved against decode under a
  TPOT-protecting budget, picked by weighted fair queueing across the
  priority classes (:class:`TokenScheduler`).
* Each session's K/V lives in its replica's paged
  :class:`~edl_tpu_torch.runtime.kvcache.KVBlockPool`; a fleet scale-down
  evacuates it device to device onto the survivors, so a resize drops no
  session.
* Prefill and decode disaggregate as two replica ROLES: a prefill replica
  computes the prompt's K/V and first token, then hands the cache to the
  decode replica that owns the session from then on.
* Speculative decode: each slot feeds its next token plus n-gram drafts
  through one verify step, accepted by the strict greedy rule, so the
  continuation equals single-token greedy decode.
* Weights reload live from a training job's checkpoint lineage
  (:meth:`DecodeFleet.reload_from_lineage`, :meth:`DecodeFleet.
  watch_lineage`): only a verified step ships, each replica swapping at an
  iteration boundary with its sessions' caches kept.

Each replica's loop runs on its own thread and launches on its device's
current stream; a decode replica reads the device once an iteration (the
argmax of every slot), a single-shot one copies its batch in and its
outputs out once an iteration.  Replicas take a ``device`` (CUDA by
default); a decode fleet places all of its replicas on one device, each
replica's KV pool on one device or sharded over several
(``devices_per_replica``).

Scrape names (``edl_`` prefix): ``serving_request_seconds`` and
``serving_span_seconds{phase=admit|queue|batch|forward|respond}``
(histograms), ``serving_queue_depth`` (histogram, observed per iteration),
``serving_requests_total`` / ``serving_slo_violations_total`` /
``serving_dropped_requests_total`` / ``serving_prewarm_hits_total`` /
``serving_prewarm_misses_total`` (counters), ``serving_replicas_ready`` /
``serving_replicas_active`` / ``serving_weight_generation`` (gauges,
labeled ``job=``); ``serving_ttft_seconds`` /
``serving_tpot_seconds`` (histograms labeled ``priority=``, pre-registered),
``serving_decode_tokens_total`` / ``serving_prefill_chunks_total`` /
``serving_sessions_total{outcome=}`` / ``serving_session_migrations_total``
/ ``serving_ttft_slo_violations_total`` / ``serving_tpot_slo_violations_total``
/ ``serving_reloads_total`` / ``serving_reload_skipped_unverified_total``
/ ``decode_spec_*`` (counters),
``serving_sessions_active`` / ``serving_chips`` (gauges) and the KV-pool
series of kvcache.py.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import os
import pickle
import shutil
import signal
import tempfile
import threading
import time
from multiprocessing import connection as mp_connection
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from edl_tpu_torch.device import resolve
from edl_tpu_torch.interop import keystr
from edl_tpu_torch.models import llama
from edl_tpu_torch.observability import calib
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import (
    SERVING_LATENCY_BUCKETS,
    SERVING_TPOT_BUCKETS,
    SERVING_TTFT_BUCKETS,
    get_registry,
)
from edl_tpu_torch.observability.tracing import get_tracer, new_trace_id
from edl_tpu_torch.parallel.mesh import outside_group
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.checkpoint import param_path
from edl_tpu_torch.runtime.elastic import (ElasticTrainer, _all_gather,
                                           rank_processes)
from edl_tpu_torch.runtime.kvcache import (
    KVBlockPool,
    KVDevicePayload,
    KVPoolExhausted,
    payload_to_host,
)

log = get_logger("runtime.serving")

#: replica lifecycle states
BUILDING = "building"
READY = "ready"
RELOADING = "reloading"
DRAINING = "draining"
STOPPED = "stopped"

#: session lifecycle states
S_QUEUED = "queued"
S_PREFILL = "prefill"
S_DECODING = "decoding"
S_DONE = "done"
S_FAILED = "failed"

#: the KV key a fleet publishes its weight generation under, and a trainer
#: may publish a new step under: the lineage watcher long-polls it
SERVING_GEN_KEY = "serving-gen/{job}"

#: priority classes (weighted fair queueing + per-class TTFT/TPOT SLOs)
PRI_HIGH, PRI_NORMAL, PRI_LOW = 0, 1, 2
PRI_NAMES = {PRI_HIGH: "high", PRI_NORMAL: "normal", PRI_LOW: "low"}
#: WFQ service weights per class (share of prefill bandwidth under
#: contention; every live slot decodes every iteration)
DEFAULT_WFQ_WEIGHTS = {PRI_HIGH: 4.0, PRI_NORMAL: 2.0, PRI_LOW: 1.0}


@dataclass
class FleetStats:
    """One windowed observation of the fleet."""

    p50_ms: float = 0.0
    p99_ms: float = 0.0
    qps: float = 0.0
    queue_depth: int = 0
    replicas_ready: int = 0
    replicas_active: int = 0
    requests_windowed: int = 0
    ttft_p99_ms: float = 0.0
    tpot_p50_ms: float = 0.0
    decode_tps: float = 0.0
    sessions: int = 0
    kv_blocks_used: int = 0
    kv_blocks_total: int = 0
    chips: int = 0
    tok_s_per_chip: float = 0.0
    spec_accept_rate: float = 0.0
    #: windowed prefix-share hit rate: prefix-index hits per session
    #: admission (0 when sharing is off or the fleet is stateless)
    prefix_hit_rate: float = 0.0


class SessionDropped(RuntimeError):
    """The session's replica died without a possible handoff, or a forced
    stop abandoned it — always surfaced typed, never a hang."""


class DecodeSession:
    """One autoregressive request: prompt in, tokens streamed out.

    The session object is the stable identity across its whole life —
    prefill on one replica, handoff, decode on another, migration through
    a resize; replicas only borrow it.  ``cached`` counts the KV positions
    written for it on its current replica (= the absolute position the
    next fed token takes)."""

    def __init__(self, prompt, max_new_tokens: int,
                 priority: int = PRI_NORMAL, id: int = 0,
                 trace_id: Optional[str] = None) -> None:
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.max_new_tokens = max(int(max_new_tokens), 1)
        self.priority = int(priority)
        self.id = id
        self.trace_id = trace_id
        self.generated: list[int] = []
        self.state = S_QUEUED
        self.cached = 0
        self.replica: Optional[str] = None
        self.slot: Optional[int] = None
        self.migrations = 0
        self.t_submit = time.perf_counter()
        self.t_first_token = 0.0
        self.t_last_token = 0.0
        self.t_done = 0.0
        self.error: Optional[BaseException] = None
        self._first = threading.Event()
        self._done = threading.Event()
        self._vfinish = 0.0  # WFQ virtual finish time (scheduler-owned)
        self.on_token: Optional[Callable[["DecodeSession", int], None]] = None
        #: fires exactly once on finish OR fail
        self.on_done: Optional[Callable[["DecodeSession"], None]] = None

    # -- the waiter surface --------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> list[int]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"session {self.id} incomplete "
                               f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return list(self.generated)

    def wait_first_token(self, timeout: Optional[float] = None) -> int:
        if not self._first.wait(timeout):
            raise TimeoutError(f"session {self.id} no first token "
                               f"in {timeout}s")
        if self.error is not None:
            raise self.error
        return self.generated[0]

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def ttft_s(self) -> float:
        return max(self.t_first_token - self.t_submit, 0.0)

    @property
    def tpot_s(self) -> float:
        """Mean inter-token time over the generated tail (TTFT
        excluded)."""
        n = len(self.generated)
        if n < 2 or self.t_last_token <= self.t_first_token:
            return 0.0
        return (self.t_last_token - self.t_first_token) / (n - 1)

    # -- replica-side transitions -------------------------------------------

    def span_tokens(self) -> int:
        """The KV span a session reserves in full: its prompt and every
        token it may generate (a resumed session's history lies inside
        it)."""
        return len(self.prompt) + self.max_new_tokens

    def resume_tokens(self) -> list[int]:
        """Tokens whose K/V a (re)prefill must cover: the prompt plus every
        generated token but the newest (the next decode input)."""
        if not self.generated:
            return list(self.prompt)
        return self.prompt + self.generated[:-1]

    def emit(self, token: int) -> None:
        now = time.perf_counter()
        self.generated.append(int(token))
        self.t_last_token = now
        if not self._first.is_set():
            self.t_first_token = now
            self._first.set()
        if self.on_token is not None:
            try:
                self.on_token(self, int(token))
            except Exception:
                log.warn("session on_token callback failed", session=self.id)

    def finish(self) -> None:
        self.state = S_DONE
        self.t_done = time.perf_counter()
        self._done.set()
        self._notify_done()

    def fail(self, exc: BaseException) -> None:
        self.state = S_FAILED
        self.error = exc
        self.t_done = time.perf_counter()
        self._first.set()
        self._done.set()
        self._notify_done()

    def _notify_done(self) -> None:
        cb, self.on_done = self.on_done, None
        if cb is not None:
            try:
                cb(self)
            except Exception:
                log.warn("session on_done callback failed", session=self.id)


class TokenScheduler:
    """Iteration-level scheduling policy: WHO prefills next (weighted fair
    queueing across priority classes) and WHEN prefill may run at all (an
    interleave budget against the running decode batch).

    WFQ is start-time fair queueing over prefill service: admission stamps
    a session the virtual finish ``F = max(V, F_class) + prompt_tokens /
    weight``; the pending session with the smallest F prefills next, and V
    advances to it.

    The interleave budget: at most one prefill chunk per
    ``decode_per_prefill`` decode iterations while any session decodes.
    With ``tpot_budget_ms`` set it is ADAPTIVE: from the EWMAs of measured
    decode iterations and prefill chunks, the spacing becomes
    ``ceil(prefill_ms / (tpot_budget_ms - decode_ms))``, clamped to [1, 64];
    until both EWMAs have a sample (or with no budget) the static count
    applies."""

    def __init__(self, weights: Optional[dict] = None,
                 decode_per_prefill: int = 2, tpot_budget_ms: float = 0.0,
                 ewma_alpha: float = 0.2) -> None:
        self.weights = dict(DEFAULT_WFQ_WEIGHTS)
        if weights:
            self.weights.update(weights)
        self.decode_per_prefill = max(int(decode_per_prefill), 1)
        self.tpot_budget_ms = float(tpot_budget_ms)
        self._alpha = min(max(float(ewma_alpha), 0.01), 1.0)
        self._decode_ms: Optional[float] = None
        self._prefill_ms: Optional[float] = None
        self._vtime = 0.0
        self._class_finish = {p: 0.0 for p in self.weights}
        self._decode_since_prefill = 0

    def stamp(self, sess: DecodeSession) -> None:
        """Assign the WFQ virtual finish at admission."""
        w = self.weights.get(sess.priority,
                             self.weights.get(PRI_NORMAL, 1.0))
        start = max(self._vtime, self._class_finish.get(sess.priority, 0.0))
        sess._vfinish = start + len(sess.resume_tokens()) / max(w, 1e-9)
        self._class_finish[sess.priority] = sess._vfinish

    def pick_prefill(self, pending: Sequence[DecodeSession]
                     ) -> Optional[DecodeSession]:
        if not pending:
            return None
        sess = min(pending, key=lambda s: (s._vfinish, s.id))
        self._vtime = max(self._vtime, sess._vfinish)
        return sess

    def allow_prefill(self, decoding: int, prefill_pending: int) -> bool:
        if prefill_pending == 0:
            return False
        if decoding == 0:
            return True
        return (self._decode_since_prefill
                >= self.effective_decode_per_prefill())

    def effective_decode_per_prefill(self) -> int:
        """The live interleave spacing."""
        if (self.tpot_budget_ms <= 0.0 or self._decode_ms is None
                or self._prefill_ms is None):
            return self.decode_per_prefill
        headroom = self.tpot_budget_ms - self._decode_ms
        if headroom <= 0.0:
            return 64
        return min(max(int(-(-self._prefill_ms // headroom)), 1), 64)

    def predicted_decode_ms(self) -> Optional[float]:
        """The decode-iteration EWMA, read before :meth:`note_decode`
        folds the next measurement in."""
        return self._decode_ms

    def predicted_prefill_ms(self) -> Optional[float]:
        return self._prefill_ms

    def note_decode(self, ms: Optional[float] = None) -> None:
        self._decode_since_prefill += 1
        if ms is not None:
            self._decode_ms = (float(ms) if self._decode_ms is None
                               else self._alpha * float(ms)
                               + (1 - self._alpha) * self._decode_ms)

    def note_prefill(self, ms: Optional[float] = None) -> None:
        self._decode_since_prefill = 0
        if ms is not None:
            self._prefill_ms = (float(ms) if self._prefill_ms is None
                                else self._alpha * float(ms)
                                + (1 - self._alpha) * self._prefill_ms)


def _ttft_hist():
    return get_registry().histogram(
        "serving_ttft_seconds",
        help="time to first token (submit to first emit)",
        buckets=SERVING_TTFT_BUCKETS)


def _tpot_hist():
    return get_registry().histogram(
        "serving_tpot_seconds",
        help="per-output-token time (decode inter-token interval)",
        buckets=SERVING_TPOT_BUCKETS)


class DecodeReplica:
    """One token-level model server: a fixed-slot decode batch over the
    cached step, re-packed every iteration.

    Each loop iteration, in order: (1) apply a pending weight swap
    (ITERATION BOUNDARY — live sessions' caches are untouched); (2) apply
    pending KV imports; (3) admit queued sessions into free slots,
    reserving their FULL KV span up front; (4) run one prefill chunk (the
    scheduler's WFQ pick, under the interleave budget) or one decode step
    over every live slot.

    ``role="prefill"`` replicas stop at the first token: they emit it,
    export the session's cache, and hand the session to
    ``on_handoff(sess, host_kv)``.

    ``devices`` (more than one) shards the replica's KV pool over them
    (:class:`~edl_tpu_torch.runtime.kvcache.KVBlockPool`); the weights and
    the step's other work stay on the first."""

    def __init__(self, name: str, params: Any, cfg, *, job: str = "job",
                 role: str = "decode", slots: int = 4,
                 prefill_chunk: int = 16, kv_blocks: int = 64,
                 kv_block_size: int = 16, max_blocks_per_session: int = 8,
                 eos_id: Optional[int] = None,
                 scheduler: Optional[TokenScheduler] = None,
                 ttft_slo_ms: float = 0.0, tpot_slo_ms: float = 0.0,
                 spec_tokens: int = 0, spec_ngram: int = 3,
                 device="cuda", devices=None,
                 kv_quantize: Optional[str] = None,
                 on_handoff: Optional[Callable] = None,
                 on_session_done: Optional[Callable] = None) -> None:
        self.name = name
        self.cfg = cfg
        self.job = job
        self.role = role
        self.slots = max(int(slots), 1)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.eos_id = eos_id
        self.ttft_slo_ms = float(ttft_slo_ms)
        self.tpot_slo_ms = float(tpot_slo_ms)
        #: tokens fed per speculative verify step (1 real + K-1 drafts);
        #: < 2 means single-token decode
        self.spec_tokens = int(spec_tokens)
        self.spec_ngram = max(int(spec_ngram), 1)
        self.spec_drafted = 0
        self.spec_accepted = 0
        #: EWMA of tokens emitted per verify step (accepted drafts + the
        #: guaranteed real token)
        self.spec_accept_ewma: Optional[float] = None
        self.sched = scheduler or TokenScheduler()
        self.on_handoff = on_handoff
        self.on_session_done = on_session_done
        self.pool = KVBlockPool(cfg, kv_blocks, kv_block_size,
                                max_blocks_per_session, job=job,
                                replica=name, device=device,
                                devices=devices, quantize=kv_quantize)
        self.params = llama.as_decode_params(params, self.pool.device)
        self.state = BUILDING
        self.generation = 0
        self.iterations = 0
        self.decode_iterations = 0
        self.prefill_chunks = 0
        self.tokens_emitted = 0
        self._slots: list[Optional[DecodeSession]] = [None] * self.slots
        self._queue: "collections.deque[DecodeSession]" = collections.deque()
        #: (sid, blocks, payload) scatters awaiting this loop's next
        #: iteration boundary — the loop owns all cache mutation
        self._pending_imports: "collections.deque[tuple]" = \
            collections.deque()
        self._cond = threading.Condition()
        self._pending_weights: Optional[tuple[Any, int]] = None
        self._swap_applied = threading.Event()
        self._built = threading.Event()
        self._quiesced = threading.Event()
        self._resume = threading.Event()
        self._quiesce_req = False
        self._thread: Optional[threading.Thread] = None
        self._ttft = _ttft_hist()
        self._tpot = _tpot_hist()
        self._counters = get_counters()
        # zero-pre-registration: every per-class series exists from the
        # first scrape
        for pri in PRI_NAMES.values():
            self._ttft.touch(job=job, priority=pri)
            self._tpot.touch(job=job, priority=pri)
            self._counters.inc("serving_ttft_slo_violations", 0, job=job,
                               priority=pri)
            self._counters.inc("serving_tpot_slo_violations", 0, job=job,
                               priority=pri)
        self._counters.inc("serving_decode_tokens", 0, job=job)
        self._counters.inc("serving_prefill_chunks", 0, job=job)
        self._counters.inc("decode_spec_steps", 0, job=job)
        self._spec_hist = get_registry().histogram(
            "decode_spec_accepted_per_step",
            help="draft tokens accepted per speculative verify step",
            buckets=[0, 1, 2, 3, 4, 6, 8, 12, 16])
        for pri in PRI_NAMES.values():
            self._counters.inc("decode_spec_drafted", 0, job=job,
                               priority=pri)
            self._counters.inc("decode_spec_accepted", 0, job=job,
                               priority=pri)
            if self.spec_tokens >= 2:
                self._spec_hist.touch(job=job, priority=pri)
        for outcome in ("done", "failed", "migrated", "handed_off"):
            self._counters.inc("serving_sessions", 0, job=job,
                               outcome=outcome)
        get_registry().gauge_fn(
            "serving_sessions_active", self.sessions_active,
            help="sessions resident (slots + admission queue)",
            job=job, replica=name)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "DecodeReplica":
        self._thread = threading.Thread(target=self._run,
                                        name=f"decode-{self.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def wait_ready(self, timeout_s: float = 120.0) -> bool:
        return self._built.wait(timeout_s) and self.state != STOPPED

    def _run(self) -> None:
        t0 = time.perf_counter()
        try:
            self._warmup()
        except Exception as exc:
            log.error("decode replica build failed", replica=self.name,
                      error=str(exc)[:200])
            self.state = STOPPED
            self._built.set()
            self._fail_all(exc)
            return
        with self._cond:
            if self.state == BUILDING:
                self.state = READY
        self._built.set()
        build_ms = round((time.perf_counter() - t0) * 1000, 1)
        get_tracer().instant("decode_replica_ready", category="serving",
                             replica=self.name, role=self.role,
                             build_ms=build_ms)
        log.info("decode replica ready", replica=self.name, role=self.role,
                 build_ms=build_ms)
        self._loop()

    def _warmup(self) -> None:
        """Run each fixed-shape entry point (decode batch, verify batch
        when speculating, prefill chunk) once on a scratch cache of the
        pool's storage mode, so the ready gate opens with every kernel
        loaded; the pool's own cache stays zeroed."""
        maxb = self.pool.max_blocks_per_session
        nb = self.pool.num_blocks
        scratch = llama.init_cache(self.cfg, nb, self.pool.block_size,
                                   quantize=self.pool.quantize,
                                   devices=self.pool.devices)
        dead = np.full((self.slots, maxb), nb, np.int32)
        zeros = np.zeros(self.slots, np.int64)
        logits, _ = llama.decode_step(self.params, scratch, zeros, zeros,
                                      dead, zeros.astype(bool))
        logits.argmax(dim=-1).tolist()
        if self.spec_tokens >= 2:
            logits, _ = llama.verify_step(
                self.params, scratch,
                np.zeros((self.slots, self.spec_tokens), np.int64),
                zeros, zeros, dead)
            logits.argmax(dim=-1).tolist()
        logits, _ = llama.prefill(self.params, scratch,
                                  np.zeros(self.prefill_chunk, np.int64),
                                  dead[0], 0, 0)
        logits.argmax(dim=-1).tolist()

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> bool:
        """``drain=True`` finishes every resident session first;
        ``drain=False`` fails them typed (:class:`SessionDropped`) unless a
        fleet rescues them first."""
        with self._cond:
            self.state = DRAINING if drain else STOPPED
            self._resume.set()  # a quiesced loop must wake to exit
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout_s)
        with self._cond:
            self.state = STOPPED
            self._cond.notify_all()
        self._fail_all(SessionDropped(f"decode replica {self.name} stopped"))
        return t is None or not t.is_alive()

    def _fail_all(self, exc: BaseException) -> None:
        victims: list[DecodeSession] = []
        with self._cond:
            while self._queue:
                victims.append(self._queue.popleft())
            for i, sess in enumerate(self._slots):
                if sess is not None:
                    victims.append(sess)
                    self._slots[i] = None
        for sess in victims:
            self.pool.free_session(sess.id)
            self._counters.inc("serving_sessions", job=self.job,
                               outcome="failed")
            sess.fail(exc)
            if self.on_session_done is not None:
                self.on_session_done(sess)

    # -- admission -----------------------------------------------------------

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """Would this session's FULL KV reservation fit the pool now,
        counting what is queued ahead of it?  A queued session that
        already holds blocks (imported with its cache) counts only for the
        blocks it still lacks."""
        with self._cond:
            queued = sum(
                max(self.pool._blocks_for(s.span_tokens())
                    - self.pool.blocks_held(s.id), 0)
                for s in self._queue)
        need = self.pool._blocks_for(int(prompt_len) + int(max_new))
        return (need + queued <= self.pool.blocks_free()
                and need <= self.pool.max_blocks_per_session)

    def submit(self, sess: DecodeSession) -> None:
        # an id past the embedding table would fire a device-side assert
        # that ends every replica on the card (JAX clamps it silently)
        if not all(0 <= t < self.cfg.vocab_size for t in sess.prompt):
            raise ValueError(f"session {sess.id}: a prompt token lies "
                             f"outside the vocabulary of "
                             f"{self.cfg.vocab_size}")
        with self._cond:
            if self.state == STOPPED:
                raise SessionDropped(f"replica {self.name} is stopped")
            sess.replica = self.name
            self._queue.append(sess)
            self._cond.notify_all()

    def sessions_active(self) -> int:
        with self._cond:
            return (len(self._queue)
                    + sum(1 for s in self._slots if s is not None))

    def sessions_resident(self) -> list[DecodeSession]:
        with self._cond:
            return ([s for s in self._slots if s is not None]
                    + list(self._queue))

    def routable(self) -> bool:
        return self.state == READY

    # -- weight swaps (iteration-boundary, cache-preserving) -----------------

    def swap_weights(self, params: Any, generation: int,
                     timeout_s: float = 30.0) -> bool:
        """Hand the loop new weights, applied at its next ITERATION
        boundary.  Live sessions keep their KV caches across the swap and
        decode their next token on the new weights."""
        params = llama.as_decode_params(params, self.pool.device)
        self._swap_applied.clear()
        with self._cond:
            if self.state == STOPPED:
                return False
            self._pending_weights = (params, generation)
            self._cond.notify_all()
        return self._swap_applied.wait(timeout_s)

    def _maybe_swap(self) -> None:
        with self._cond:
            pending, self._pending_weights = self._pending_weights, None
        if pending is None:
            return
        self.params, self.generation = pending
        self._swap_applied.set()
        self._counters.inc("serving_reloads", job=self.job)
        get_tracer().instant(
            "decode_weights_reloaded", category="serving",
            replica=self.name, generation=self.generation,
            live_sessions=self.sessions_active())

    # -- quiesce / evacuate (the resize + handoff machinery) -----------------

    def quiesce(self, timeout_s: float = 30.0) -> bool:
        """Park the loop at the next iteration boundary.  While parked the
        caller owns the replica's state (exports, imports), then
        :meth:`resume` (or a stop) releases it.  A loop parked already
        stays parked and the call returns at once: the loop waits for a
        resume, not for another request, so asking again would only wait
        out ``timeout_s``."""
        with self._cond:
            if self.state == STOPPED:
                return False
            if self._quiesce_req and self._quiesced.is_set():
                return True
            self._quiesced.clear()
            self._resume.clear()
            self._quiesce_req = True
            self._cond.notify_all()
        return self._quiesced.wait(timeout_s)

    def resume(self) -> None:
        with self._cond:
            self._quiesce_req = False
            self._resume.set()
            self._cond.notify_all()

    def _drain_imports(self) -> None:
        """Apply deferred KV scatters, host and device payloads alike: on
        the loop thread at an iteration boundary, or on a controller
        thread while the loop is provably parked."""
        while True:
            with self._cond:
                if not self._pending_imports:
                    return
                sid, blocks, kv = self._pending_imports.popleft()
            if sid not in self.pool.sessions():
                continue  # freed (failed/stopped) before the scatter
            if isinstance(kv, KVDevicePayload):
                self.pool.apply_import_device(sid, blocks, kv)
            else:
                llama.scatter_session_kv(self.pool.cache, blocks, kv,
                                         self.pool.block_size)

    def export_all(self, device: bool = False
                   ) -> list[tuple[DecodeSession, Optional[Any]]]:
        """Evacuate every resident session (call quiesced): ``(session,
        payload or None)`` — None for sessions still queued with no cache.
        ``device=True`` gives :class:`KVDevicePayload` device copies, else
        host tensors.  Slots and blocks are freed here."""
        self._drain_imports()  # the loop is parked; adopt stragglers first
        out: list[tuple[DecodeSession, Optional[Any]]] = []
        with self._cond:
            resident = [s for s in self._slots if s is not None]
            queued = list(self._queue)
            self._queue.clear()
            self._slots = [None] * self.slots
        for sess in resident:
            kv = None
            if sess.cached > 0:
                kv = (self.pool.export_session_device(sess.id, sess.cached)
                      if device
                      else self.pool.export_session(sess.id, sess.cached))
            self.pool.free_session(sess.id)
            sess.slot = None
            out.append((sess, kv))
        for sess in queued:
            self.pool.free_session(sess.id)
            out.append((sess, None))
        return out

    def _adopt(self, sess: DecodeSession, cached: Optional[int],
               blocks: Optional[list], payload: Any) -> None:
        """Queue an imported session, its scatter deferred to the loop's
        next iteration boundary (``cached`` None: no cache, re-prefill)."""
        if cached is not None:
            sess.cached = cached
            # a prompt-only cache still feeds generated[-1]; a cache caught
            # mid-prefill resumes prefill at ``cached``
            sess.state = (S_DECODING if sess.generated
                          and cached >= len(sess.resume_tokens())
                          else S_PREFILL)
        else:
            sess.cached = 0
            sess.state = S_QUEUED
        sess.replica = self.name
        sess.slot = None
        sess.migrations += 1
        with self._cond:
            if self.state == STOPPED:
                self.pool.free_session(sess.id)
                raise SessionDropped(
                    f"replica {self.name} stopped mid-import")
            if payload is not None:
                self._pending_imports.append((sess.id, blocks, payload))
            self._queue.append(sess)
            self._cond.notify_all()
        self._counters.inc("serving_session_migrations", job=self.job)

    def import_session(self, sess: DecodeSession,
                       host_kv: Optional[dict]) -> None:
        """Adopt a session (call quiesced, or before start): with
        ``host_kv`` its cache lands in this pool and it resumes where it
        left off; without, it re-enters prefill over its known history.
        The FULL span is reserved now (a typed, retriable
        :class:`KVPoolExhausted`); the scatter waits for the loop."""
        blocks = None
        if host_kv is not None:
            try:
                blocks = self.pool.ensure_capacity(sess.id,
                                                   sess.span_tokens())
            except KVPoolExhausted:
                self.pool.free_session(sess.id)
                raise
        self._adopt(sess, None if host_kv is None
                    else int(host_kv["k"].shape[1]), blocks, host_kv)

    def import_session_device(self, sess: DecodeSession,
                              payload: KVDevicePayload) -> None:
        """Adopt a D2D-evacuated session: its blocks are reserved (plus the
        rest of the full span) and placed on this device now; the scatter
        waits for the loop.  Raises typed (:class:`KVPoolExhausted`, or
        ``ValueError`` on a storage-mode mismatch) with nothing held."""
        blocks = self.pool.reserve_import_device(sess.id, payload)
        try:
            self.pool.ensure_capacity(sess.id, sess.span_tokens())
        except KVPoolExhausted:
            self.pool.free_session(sess.id)
            raise
        self._adopt(sess, payload.length, blocks, payload)

    # -- the iteration loop --------------------------------------------------

    def _admit_locked(self) -> list[DecodeSession]:
        """Move queued sessions into free slots, reserving full KV spans.
        A session whose span cannot fit stays queued; one whose span can
        NEVER fit leaves the queue and is returned, for :meth:`_refuse`
        once the lock is released.  A session whose imported cache has a
        scatter pending is not admitted until the drain applies it."""
        pending = {sid for sid, _, _ in self._pending_imports}
        refused = []
        for i in range(self.slots):
            if self._slots[i] is not None:
                continue
            sess = next((s for s in self._queue if s.id not in pending),
                        None)
            if sess is None:
                break  # nothing admissible until the next drain
            total = sess.span_tokens()
            if (self.pool._blocks_for(total)
                    > self.pool.max_blocks_per_session):
                self._queue.remove(sess)
                refused.append(sess)
                continue
            try:
                if (sess.cached == 0 and not sess.generated
                        and not self.pool.blocks_held(sess.id)):
                    # fresh prompt: adopt sealed prefix-cache blocks
                    _, covered = self.pool.admit_with_prefix(
                        sess.id, sess.prompt, total)
                    sess.cached = covered
                else:
                    self.pool.ensure_capacity(sess.id, total)
            except KVPoolExhausted:
                break  # pool full now; head of line retries next iteration
            self._queue.remove(sess)
            sess.slot = i
            if sess.state in (S_QUEUED, S_PREFILL):
                sess.state = S_PREFILL
                self.sched.stamp(sess)
            self._slots[i] = sess
        return refused

    def _refuse(self, sess: DecodeSession) -> None:
        """Fail a session whose span can never fit, typed, through the
        fleet's accounting (not under the replica's lock: the fleet's
        callback takes its own)."""
        self.pool.free_session(sess.id)
        self._counters.inc("serving_sessions", job=self.job,
                           outcome="failed")
        sess.fail(KVPoolExhausted(
            f"session {sess.id}: {sess.span_tokens()} tokens exceed the "
            f"per-session KV cap"))
        if self.on_session_done is not None:
            self.on_session_done(sess)

    def _park_for_work(self) -> bool:
        """Wait until there is something to do (or quiesce/stop).  Returns
        False when the loop must exit."""
        with self._cond:
            while True:
                if self.state == STOPPED:
                    return False
                if self._quiesce_req:
                    self._quiesced.set()
                    self._cond.release()
                    try:
                        self._resume.wait()
                    finally:
                        self._cond.acquire()
                    continue
                have_work = (self._queue or self._pending_imports
                             or any(s is not None for s in self._slots)
                             or self._pending_weights is not None)
                if self.state == DRAINING and not have_work:
                    return False
                if have_work:
                    return True
                self._cond.wait(0.05)

    def _loop(self) -> None:
        while True:
            if not self._park_for_work():
                return
            self._maybe_swap()
            self._drain_imports()
            with self._cond:
                refused = self._admit_locked()
                prefilling = [s for s in self._slots
                              if s is not None and s.state == S_PREFILL]
                decoding = [s for s in self._slots
                            if s is not None and s.state == S_DECODING]
            for sess in refused:
                self._refuse(sess)
            if not prefilling and not decoding:
                # queued sessions could not admit (pool full): park briefly
                time.sleep(0.001)
                continue
            self.iterations += 1
            try:
                if self.sched.allow_prefill(len(decoding), len(prefilling)):
                    sess = self.sched.pick_prefill(prefilling)
                    pred_ms = self.sched.predicted_prefill_ms()
                    t0 = time.perf_counter()
                    self._prefill_one(sess)
                    ms = (time.perf_counter() - t0) * 1e3
                    self.sched.note_prefill(ms)
                    if pred_ms is not None:
                        calib.record("interleave_prefill_ms", pred_ms, ms,
                                     unit="ms", job=self.job)
                else:
                    pred_ms = self.sched.predicted_decode_ms()
                    t0 = time.perf_counter()
                    if self.spec_tokens >= 2:
                        self._decode_all_spec(decoding)
                    else:
                        self._decode_all(decoding)
                    ms = (time.perf_counter() - t0) * 1e3
                    self.sched.note_decode(ms)
                    if pred_ms is not None:
                        calib.record("interleave_decode_ms", pred_ms, ms,
                                     unit="ms", job=self.job)
            except Exception as exc:
                log.error("decode iteration failed", replica=self.name,
                          error=str(exc)[:200])
                self._fail_all(exc)
                with self._cond:
                    self.state = STOPPED
                return

    def _prefill_one(self, sess: DecodeSession) -> None:
        """Advance one session's prefill by one fixed-size chunk; on the
        final chunk, emit the first token (unless this re-prefills
        already-emitted history) and transition."""
        tokens = sess.resume_tokens()
        start = sess.cached
        n = min(len(tokens) - start, self.prefill_chunk)
        chunk = np.zeros(self.prefill_chunk, np.int64)
        chunk[:n] = tokens[start:start + n]
        logits, _ = llama.prefill(self.params, self.pool.cache, chunk,
                                  self.pool.block_table(sess.id), start, n)
        sess.cached = start + n
        self.prefill_chunks += 1
        self._counters.inc("serving_prefill_chunks", job=self.job)
        if sess.cached < len(tokens):
            return  # more chunks to go; the scheduler re-picks
        # the prompt's K/V is final (decode writes land past it): seal its
        # full blocks so later sessions sharing the prompt admit without
        # re-prefill
        self.pool.register_prefix(sess.id, sess.prompt)
        pri = PRI_NAMES.get(sess.priority, "normal")
        if not sess.generated:
            # fresh prompt: the final row's logits seed generation
            sess.emit(int(logits[n - 1].argmax()))
            self.tokens_emitted += 1
            self._counters.inc("serving_decode_tokens", job=self.job)
            self._ttft.observe(sess.ttft_s, job=self.job, priority=pri)
            if self.ttft_slo_ms and sess.ttft_s * 1e3 > self.ttft_slo_ms:
                self._counters.inc("serving_ttft_slo_violations",
                                   job=self.job, priority=pri)
            if self._check_finished(sess):
                return
        sess.state = S_DECODING
        if self.role == "prefill" and self.on_handoff is not None:
            self._handoff(sess)

    def _handoff(self, sess: DecodeSession) -> None:
        """Disaggregation's seam: export the prefilled cache, free the
        slot, hand the session to the fleet's decode tier."""
        kv = self.pool.export_session(sess.id, sess.cached)
        with self._cond:
            if sess.slot is not None:
                self._slots[sess.slot] = None
            sess.slot = None
        self.pool.free_session(sess.id)
        self._counters.inc("serving_sessions", job=self.job,
                           outcome="handed_off")
        self.on_handoff(sess, kv)

    def _slot_tables(self) -> np.ndarray:
        return np.full((self.slots, self.pool.max_blocks_per_session),
                       self.pool.num_blocks, np.int32)

    def _emit_decoded(self, sess: DecodeSession, tok: int, pri: str) -> bool:
        """Emit one decoded token with its TPOT accounting; True when the
        session finished."""
        prev_emit = sess.t_last_token
        sess.emit(tok)
        self.tokens_emitted += 1
        self._counters.inc("serving_decode_tokens", job=self.job)
        itt = max(sess.t_last_token - prev_emit, 0.0)
        self._tpot.observe(itt, job=self.job, priority=pri)
        if self.tpot_slo_ms and itt * 1e3 > self.tpot_slo_ms:
            self._counters.inc("serving_tpot_slo_violations", job=self.job,
                               priority=pri)
        return self._check_finished(sess)

    def _decode_all(self, decoding: list[DecodeSession]) -> None:
        S = self.slots
        toks = np.zeros(S, np.int64)
        poss = np.zeros(S, np.int64)
        live = np.zeros(S, bool)
        tables = self._slot_tables()
        for sess in decoding:
            i = sess.slot
            toks[i] = sess.generated[-1]
            poss[i] = sess.cached
            live[i] = True
            tables[i] = self.pool.block_table(sess.id)
        logits, _ = llama.decode_step(self.params, self.pool.cache, toks,
                                      poss, tables, live)
        nxt = logits.argmax(dim=-1).tolist()  # the iteration's one read
        self.decode_iterations += 1
        for sess in decoding:
            tok = nxt[sess.slot]
            sess.cached += 1
            self._emit_decoded(sess, tok,
                               PRI_NAMES.get(sess.priority, "normal"))

    def _draft(self, sess: DecodeSession, k: int) -> list[int]:
        """Self-drafting by prompt lookup: the tokens that followed the
        prior occurrence of the context's trailing ``spec_ngram``-gram with
        the longest continuation (up to ``k``); no match, no drafts."""
        if k <= 0:
            return []
        ctx = sess.prompt + sess.generated
        g = min(self.spec_ngram, len(ctx) - 1)
        if g < 1:
            return []
        tail = ctx[-g:]
        best: list[int] = []
        for i in range(len(ctx) - g - 1, -1, -1):
            if ctx[i:i + g] == tail:
                cand = [int(t) for t in ctx[i + g:i + g + k]]
                if len(cand) > len(best):
                    best = cand
                if len(best) == k:
                    break
        return best

    def _decode_all_spec(self, decoding: list[DecodeSession]) -> None:
        """One speculative iteration: each slot feeds its real next token
        plus up to ``spec_tokens - 1`` drafts through one verify step and
        accepts by the strict greedy rule — draft ``d_{j+1}`` stands iff it
        equals the argmax after consuming everything before it — so the
        emitted tokens are those of single-token greedy decode.  A rejected
        row's K/V lies past the accepted frontier and is overwritten
        before any query reaches it."""
        K = self.spec_tokens
        S = self.slots
        toks = np.zeros((S, K), np.int64)
        poss = np.zeros(S, np.int64)
        nts = np.zeros(S, np.int64)
        tables = self._slot_tables()
        feeds: dict[int, list[int]] = {}
        for sess in decoding:
            i = sess.slot
            remaining = max(sess.max_new_tokens - len(sess.generated), 1)
            limit = min(K, remaining)
            feed = ([sess.generated[-1]]
                    + self._draft(sess, limit - 1))[:limit]
            feeds[sess.id] = feed
            toks[i, :len(feed)] = feed
            poss[i] = sess.cached
            nts[i] = len(feed)
            tables[i] = self.pool.block_table(sess.id)
        logits, _ = llama.verify_step(self.params, self.pool.cache, toks,
                                      poss, nts, tables)
        best = logits.argmax(dim=-1).tolist()  # [S][K]: the one read
        self.decode_iterations += 1
        self._counters.inc("decode_spec_steps", job=self.job)
        step_emitted = 0
        for sess in decoding:
            feed = feeds[sess.id]
            n = len(feed)
            outs = best[sess.slot]
            emitted = [outs[0]]
            while len(emitted) < n and feed[len(emitted)] == emitted[-1]:
                emitted.append(outs[len(emitted)])
            accepted = len(emitted) - 1  # drafts that survived
            pri = PRI_NAMES.get(sess.priority, "normal")
            self._counters.inc("decode_spec_drafted", n - 1, job=self.job,
                               priority=pri)
            self._counters.inc("decode_spec_accepted", accepted,
                               job=self.job, priority=pri)
            self._spec_hist.observe(accepted, job=self.job, priority=pri)
            self.spec_drafted += n - 1
            self.spec_accepted += accepted
            step_emitted += accepted + 1
            # the valid K/V frontier: feed[0..accepted] are real history
            sess.cached += accepted + 1
            for tok in emitted:
                if self._emit_decoded(sess, tok, pri):
                    break  # EOS/max_new truncates the accepted tail
        realized = step_emitted / max(len(decoding), 1)
        if self.spec_accept_ewma is not None:
            calib.record("spec_accept", self.spec_accept_ewma, realized,
                         unit="tokens/step", job=self.job)
        self.spec_accept_ewma = (realized if self.spec_accept_ewma is None
                                 else 0.2 * realized
                                 + 0.8 * self.spec_accept_ewma)

    def _check_finished(self, sess: DecodeSession) -> bool:
        """A finished sequence frees its slot and blocks at once."""
        hit_eos = (self.eos_id is not None and sess.generated
                   and sess.generated[-1] == self.eos_id)
        if len(sess.generated) < sess.max_new_tokens and not hit_eos:
            return False
        with self._cond:
            if sess.slot is not None:
                self._slots[sess.slot] = None
            sess.slot = None
            self._cond.notify_all()
        self.pool.free_session(sess.id)
        sess.finish()
        self._counters.inc("serving_sessions", job=self.job, outcome="done")
        if self.on_session_done is not None:
            self.on_session_done(sess)
        return True


class DecodeFleet:
    """The autoregressive replica set on one device: role-aware routing
    (prefill tier → decode tier handoff when disaggregated), session
    affinity, elastic scale with LIVE KV evacuation (a resize drops no
    session), rolling cache-preserving weight reloads, and rescue on
    replica death (sessions re-prefill their known history elsewhere, or
    fail TYPED, never hang).

    ``params`` is a :class:`~edl_tpu_torch.models.transformer.Transformer`
    (or :class:`~edl_tpu_torch.models.llama.DecodeParams`) of ``cfg``;
    ``roles`` maps role → replica count, e.g. ``{"decode": 2}`` or
    ``{"prefill": 1, "decode": 2}``; ``params`` may also be the weights
    nested as a checkpoint holds them (:func:`~edl_tpu_torch.models.llama.
    param_tree`).  Every replica runs on ``device``: the JAX package's own
    wrap-around when a host has fewer devices than replicas.
    ``devices_per_replica`` d > 0 shards each replica's KV pool over d
    devices: replica ``idx`` takes the cards ``(idx·d + j) mod count`` of
    ``device``'s kind, wrapping as the JAX package's slices do (on one card,
    d shards on it).  ``kv`` is a
    coordinator (a :class:`~edl_tpu_torch.coord.client.CoordClient`, or
    any store with ``kv_set``/``kv_get``): each rolling reload publishes
    the generation under ``serving-gen/<job>``, and the lineage watcher
    long-polls that key (:meth:`watch_lineage`)."""

    def __init__(self, params: Any, cfg, *, job: str = "job",
                 roles: Optional[dict] = None, slots: int = 4,
                 prefill_chunk: int = 16, kv_blocks: int = 64,
                 kv_block_size: int = 16, max_blocks_per_session: int = 8,
                 eos_id: Optional[int] = None,
                 ttft_slo_ms: float = 0.0, tpot_slo_ms: float = 0.0,
                 wfq_weights: Optional[dict] = None,
                 decode_per_prefill: int = 2, tpot_budget_ms: float = 0.0,
                 spec_tokens: int = 0, spec_ngram: int = 3,
                 kv_quantize: Optional[str] = None,
                 max_queued_sessions: int = 64, window: int = 4096,
                 device="cuda", devices_per_replica: int = 0,
                 kv=None) -> None:
        self._gen_params = llama.as_decode_params(params, device, cfg)
        if self._gen_params.cfg != cfg:
            raise ValueError("params were built for another config")
        self.cfg = cfg
        self.device = self._gen_params.device
        self.job = job
        self.roles = dict(roles or {"decode": 1})
        if self.roles.get("decode", 0) < 1:
            raise ValueError("DecodeFleet needs >=1 decode replica")
        self._rep_kw = dict(
            slots=slots, prefill_chunk=prefill_chunk, kv_blocks=kv_blocks,
            kv_block_size=kv_block_size,
            max_blocks_per_session=max_blocks_per_session, eos_id=eos_id,
            ttft_slo_ms=ttft_slo_ms, tpot_slo_ms=tpot_slo_ms,
            spec_tokens=spec_tokens, spec_ngram=spec_ngram,
            kv_quantize=kv_quantize)
        self.devices_per_replica = int(devices_per_replica)
        self._wfq_weights = dict(wfq_weights) if wfq_weights else None
        self._decode_per_prefill = int(decode_per_prefill)
        self._tpot_budget_ms = float(tpot_budget_ms)
        self.max_queued_sessions = int(max_queued_sessions)
        self._kv = kv
        self.generation = 0
        #: the lineage watcher of :meth:`watch_lineage`, stopped by stop()
        self._watcher: Optional[_WeightWatcher] = None
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self._replicas: list[DecodeReplica] = []
        self._rep_seq = itertools.count()
        self.sessions_submitted = 0
        self.sessions_completed = 0
        self.sessions_failed = 0
        self.migrations = 0
        #: migration bytes across every evacuation: D2D payload bytes vs
        #: what the host roundtrip for the same sessions would have moved
        self.migration_bytes_d2d = 0
        self.migration_bytes_host = 0
        self.migration_bytes_host_roundtrip_baseline = 0
        self._counters = get_counters()
        #: rolling TTFT / inter-token completions for windowed stats
        self._ttft_window: "collections.deque[tuple[float, float, int]]" \
            = collections.deque(maxlen=max(int(window), 16))
        self._tok_window: "collections.deque[float]" = collections.deque(
            maxlen=max(int(window), 16))
        self._tok_mark: Optional[tuple[float, int]] = None
        get_registry().gauge_fn(
            "serving_chips", self.chips,
            help="accelerator chips backing this decode fleet", job=job)
        for role, n in self.roles.items():
            for _ in range(n):
                self._replicas.append(self._new_replica(role))
        for r in self._replicas:
            r.wait_ready()

    # -- replica construction ------------------------------------------------

    def _replica_devices(self, idx: int) -> Optional[list]:
        """The d devices replica ``idx`` shards its pool over (None when
        each replica is one device): cyclic slices of the cards, wrapping
        when the host has fewer than replicas × d."""
        d = self.devices_per_replica
        if d <= 0:
            return None
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if self.device.type == "cuda" else [self.device])
        return [devs[(idx * d + j) % len(devs)] for j in range(d)]

    def _new_replica(self, role: str) -> DecodeReplica:
        idx = next(self._rep_seq)
        devices = self._replica_devices(idx)
        r = DecodeReplica(
            f"{self.job}/{role[0]}{idx}", self._gen_params, self.cfg,
            job=self.job, role=role,
            device=devices[0] if devices else self.device, devices=devices,
            scheduler=TokenScheduler(self._wfq_weights,
                                     self._decode_per_prefill,
                                     tpot_budget_ms=self._tpot_budget_ms),
            on_handoff=self._adopt_handoff if role == "prefill" else None,
            on_session_done=self._record_done, **self._rep_kw)
        r.generation = self.generation
        return r.start()

    def _role_replicas(self, role: str) -> list[DecodeReplica]:
        with self._lock:
            return [r for r in self._replicas
                    if r.role == role and r.state != STOPPED]

    # -- routing / admission -------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               priority: int = PRI_NORMAL, trace_id: Optional[str] = None,
               on_done: Optional[Callable] = None,
               on_token: Optional[Callable] = None) -> DecodeSession:
        """Admit one session.  Bounded: when no target replica can hold its
        full KV span and the lightest queue is at the cap, raises
        :class:`KVPoolExhausted`.  Callbacks are wired here, before a fast
        session can complete."""
        sess = DecodeSession(prompt, max_new_tokens, priority=priority,
                             id=next(self._ids), trace_id=trace_id)
        sess.on_done = on_done
        sess.on_token = on_token
        # a session that can NEVER fit rejects at the door
        bs = self._rep_kw["kv_block_size"]
        need = -(-sess.span_tokens() // bs)
        if need > self._rep_kw["max_blocks_per_session"]:
            self._counters.inc("serving_kv_admission_rejects", job=self.job)
            raise KVPoolExhausted(
                f"session needs {need} blocks, per-session cap is "
                f"{self._rep_kw['max_blocks_per_session']}")
        for _attempt in range(3):
            tier = (self._role_replicas("prefill")
                    or self._role_replicas("decode"))
            ready = [r for r in tier if r.routable()] or tier
            if not ready:
                raise SessionDropped(f"fleet {self.job} has no replicas")
            fits = [r for r in ready
                    if r.can_admit(len(sess.prompt), sess.max_new_tokens)]
            if not fits:
                lightest = min(ready, key=lambda r: r.sessions_active())
                if lightest.sessions_active() >= self.max_queued_sessions:
                    self._counters.inc("serving_kv_admission_rejects",
                                       job=self.job)
                    raise KVPoolExhausted(
                        f"fleet {self.job}: no replica can admit "
                        f"{len(sess.prompt)}+{sess.max_new_tokens} tokens")
                fits = [lightest]  # queue it; blocks free as sessions end
            target = min(fits, key=lambda r: r.sessions_active())
            try:
                target.submit(sess)
            except SessionDropped:
                # the replica stopped between the pick and the enqueue (a
                # scale-down racing admission): re-route
                continue
            self.sessions_submitted += 1
            return sess
        raise SessionDropped(
            f"fleet {self.job}: no stable replica accepted the session")

    def _adopt_handoff(self, sess: DecodeSession, host_kv: dict) -> None:
        """A prefill replica finished a prompt: land the cache on the
        decode tier (runs on the prefill replica's loop thread; the
        import's scatter waits for the decode loop)."""
        decode_tier = [r for r in self._role_replicas("decode")
                       if r.routable()]
        decode_tier.sort(key=lambda r: r.sessions_active())
        for r in decode_tier:
            try:
                r.import_session(sess, host_kv)
                self.migrations += 1
                return
            except KVPoolExhausted:
                continue
        # no decode capacity: re-prefill wherever admission frees first
        if decode_tier:
            decode_tier[0].import_session(sess, None)
            self.migrations += 1
            return
        sess.fail(SessionDropped(
            f"fleet {self.job}: no decode tier for handoff"))

    def _record_done(self, sess: DecodeSession) -> None:
        with self._lock:
            if sess.error is None:
                self.sessions_completed += 1
                self._ttft_window.append(
                    (sess.t_done, sess.ttft_s, sess.priority))
                if sess.tpot_s > 0:
                    self._tok_window.append(sess.tpot_s)
            else:
                self.sessions_failed += 1

    # -- elastic scale with live KV evacuation -------------------------------

    def scale_to(self, target: int, wait_ready_s: float = 120.0) -> int:
        """Resize the DECODE tier.  Growing builds (and warms) new replicas
        behind the ready gate.  Shrinking quiesces each victim at an
        iteration boundary and evacuates its whole session set onto the
        survivors — cache intact where it fits, re-prefill where it does
        not — and drops no session."""
        target = max(int(target), 1)
        grown: list[DecodeReplica] = []
        victims: list[DecodeReplica] = []
        with self._lock:
            decode = [r for r in self._replicas
                      if r.role == "decode" and r.state != STOPPED]
            while len(decode) + len(grown) < target:
                grown.append(self._new_replica("decode"))
            n_victims = len(decode) - target
            if n_victims > 0:
                victims = decode[-n_victims:]
                # off the routable set BEFORE evacuation, so a racing
                # submit is not routed at a leaving replica
                for v in victims:
                    with v._cond:
                        if v.state == READY:
                            v.state = DRAINING
            self._replicas.extend(grown)
        for r in grown:
            r.wait_ready(wait_ready_s)
            if self.generation and r.state != STOPPED:
                r.swap_weights(self._gen_params, self.generation)
        for victim in victims:
            self._evacuate(victim)
        with self._lock:
            for v in victims:
                if v in self._replicas:
                    self._replicas.remove(v)
            return len([r for r in self._replicas if r.role == "decode"])

    def _evacuate(self, victim: DecodeReplica) -> None:
        """Scale-down evacuation, D2D first: each session's blocked cache
        leaves the victim as a device payload and lands on a survivor
        (``kv_migration_bytes{path="ici"}``).  Fallbacks in order: the
        host roundtrip (a survivor with another storage mode or no room
        for the payload), cacheless re-prefill, and, with no survivor at
        all, a typed failure."""
        t0 = time.perf_counter()
        victim.quiesce()
        moved = victim.export_all(device=True)
        survivors = [r for r in self._role_replicas("decode")
                     if r is not victim and r.routable()]

        def _place(sess, payload):
            placed = via_d2d = via_host = False
            d2d_nbytes = trimmed = 0
            ranked = sorted(survivors, key=lambda r: r.sessions_active())
            if payload is not None:
                d2d_nbytes = payload.nbytes
                k = payload.shape
                # what the host path would ship for this session: the
                # trimmed dequantized f32 pair, off the device and back
                trimmed = (2 * int(k[0]) * int(payload.length)
                           * int(k[3]) * int(k[4]) * 4)
                for r in ranked:
                    try:
                        r.import_session_device(sess, payload)
                        placed = via_d2d = True
                        break
                    except (KVPoolExhausted, ValueError):
                        continue
                if not placed and survivors:
                    host_kv = payload_to_host(
                        payload, victim.pool.block_size, job=self.job)
                    for r in ranked:
                        try:
                            r.import_session(sess, host_kv)
                            placed = via_host = True
                            break
                        except KVPoolExhausted:
                            continue
            if not placed and survivors:
                # the cache fit nowhere: ship the session without it
                ranked[0].import_session(sess, None)
                placed = True
            if not placed:
                sess.fail(SessionDropped(
                    f"fleet {self.job}: scale-down with no survivor"))
                with self._lock:
                    self.sessions_failed += 1
                return
            with self._lock:
                self.migrations += 1
                if payload is not None:
                    self.migration_bytes_host_roundtrip_baseline += \
                        2 * trimmed
                    if via_d2d:
                        self.migration_bytes_d2d += d2d_nbytes
                    elif via_host:
                        self.migration_bytes_host += 2 * trimmed

        for sess, payload in moved:
            _place(sess, payload)
        # straggler sweep: a submit that passed routable() before the
        # DRAINING flip may have enqueued after export_all's snapshot
        n_moved = len(moved)
        while True:
            late = victim.export_all(device=True)
            if not late:
                break
            for sess, payload in late:
                _place(sess, payload)
            n_moved += len(late)
        victim.stop(drain=False)  # empty by construction
        evac_ms = round((time.perf_counter() - t0) * 1000, 1)
        get_tracer().instant("decode_fleet_evacuated", category="serving",
                             job=self.job, replica=victim.name,
                             sessions=n_moved, evac_ms=evac_ms)
        log.info("decode replica evacuated", replica=victim.name,
                 sessions=n_moved, evac_ms=evac_ms)

    def kill_replica(self, name: str) -> int:
        """The SIGKILL drill: the replica vanishes WITHOUT evacuation (its
        cache is gone).  Resident sessions re-prefill their known history
        on survivors — greedy decode makes the continuation token-equal —
        or fail typed when none is left.  Returns sessions rescued."""
        with self._lock:
            victim = next((r for r in self._replicas if r.name == name),
                          None)
            if victim is None:
                raise KeyError(name)
            self._replicas.remove(victim)
        resident = victim.sessions_resident()
        # sever: the dead replica's loop must not race the rescue
        with victim._cond:
            victim._queue.clear()
            victim._slots = [None] * victim.slots
            victim.state = STOPPED
            victim._resume.set()
            victim._cond.notify_all()
        if victim._thread is not None:
            victim._thread.join(10.0)
        survivors = [r for r in self._role_replicas(victim.role)
                     or self._role_replicas("decode") if r.routable()]
        rescued = 0
        for sess in resident:
            if survivors:
                target = min(survivors, key=lambda r: r.sessions_active())
                target.import_session(sess, None)  # the cache died with it
                rescued += 1
                with self._lock:
                    self.migrations += 1
            else:
                sess.fail(SessionDropped(
                    f"replica {name} died with no survivor"))
                with self._lock:
                    self.sessions_failed += 1
        return rescued

    # -- rolling reloads (cache-preserving) ----------------------------------

    def rolling_reload(self, params: Any, generation: int) -> int:
        """Swap every replica to ``generation`` one at a time, each at its
        own ITERATION BOUNDARY, every in-flight session's KV cache kept.
        The weights are cast once for the fleet's device."""
        params = llama.as_decode_params(params, self.device, self.cfg)
        self._gen_params = params
        swapped = 0
        with self._lock:
            replicas = list(self._replicas)
        for r in replicas:
            if r.state != STOPPED and r.swap_weights(params, generation):
                swapped += 1
        self.generation = generation
        if self._kv is not None:
            try:
                self._kv.kv_set(SERVING_GEN_KEY.format(job=self.job),
                                str(generation).encode())
            except Exception as exc:  # KV is observability here, not truth
                log.warn("serving generation publish failed", job=self.job,
                         error=str(exc)[:120])
        log.info("decode rolling reload complete", job=self.job,
                 generation=generation, replicas=swapped)
        return swapped

    def reload_from_lineage(self, checkpointer) -> Optional[int]:
        """Roll onto the newest VERIFIED step of a training job's lineage
        (an :class:`~edl_tpu_torch.runtime.checkpoint.ElasticCheckpointer`
        on its directory, whatever layout saved it): None when there is no
        step newer than :attr:`generation`; a step whose manifest lacks the
        verified bit, or whose restore fell back to another step (its
        leaves failing the manifest's folds), is skipped and counted
        (``serving_reload_skipped_unverified``).  A step whose manifest has
        not landed yet (its writer is still fingerprinting it) is left for
        a later call, uncounted: the reference ships it unverified.  Only
        the parameters are read, into host memory, then cast once for the
        device and swapped in by :meth:`rolling_reload`.  Returns the step
        shipped."""
        step = _lineage_step(checkpointer, self.generation, self.job)
        if step is None:
            return None
        restored = checkpointer.restore(
            {"params": llama.param_template(self.cfg)}, step=step)
        if not _landed(checkpointer, step, self.job):
            return None
        params = llama.as_decode_params(restored.pop("params"), self.device,
                                        self.cfg)
        self.rolling_reload(params, step)
        return step

    def watch_lineage(self, checkpointer, poll_s: float = 5.0,
                      scan_backstop: int = 1) -> "_WeightWatcher":
        """Start the reload driver: a thread that calls
        :meth:`reload_from_lineage` (a failure is logged and the next cycle
        tries again).  :meth:`stop` stops it.

        With a coordinator wired (``kv=``), each cycle long-polls the
        ``serving-gen/<job>`` key (``kv_wait_changed``) for up to
        ``poll_s`` instead of sleeping: a published generation wakes the
        reload within milliseconds.  The lineage itself is still scanned
        every ``scan_backstop`` cycles (default 1, every ``poll_s``, so a
        trainer that saves without publishing the key is still picked
        up); a larger backstop skips the scans a quiet key makes
        needless, counted ``serving_lineage_polls_saved``.  Without a
        coordinator the thread sleeps ``poll_s`` and scans every cycle."""
        self._watcher = _WeightWatcher(self, checkpointer, poll_s,
                                       scan_backstop=scan_backstop)
        self._watcher.start()
        return self._watcher

    # -- observation ---------------------------------------------------------

    def replicas_active(self, role: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for r in self._replicas
                       if r.state != STOPPED
                       and (role is None or r.role == role))

    def sessions_active(self) -> int:
        with self._lock:
            return sum(r.sessions_active() for r in self._replicas)

    def kv_blocks(self) -> tuple[int, int]:
        with self._lock:
            used = sum(r.pool.blocks_used() for r in self._replicas)
            total = sum(r.pool.num_blocks for r in self._replicas)
        return used, total

    def kv_bytes(self) -> int:
        """Pool residency of every replica."""
        with self._lock:
            return sum(r.pool.total_bytes() for r in self._replicas)

    def kv_reserved_bytes_per_device(self) -> int:
        """The most KV bytes any active replica's pool holds on one device
        (:meth:`KVBlockPool.reserved_bytes_per_device`): what a layout
        planned beside these pools must leave free on each device."""
        with self._lock:
            return max((r.pool.reserved_bytes_per_device()
                        for r in self._replicas if r.state != STOPPED),
                       default=0)

    def chips(self) -> int:
        """Devices backing active replicas: each replica's pool devices (a
        shared device counted once per replica and shard, as the JAX
        package counts wrapped slices)."""
        with self._lock:
            return sum(len(r.pool.devices) for r in self._replicas
                       if r.state != STOPPED)

    def stats(self, window_s: float = 10.0) -> FleetStats:
        """Windowed decode rollup: TTFT p99 over recent completions, decode
        tokens/s from the replicas' token counts."""
        now = time.perf_counter()
        with self._lock:
            ttfts = [(t, v) for t, v, _ in self._ttft_window
                     if now - t <= window_s]
            tpots = list(self._tok_window)
            replicas = list(self._replicas)
        toks = sum(r.tokens_emitted for r in replicas)
        if self._tok_mark is None:
            self._tok_mark = (now, toks)
        mark_t, mark_n = self._tok_mark
        span = max(now - mark_t, 1e-3)
        decode_tps = (toks - mark_n) / span if span >= 0.2 else 0.0
        if span > window_s:
            self._tok_mark = (now, toks)
        if ttfts:
            vals = np.sort(np.asarray([v for _, v in ttfts]))
            ttft_p99 = float(vals[int(0.99 * (len(vals) - 1))]) * 1e3
        else:
            ttft_p99 = 0.0
        tpot_p50 = (float(np.median(np.asarray(tpots))) * 1e3
                    if tpots else 0.0)
        used, total = self.kv_blocks()
        chips = self.chips()
        drafted = sum(r.spec_drafted for r in replicas)
        accepted = sum(r.spec_accepted for r in replicas)
        return FleetStats(
            p50_ms=tpot_p50, p99_ms=ttft_p99, qps=round(decode_tps, 2),
            queue_depth=sum(len(r._queue) for r in replicas),
            replicas_ready=sum(1 for r in replicas if r.routable()),
            replicas_active=len(replicas),
            requests_windowed=len(ttfts),
            ttft_p99_ms=round(ttft_p99, 3),
            tpot_p50_ms=round(tpot_p50, 4),
            decode_tps=round(decode_tps, 2),
            sessions=self.sessions_active(),
            kv_blocks_used=used, kv_blocks_total=total, chips=chips,
            tok_s_per_chip=round(decode_tps / max(chips, 1), 2),
            spec_accept_rate=(round(accepted / drafted, 4) if drafted
                              else 0.0))

    def stop(self, drain: bool = True) -> None:
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher = None
        with self._lock:
            replicas, self._replicas = list(self._replicas), []
        for r in replicas:
            r.stop(drain=drain)


_UNSET = object()


class _WeightWatcher(threading.Thread):
    """The thread of :meth:`DecodeFleet.watch_lineage` and
    :meth:`ServingFleet.watch_lineage`: each cycle parks on the
    generation key's change (or sleeps ``poll_s``, at least 0.1 s, when
    the fleet has no coordinator), then scans the lineage when the key
    fired or the scan backstop is due, until :meth:`stop`."""

    def __init__(self, fleet: "DecodeFleet | ServingFleet", checkpointer,
                 poll_s: float, scan_backstop: int = 1) -> None:
        super().__init__(name=f"serving-reload-{fleet.job}", daemon=True)
        self.fleet = fleet
        self.checkpointer = checkpointer
        self.poll_s = max(float(poll_s), 0.1)
        self.scan_backstop = max(int(scan_backstop), 1)
        # not named _stop: threading.Thread has a _stop method
        self._halt = threading.Event()
        self._no_longpoll = False
        self._gen_key = SERVING_GEN_KEY.format(job=fleet.job)
        # "never observed" differs from "key absent" (None): the baseline
        # updates only from the change-wait's own results, so a change is
        # never absorbed by a re-read before the wait could fire on it
        self._known: object = _UNSET
        #: lineage scans this watcher ran
        self.scans = 0

    def _park(self) -> tuple[bool, bool]:
        """One cycle's wait: long-poll the generation key when the fleet
        has a coordinator with the change-wait, else sleep.  Returns
        ``(fired, longpolled)``: ``fired`` when the key changed,
        ``longpolled`` when a change-wait watched it (only then may the
        backstop skip a scan)."""
        kv = self.fleet._kv
        wait_changed = (getattr(kv, "kv_wait_changed", None)
                        if kv is not None else None)
        if wait_changed is None or self._no_longpoll:
            self._halt.wait(self.poll_s)
            return False, False
        try:
            if self._known is _UNSET:
                self._known = kv.kv_get(self._gen_key)
            fired, newv = wait_changed(self._gen_key, self._known,
                                       self.poll_s)
            if getattr(kv, "_no_waitne", False):
                # a server without the change-wait: the client sleep-polls
                # the KV for us, pure added load — sleep-poll for good
                self._no_longpoll = True
                return False, False
            get_counters().inc("serving_lineage_longpolls",
                               result="fired" if fired else "timeout")
            if fired:
                self._known = newv
            return fired, True
        except Exception as exc:
            log.warn("lineage long-poll failed; sleeping this cycle",
                     job=self.fleet.job, error=str(exc)[:120])
            self._halt.wait(self.poll_s)
            return False, False

    def run(self) -> None:
        cycles_since_scan = 0
        while True:
            fired, longpolled = self._park()
            if self._halt.is_set():
                return
            cycles_since_scan += 1
            # the backstop gates only scans a live change-wait covers
            backstop = self.scan_backstop if longpolled else 1
            if fired or cycles_since_scan >= backstop:
                cycles_since_scan = 0
                self.scans += 1
                try:
                    self.fleet.reload_from_lineage(self.checkpointer)
                except Exception as exc:  # keep watching; the step is skipped
                    log.warn("lineage reload failed", job=self.fleet.job,
                             error=str(exc)[:200])
            else:
                get_counters().inc("serving_lineage_polls_saved")

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=30)


def _lineage_step(checkpointer, generation: int, job: str) -> Optional[int]:
    """The lineage step a fleet serving ``generation`` should roll onto:
    the newest step whose files verify, if it is newer and its manifest
    carries the verified bit.  A step whose manifest lacks the bit is
    skipped and counted (``serving_reload_skipped_unverified``); one whose
    manifest has not landed yet (its writer is still fingerprinting it) is
    left for a later call, uncounted — the reference ships it unverified."""
    refresh = getattr(checkpointer, "refresh", None)
    if refresh is not None:
        # the lineage is written by another process (the trainer): without
        # a refresh the cached step list never shows the next generation
        refresh()
    step = checkpointer.latest_verified_step()
    if step is None or step <= generation:
        return None
    verified_fn = getattr(checkpointer, "manifest_verified", None)
    verified = verified_fn(step) if verified_fn is not None else True
    if verified is None:
        return None
    if verified is False:
        log.warn("serving reload SKIPPED unverified generation", job=job,
                 generation=step)
        get_counters().inc("serving_reload_skipped_unverified")
        return None
    return step


def _landed(checkpointer, step: int, job: str) -> bool:
    """False (counted as skipped) when the restore of ``step`` fell back to
    another step — its leaves failed the manifest's folds — so that older
    tree is never published under the newer generation number."""
    landed = getattr(checkpointer, "last_restored_step", step)
    if landed is not None and landed != step:
        log.warn("serving reload SKIPPED generation that failed "
                 "verification at restore", job=job, generation=step,
                 landed=landed)
        get_counters().inc("serving_reload_skipped_unverified")
        return False
    return True


# -- the single-shot half: one forward a request -----------------------------


def _request_hist():
    return get_registry().histogram(
        "serving_request_seconds",
        help="end-to-end request latency (enqueue to reply)",
        buckets=SERVING_LATENCY_BUCKETS)


def _queue_hist():
    return get_registry().histogram(
        "serving_queue_depth",
        help="admission-queue depth observed at each serve iteration",
        buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256))


def _span_hist():
    return get_registry().histogram(
        "serving_span_seconds",
        help="per-request phase latency (admit/queue/batch/forward/"
             "respond — the request-span taxonomy)",
        buckets=SERVING_LATENCY_BUCKETS)


@dataclass
class ServeRequest:
    """One in-flight inference request: a single example (tuple of
    per-example arrays, no batch dim), its completion future, and the
    per-phase timestamps the request-span taxonomy is cut from:

    * **admit** — ``t_enqueue → t_queued``: routing, until the replica's
      admission queue holds the request;
    * **queue** — ``t_queued → t_admit``: waiting in the queue (+ the
      co-batchee admission window);
    * **batch** — ``t_admit → t_forward0``: padding/stacking to the
      fixed batch shape;
    * **forward** — ``t_forward0 → t_forward1``: the serve step + host
      readback;
    * **respond** — ``t_forward1 → t_done``: per-row completion.

    ``trace_id`` (propagated from the ``/predict`` ``X-EDL-Trace-Id``
    header, or any caller) makes the request's phases first-class
    trace spans; without one, spans are emitted only for SLO violations
    so a p99 breach is attributable to a phase without flooding the trace
    ring at full qps.  ``parent_span`` (the LB's injected
    ``X-EDL-Parent-Span``) roots the span tree under the origin tier's
    admission span, so the cross-process tree stitches."""

    payload: tuple
    id: int = 0
    t_enqueue: float = 0.0
    t_queued: float = 0.0
    t_admit: float = 0.0
    t_forward0: float = 0.0
    t_forward1: float = 0.0
    t_done: float = 0.0
    trace_id: Optional[str] = None
    parent_span: Optional[str] = None

    def __post_init__(self) -> None:
        self._done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.slo_violation = False
        self._callbacks: list[Callable[["ServeRequest"], None]] = []

    def add_done_callback(self, fn: Callable[["ServeRequest"], None]
                          ) -> None:
        """Run ``fn(self)`` when the request completes or fails (on the
        completing thread) — immediately if it already has."""
        if self._done.is_set():
            fn(self)
            return
        self._callbacks.append(fn)
        # completion may have raced the append: never lose the callback
        # (remove is atomic; a concurrent _fire_callbacks pop wins the
        # ValueError race and has already called fn)
        if self._done.is_set():
            try:
                self._callbacks.remove(fn)
            except ValueError:
                return
            fn(self)

    def _fire_callbacks(self) -> None:
        while self._callbacks:
            try:
                self._callbacks.pop(0)(self)
            except Exception:  # a callback must never kill the serve loop
                log.warn("request done-callback failed", request=self.id)

    def complete(self, result: Any) -> None:
        self.t_done = time.perf_counter()
        self.result = result
        self._done.set()
        self._fire_callbacks()

    def fail(self, exc: BaseException) -> None:
        self.t_done = time.perf_counter()
        self.error = exc
        self._done.set()
        self._fire_callbacks()

    def wait(self, timeout: Optional[float] = None):
        """Block for the reply; raises the replica-side error if the
        request failed (a dropped request surfaces, never hangs)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not served in {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_enqueue


class RequestDropped(RuntimeError):
    """The replica stopped without serving this request (only a forced,
    non-draining stop can cause it — counted, and held to zero)."""


class ReplicaRankDied(RequestDropped):
    """A rank process of a wide replica died: the whole replica ends, and
    every request it held fails with this."""


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _host(t: torch.Tensor) -> np.ndarray:
    """One device→host copy of ``t`` as numpy (bf16, which numpy lacks,
    widened to fp32 on the host)."""
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class ElasticServer:
    """Forward-only elastic model server: an
    :class:`~edl_tpu_torch.runtime.elastic.ElasticTrainer` (its layouts,
    prewarm and transactional resize) that runs ``apply_fn(params, batch)
    -> outputs`` instead of a train step.  ``params`` is the model (an
    ``nn.Module``); ``trainer_kwargs`` go to the trainer (``devices``,
    ``initial_world_size``, ``param_sharding``, ``spec``, ...).  There is
    no optimizer state: an identity optimizer, so a resize moves the
    params only.

    Under a process group the server is SPMD like the trainer: every rank
    constructs it and calls :meth:`serve` with the same batch; each live
    rank runs its slice of the batch and the outputs are gathered over the
    data axes, so every live rank returns every row, and a rank standing
    by returns None."""

    def __init__(self, apply_fn: Callable[[Any, Any], Any], params: Any,
                 **trainer_kwargs) -> None:
        self.apply_fn = apply_fn
        #: forwards run, the warm-up's included
        self.forwards = 0
        self._trainer = ElasticTrainer(apply_fn, params, optim.identity(),
                                       **trainer_kwargs)

    # -- the serving surface ------------------------------------------------

    def serve(self, batch) -> Any:
        """One forward pass over ``batch`` (a tuple of arrays or tensors
        with the batch dim first) on the live layout, under
        ``torch.inference_mode`` inside the trainer's gather, tp and split
        contexts, as its ``eval_loss`` runs; the outputs stay on the
        device."""
        t = self._trainer
        if not t.live:
            return None
        with torch.inference_mode():
            with t._gathered(), t._tp(), t._split():
                out = self.apply_fn(t.state.params, t._local(batch))
            self.forwards += 1
            n, sp = t._width, t.shape.sp
            if n == 1:
                return out

            def rows(x: torch.Tensor) -> torch.Tensor:
                flat = x.contiguous().reshape(-1)
                buf = torch.empty(n * flat.numel(), dtype=x.dtype,
                                  device=x.device)
                _all_gather(buf, flat, t.mesh.data, t._data_label)
                # the forward runs outside the sp context, so the ranks of
                # an sp line (the innermost data axis) hold the same rows
                return buf.view(n, *x.shape)[::sp].reshape(
                    n // sp * x.shape[0], *x.shape[1:])

            return _tree_map(rows, out)

    def warmup(self, batch) -> None:
        """Run one real forward on the fixed batch shape and wait for it —
        the ready gate's build step: a replica warms up BEFORE traffic
        routes to it, so the first request pays neither the first launch
        (on the card: building and loading the kernel library) nor the
        allocator's first growth."""
        self.serve(batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def load_params(self, params: Any) -> None:
        """Swap to new-generation weights: ``params`` (a module, or its
        tensors by parameter name) into the live layout, each rank taking
        its own block of every leaf.  Callers serialize swaps between
        serve iterations (ServingReplica does)."""
        named = (dict(params.named_parameters())
                 if isinstance(params, torch.nn.Module) else dict(params))
        self._trainer.load_whole_state(
            {keystr(("params",) + param_path(n)): t.detach()
             for n, t in named.items()})

    def params_host(self) -> torch.nn.Module:
        """A host copy of the model with the live weights whole (the
        restore template for lineage reloads); collective over the live
        group on a sharded server's live rank."""
        t = self._trainer
        module = t.state.params
        full = (t.full_params() if t.sharded
                else dict(module.named_parameters()))
        memo = {id(p): torch.nn.Parameter(full[n].detach().to("cpu",
                                                               copy=True),
                                          requires_grad=False)
                for n, p in module.named_parameters()}
        return copy.deepcopy(module, memo)

    # -- elastic passthroughs ----------------------------------------------

    def resize(self, target) -> bool:
        return self._trainer.resize(target)

    def prewarm(self, sizes, wait: bool = False):
        return self._trainer.prewarm(sizes, wait=wait)

    @property
    def device(self) -> torch.device:
        return self._trainer.device

    @property
    def world_size(self) -> int:
        return self._trainer.world_size

    @property
    def resize_events(self) -> list:
        return self._trainer.resize_events

    def close(self) -> None:
        """Nothing to release: the server lives in this process."""


# -- wide replicas: a rank process a device -----------------------------------

#: a collective of a wide replica's group that waits longer than this raises
WIDE_GROUP_TIMEOUT_S = 60
#: the seconds a wide replica's ranks may take to start, load and warm up
WIDE_BUILD_TIMEOUT_S = 600.0
#: an idle rank 0 broadcasts a no-op this often, so the ranks waiting on
#: its next op never reach the group's timeout
WIDE_IDLE_TICK_S = 10.0
#: the ops rank 0 broadcasts to its group, one a message from the fleet
_OPS = {"serve": 1, "load": 2, "host": 3, "counts": 4, "stop": 5,
        "noop": 6}


def _flatten(tree) -> tuple[list, Any]:
    """(leaves, spec) of a tuple, list or dict tree of arrays; the spec
    holds each leaf's index."""
    leaves: list = []

    def walk(t):
        if isinstance(t, (tuple, list)):
            return type(t)(walk(x) for x in t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        leaves.append(t)
        return len(leaves) - 1

    return leaves, walk(tree)


def _shm_attach(name: str):
    """Attach to another process's shared memory block.  Its creator
    unlinks it; the fleet's process and its forked ranks share one
    resource tracker, which has the block once however many attach."""
    from multiprocessing import shared_memory

    return shared_memory.SharedMemory(name=name)


def _shm_write(shm, arrays: list) -> list:
    """Copy ``arrays`` one after another into ``shm``; their (shape, dtype,
    offset) for :func:`_shm_read`."""
    at, where = 0, []
    for a in arrays:
        a = np.ascontiguousarray(a)
        np.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=at)[...] = a
        where.append((a.shape, a.dtype.str, at))
        at += -(-a.nbytes // 64) * 64
    return where


def _shm_read(shm, where: list) -> list:
    """Copies of the arrays :func:`_shm_write` put in ``shm``."""
    return [np.ndarray(shape, np.dtype(dt), buffer=shm.buf,
                       offset=at).copy() for shape, dt, at in where]


def _shm_bytes(arrays: list) -> int:
    return sum(-(-np.asarray(a).nbytes // 64) * 64 for a in arrays)


def _skeleton(module: torch.nn.Module) -> bytes:
    """``module`` pickled with every parameter and buffer on the meta
    device: its structure (and config), none of its storage."""
    memo = {id(t): (torch.nn.Parameter(torch.empty_like(t, device="meta"),
                                       requires_grad=t.requires_grad)
                    if isinstance(t, torch.nn.Parameter)
                    else torch.empty_like(t, device="meta"))
            for t in list(module.parameters()) + list(module.buffers())}
    return pickle.dumps(copy.deepcopy(module, memo))


class RankGroupServer:
    """The fleet-side handle of a replica ``len(devices)`` devices wide: one
    rank process a device (forked from :func:`~edl_tpu_torch.runtime.
    elastic.rank_processes`' fork server, each running
    :func:`wide_replica_rank`), joined in a process group of their own (gloo when
    they share a device, NCCL across cards), each holding the SPMD
    :class:`ElasticServer` over it.  It has :class:`ElasticServer`'s serving
    surface, so a :class:`ServingReplica` runs it as it runs a thread's
    server.

    The fleet talks to rank 0 alone: each call is one small message over a
    pipe, which rank 0 broadcasts to its group with a collective before
    every rank acts on it — a batch (every rank serves its rows and rank 0
    returns the rows gathered over the group), new weights (every rank
    loads them before rank 0 answers, so no batch after it runs on the old
    generation), a host copy of the weights, the ranks' launch counts, or
    the stop.  Bulk data never rides the pipe (a local socket may move a
    few MB/s where the host's memory moves GB/s): a batch and its answers
    travel through shared memory blocks, weights through a file in the
    replica's own temporary directory, beside its group's store.  A batch
    may hold any number of rows (a front door's chunk): it is padded to a
    multiple of the ranks.  The death of any rank process, or an error a
    rank answers (its process ends with it), ends the replica at once: the
    call in flight and every later one raise :class:`ReplicaRankDied`, the other ranks are killed (never left
    waiting on the group's timeout), and ``on_death`` is told, also when
    no call is in flight."""

    def __init__(self, apply_fn: Callable[[Any, Any], Any],
                 params: torch.nn.Module, example_batch: tuple,
                 devices: Sequence, name: str = "replica",
                 on_death: Optional[Callable[[BaseException], None]] = None
                 ) -> None:
        from multiprocessing import shared_memory

        self.name = name
        #: each rank's device, a card named by its index
        self.devices = [torch.device("cuda", torch.cuda.current_device())
                        if d.type == "cuda" and d.index is None else d
                        for d in map(torch.device, devices)]
        self.on_death = on_death
        #: forwards run (the warm-up's included), as ElasticServer counts
        self.forwards = 0
        #: each rank's launch counts, read at the stop (None before)
        self.final_counts: Optional[list] = None
        self._skeleton = _skeleton(params)
        self._lock = threading.Lock()
        self._death_lock = threading.Lock()
        self._dead: Optional[BaseException] = None
        #: set before the stop: the ranks' exits after it are no death
        self._closing = False
        self._dir = tempfile.mkdtemp(prefix="edl-wide-replica-")
        n = len(self.devices)
        #: the batch block: the example batch's rows, padded to the ranks
        self._rows_cap = -(-len(example_batch[0]) // n) * n
        self._shm_in = shared_memory.SharedMemory(
            create=True, size=max(_shm_bytes(
                [np.repeat(np.asarray(a)[:1], self._rows_cap, axis=0)
                 for a in example_batch]), 64))
        self._shm_out = None
        ctx = rank_processes(__name__)
        self._conn, child = ctx.Pipe()
        store = os.path.join(self._dir, "store")
        self.procs = [ctx.Process(
            target=wide_replica_rank, daemon=True,
            name=f"{name}-rank{r}",
            args=(r, [str(d) for d in self.devices], store,
                  child if r == 0 else None, apply_fn, self._skeleton,
                  example_batch, self._shm_in.name))
            for r in range(n)]
        for p in self.procs:
            p.start()
        child.close()
        self._wake_r, self._wake_w = os.pipe()
        self._monitor = threading.Thread(target=self._watch, daemon=True,
                                         name=f"{name}-ranks")
        self._monitor.start()
        self._load(params, WIDE_BUILD_TIMEOUT_S)

    # -- the pipe to rank 0 --------------------------------------------------

    def _call(self, op: str, payload=None,
              timeout_s: float = WIDE_BUILD_TIMEOUT_S):
        with self._lock:
            if self._dead is not None:
                raise self._dead
            try:
                self._conn.send((op, payload))
                deadline = time.monotonic() + timeout_s
                while True:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise TimeoutError(f"replica {self.name}: {op} took "
                                           f"over {timeout_s} s")
                    ready = mp_connection.wait(
                        [self._conn] + [p.sentinel for p in self.procs],
                        timeout=left)
                    if self._conn in ready:
                        status, got = self._conn.recv()
                        break
                    if ready:
                        raise EOFError("a rank process exited")
            except (EOFError, OSError) as exc:
                self._die(f"{op}: {exc}")
                raise self._dead from exc
            if status != "ok":
                # a rank that fails ends its process (a peer's death shows
                # as a reset on the group first): the replica is over
                self._die(f"{op} failed on its ranks: {got}")
                raise self._dead
        return got

    def _watch(self) -> None:
        """Wait for any rank process to end (or the close's wake-up); a
        rank that ends before the close ends the replica."""
        mp_connection.wait([p.sentinel for p in self.procs] + [self._wake_r])
        if not self._closing:
            self._die("a rank process exited")

    def _die(self, why: str) -> None:
        """End the replica: kill every rank left, once, and tell
        ``on_death``."""
        with self._death_lock:
            first = self._dead is None
            if first:
                codes = [p.exitcode for p in self.procs]
                self._dead = ReplicaRankDied(
                    f"replica {self.name}: {why} (exit codes {codes}); its "
                    "other ranks are killed")
        self._kill()
        if first:
            log.error("wide replica rank died", replica=self.name,
                      why=why)
            get_counters().inc("serving_replica_rank_deaths")
            if self.on_death is not None:
                self.on_death(self._dead)

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                try:
                    os.kill(p.pid, signal.SIGKILL)
                except OSError:
                    pass
        for p in self.procs:
            p.join(10)

    def _load(self, params, timeout_s: float = WIDE_BUILD_TIMEOUT_S
              ) -> None:
        named = (dict(params.named_parameters())
                 if isinstance(params, torch.nn.Module) else dict(params))
        path = os.path.join(self._dir, f"weights-{time.monotonic_ns()}.pt")
        torch.save({n: t.detach().to("cpu") for n, t in named.items()},
                   path)
        try:
            self._call("load", path, timeout_s)
        finally:
            if os.path.exists(path):
                os.remove(path)

    # -- ElasticServer's serving surface -------------------------------------

    def serve(self, batch) -> Any:
        """One forward over ``batch``: its rows in chunks of the batch
        block's, each padded with its last row to a multiple of the ranks,
        which split it, and the answers trimmed back."""
        arrays = [np.asarray(a) for a in batch]
        rows = len(arrays[0])
        outs = []
        for lo in range(0, rows, self._rows_cap):
            chunk = [a[lo:lo + self._rows_cap] for a in arrays]
            k = len(chunk[0])
            pad = -k % len(self.devices)
            if pad:
                chunk = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                         for a in chunk]
            where = _shm_write(self._shm_in, chunk)
            out_name, out_where, spec = self._call("serve", where)
            if self._shm_out is None or self._shm_out.name != out_name:
                if self._shm_out is not None:
                    self._shm_out.close()
                self._shm_out = _shm_attach(out_name)
            outs.append(([a[:k] for a in _shm_read(self._shm_out,
                                                  out_where)], spec))
        self.forwards += 1
        leaves = [np.concatenate(parts) for parts in
                  zip(*(leaves for leaves, _ in outs))]
        return _tree_map(lambda i: torch.from_numpy(leaves[i]), outs[0][1])

    def warmup(self, batch) -> None:
        self.serve(batch)

    def load_params(self, params: Any) -> None:
        self._load(params)

    def params_host(self) -> torch.nn.Module:
        module = pickle.loads(self._skeleton).to_empty(device="cpu")
        path = os.path.join(self._dir, f"host-{time.monotonic_ns()}.pt")
        self._call("host", path)
        try:
            got = torch.load(path, map_location="cpu")
        finally:
            os.remove(path)
        with torch.no_grad():
            for n, p in module.named_parameters():
                p.copy_(got[n])
                p.requires_grad_(False)
        return module

    def rank_counts(self) -> list:
        """Each rank's ``{"flash": launches by kernel, "forwards": n}``."""
        return self._call("counts")

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def world_size(self) -> int:
        return len(self.devices)

    def close(self) -> None:
        """Stop the ranks (their counts kept in :attr:`final_counts`) and
        release the shared memory and the replica's files; a dead
        replica's ranks are gone already."""
        if self._closing:
            return
        self._closing = True
        if self._dead is None:
            try:
                self.final_counts = self._call("stop", None, 60.0)
            except (RequestDropped, TimeoutError) as exc:
                log.warn("wide replica stop failed", replica=self.name,
                         error=str(exc)[:120])
        os.write(self._wake_w, b"x")
        self._kill()
        self._monitor.join(10)
        self._conn.close()
        os.close(self._wake_r)
        os.close(self._wake_w)
        if self._shm_out is not None:
            self._shm_out.close()
            if self._dead is not None:
                # its creator, rank 0, died before it could unlink it
                with contextlib.suppress(FileNotFoundError):
                    self._shm_out.unlink()
        self._shm_in.close()
        self._shm_in.unlink()
        shutil.rmtree(self._dir, ignore_errors=True)


def wide_replica_rank(rank: int, devices: list, store_path, conn,
                      apply_fn, skeleton: bytes, example_batch: tuple,
                      shm_in: str) -> None:
    """One rank process of a serving replica ``len(devices)`` devices wide
    (:class:`RankGroupServer`): join the replica's own process group
    through a ``FileStore`` at ``store_path`` on ``devices[rank]`` — gloo
    when the ranks share a device (one card, or the CPU), NCCL across
    cards — and serve until the fleet stops the replica
    (:func:`serve_ranks`; ``conn`` is rank 0's pipe to the fleet, None on
    the others, and ``shm_in`` the shared memory block the fleet puts each
    batch in)."""
    from datetime import timedelta

    import torch.distributed as dist

    devs = [torch.device(d) for d in devices]
    dev = devs[rank]
    shared = dev.type != "cuda" or len(set(devs)) < len(devs)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo" if shared else "nccl",
        store=dist.FileStore(str(store_path), len(devs)), rank=rank,
        world_size=len(devs),
        timeout=timedelta(seconds=WIDE_GROUP_TIMEOUT_S))
    try:
        serve_ranks(rank, dev, conn, apply_fn, skeleton, example_batch,
                    shm_in, torch.device("cpu") if shared else dev)
    finally:
        dist.destroy_process_group()


def serve_ranks(rank: int, device: torch.device, conn, apply_fn,
                skeleton: bytes, example_batch: tuple, shm_in: str,
                comm_device: torch.device) -> None:
    """One rank's life in a wide replica (:class:`RankGroupServer`), in a
    process that has joined the replica's group: rank 0 takes each message
    from the fleet's pipe (a batch's place in the shared memory block
    ``shm_in``, a weights file's path) and broadcasts its op and its data
    (on ``comm_device``: the host for gloo, the card for NCCL) to the
    group; every rank acts on it.  The first message is the weights the
    :class:`ElasticServer` is built on.  With no message for
    ``WIDE_IDLE_TICK_S`` rank 0 broadcasts a no-op, so an idle replica's
    ranks never wait out the group's timeout.  Returns at the stop."""
    from multiprocessing import shared_memory

    import torch.distributed as dist

    from edl_tpu_torch.ops import flash_attention as fa

    module = pickle.loads(skeleton).to_empty(device=device)
    rows = [torch.from_numpy(np.asarray(e)) for e in example_batch]
    block = _shm_attach(shm_in) if rank == 0 else None
    out_block = None
    server: Optional[ElasticServer] = None

    def bcast(t: torch.Tensor) -> torch.Tensor:
        t = t.to(comm_device)
        dist.broadcast(t, 0)
        return t

    def bcast_object(obj):
        box = [obj]
        dist.broadcast_object_list(box, 0)
        return box[0]

    try:
        while True:
            msg = (None, None)
            if rank == 0:
                msg = (conn.recv() if conn.poll(WIDE_IDLE_TICK_S)
                       else ("noop", None))
            n_rows = (msg[1][0][0][0] if rank == 0 and msg[0] == "serve"
                      else 0)
            head = bcast(torch.tensor([_OPS.get(msg[0], 0), n_rows]))
            op, n_rows = (int(x) for x in head.tolist())
            try:
                if op == _OPS["serve"]:
                    got = _shm_read(block, msg[1]) if rank == 0 else rows
                    batch = tuple(
                        bcast(torch.from_numpy(a) if rank == 0
                              else e.new_empty((n_rows,)
                                               + tuple(e.shape[1:])))
                        for a, e in zip(got, rows))
                    out = server.serve(batch)
                    reply = None
                    if rank == 0:
                        leaves, spec = _flatten(_tree_map(_host, out))
                        need = _shm_bytes(leaves)
                        if out_block is None or out_block.size < need:
                            if out_block is not None:
                                out_block.close()
                                out_block.unlink()
                            out_block = shared_memory.SharedMemory(
                                create=True, size=need)
                        reply = (out_block.name,
                                 _shm_write(out_block, leaves), spec)
                elif op == _OPS["load"]:
                    path = bcast_object(msg[1])
                    named = torch.load(path, map_location=device)
                    if server is None:
                        with torch.no_grad():
                            for n, p in module.named_parameters():
                                p.copy_(named[n])
                        server = ElasticServer(
                            apply_fn, module, devices=[device],
                            initial_world_size=dist.get_world_size())
                        server.warmup(example_batch)
                    else:
                        server.load_params(named)
                    del named
                    dist.barrier()
                    reply = None
                elif op == _OPS["host"]:
                    path = bcast_object(msg[1])
                    host = server.params_host()
                    if rank == 0:
                        torch.save({n: p.detach() for n, p in
                                    host.named_parameters()}, path)
                    reply = None
                elif op == _OPS["noop"]:
                    continue  # idle: nothing to act on, nothing to answer
                elif op in (_OPS["counts"], _OPS["stop"]):
                    mine = {"flash": dict(fa.launches),
                            "forwards": server.forwards if server else 0}
                    every = [None] * dist.get_world_size()
                    dist.all_gather_object(every, mine)
                    reply = every
                else:
                    raise ValueError(f"unknown op {msg[0]!r}")
            except Exception as exc:  # answered, then the replica is ended
                if rank == 0:
                    conn.send(("error", repr(exc)[:400]))
                raise
            if rank == 0:
                conn.send(("ok", reply))
            if op == _OPS["stop"]:
                return
    finally:
        if block is not None:
            block.close()
        if out_block is not None:
            out_block.close()
            out_block.unlink()


class ServingReplica:
    """One replicated model server: an admission queue drained by a
    continuous-batching loop over an :class:`ElasticServer`.

    Each iteration admits up to ``max_batch_size`` queued requests
    (waiting at most ``max_queue_ms`` for co-batchees once the first is
    in hand), stacks them on the host and pads them to the fixed batch
    shape, copies the batch to the device once, runs ONE serve step,
    copies the outputs back once, and completes every future with its row
    — so throughput scales with load while the batch shape never changes.
    Weight swaps and drain both happen at iteration boundaries: an
    in-flight request is never dropped by a reload or a scale-down."""

    def __init__(self, name: str, build: Callable[[], ElasticServer],
                 example_batch: tuple, max_batch_size: int = 8,
                 max_queue_ms: float = 2.0, job: str = "job",
                 slo_p99_ms: float = 0.0,
                 on_done: Optional[Callable[[ServeRequest], None]] = None
                 ) -> None:
        self.name = name
        self.job = job
        self.max_batch_size = max(int(max_batch_size), 1)
        self.max_queue_ms = max(float(max_queue_ms), 0.0)
        self.slo_p99_ms = float(slo_p99_ms)
        self._build = build
        self._example_batch = example_batch
        self._on_done = on_done
        self.server: Optional[ElasticServer] = None
        self.state = BUILDING
        self.generation: int = 0
        self.iterations = 0
        self.requests_served = 0
        #: wall milliseconds from start() to READY (build + warm-up)
        self.build_ms: Optional[float] = None
        self._queue: "collections.deque[ServeRequest]" = collections.deque()
        self._cond = threading.Condition()
        self._pending_weights: Optional[tuple[Any, int]] = None
        #: set while no staged weights wait to be applied
        self._swap_applied = threading.Event()
        self._swap_applied.set()
        self._ready_at: Optional[float] = None
        self._built = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # metric handles resolved ONCE: the serve loop is the path whose
        # p99 the SLO defends — per-iteration registry lookups (a global
        # lock each) have no business on it
        self._hist = _request_hist()
        self._qhist = _queue_hist()
        self._shist = _span_hist()
        self._counters = get_counters()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ServingReplica":
        """Build and warm up on a background thread, then serve.  The
        replica reports READY only once its warm-up forward has run — the
        ready gate that keeps the build off the traffic path."""
        self._thread = threading.Thread(target=self._run,
                                        name=f"serving-{self.name}")
        self._thread.start()
        return self

    def wait_ready(self, timeout_s: float = 120.0) -> bool:
        return self._built.wait(timeout_s) and self.state != STOPPED

    def _run(self) -> None:
        # a replica is a world-1 server, whatever group this process joined
        with outside_group():
            self._serve_life()

    def _serve_life(self) -> None:
        t0 = time.perf_counter()
        try:
            self.server = self._build()
            self.server.warmup(self._example_batch)
        except Exception as exc:
            log.error("replica build failed", replica=self.name,
                      error=str(exc)[:200])
            self.state = STOPPED
            self._built.set()
            self._fail_queue(exc)
            return
        self.build_ms = round((time.perf_counter() - t0) * 1000, 1)
        with self._cond:
            if self.state == BUILDING:
                self.state = READY
            self._ready_at = time.perf_counter()
        self._built.set()
        get_tracer().instant("serving_replica_ready", category="serving",
                             replica=self.name, build_ms=self.build_ms)
        log.info("serving replica ready", replica=self.name,
                 build_ms=self.build_ms)
        try:
            self._loop()
        finally:
            self.server.close()

    def rank_died(self, exc: BaseException) -> None:
        """A wide replica's rank process died (:class:`RankGroupServer`'s
        ``on_death``, from any thread): the replica stops at once and every
        request it holds fails typed."""
        with self._cond:
            self.state = STOPPED
            self._cond.notify_all()
        self._swap_applied.set()  # nothing staged will be applied now
        self._fail_queue(exc)

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> bool:
        """Stop serving.  ``drain=True`` (the graceful path) serves out
        the queue first — zero dropped requests; ``drain=False`` fails
        whatever is left (each one counted ``serving_dropped_requests``
        and surfaced to its waiter as :class:`RequestDropped`)."""
        with self._cond:
            self.state = DRAINING if drain else STOPPED
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout_s)
        with self._cond:
            self.state = STOPPED
            self._cond.notify_all()
        self._swap_applied.set()  # nothing staged will be applied now
        self._fail_queue(RequestDropped(
            f"replica {self.name} stopped before serving"))
        return t is None or not t.is_alive()

    def _fail_queue(self, exc: BaseException) -> None:
        dropped = []
        with self._cond:
            while self._queue:
                dropped.append(self._queue.popleft())
        for req in dropped:
            self._counters.inc("serving_dropped_requests", job=self.job)
            req.fail(exc)

    # -- admission ----------------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        with self._cond:
            if self.state == STOPPED:
                raise RequestDropped(f"replica {self.name} is stopped")
            req.t_queued = time.perf_counter()
            self._queue.append(req)
            self._cond.notify_all()

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def routable(self) -> bool:
        """READY with no weights waiting: a replica that still has to
        take the fleet's generation takes no traffic."""
        return self.state == READY and self._pending_weights is None

    def gate(self) -> bool:
        """READY → RELOADING, atomically: the reload gate must not
        clobber a concurrent stop()'s DRAINING/STOPPED (the serve loop
        would never see the drain signal and a forced timeout would drop
        the queue).  True iff this call took the gate."""
        with self._cond:
            if self.state != READY:
                return False
            self.state = RELOADING
            return True

    def ungate(self) -> None:
        """RELOADING → READY — only if still gated; a stop() that won
        the race keeps its state."""
        with self._cond:
            if self.state == RELOADING:
                self.state = READY
            self._cond.notify_all()

    # -- weight reload ------------------------------------------------------

    def swap_weights(self, params: Any, generation: int,
                     timeout_s: float = 30.0) -> bool:
        """Hand the loop new weights; applied at the next iteration
        boundary (never mid-batch).  Blocks until applied."""
        return (self.stage_weights(params, generation)
                and self.wait_weights(timeout_s))

    def stage_weights(self, params: Any, generation: int) -> bool:
        """Queue new weights without waiting for them: the loop applies
        them before it admits another batch (a replica still building
        applies them right after its warm-up), and the replica is not
        routable until it has."""
        with self._cond:
            if self.state == STOPPED:
                return False
            self._swap_applied.clear()
            self._pending_weights = (params, generation)
            self._cond.notify_all()
        return True

    def wait_weights(self, timeout_s: float = 30.0) -> bool:
        """Wait until no staged weights are left to apply; False on a
        timeout or when the replica stopped with weights unapplied."""
        return (self._swap_applied.wait(timeout_s)
                and self._pending_weights is None)

    def _maybe_swap(self) -> None:
        with self._cond:
            pending = self._pending_weights
        if pending is None:
            return
        params, generation = pending
        t0 = time.perf_counter()
        try:
            self.server.load_params(params)
        except ReplicaRankDied as exc:
            self.rank_died(exc)
            return
        self.generation = generation
        with self._cond:
            # weights staged again meanwhile wait for the next boundary
            if self._pending_weights is pending:
                self._pending_weights = None
                self._swap_applied.set()
        self._counters.inc("serving_reloads", job=self.job)
        get_tracer().instant(
            "serving_weights_reloaded", category="serving",
            replica=self.name, generation=generation,
            swap_ms=round((time.perf_counter() - t0) * 1000, 2))
        get_registry().gauge(
            "serving_weight_generation",
            help="checkpoint generation the replica serves"
        ).set(generation, job=self.job, replica=self.name)

    # -- the continuous-batching loop ---------------------------------------

    def _admit(self) -> Optional[list[ServeRequest]]:
        """Block for the next batch: the first queued request opens an
        admission window of ``max_queue_ms`` (or until the batch is
        full) — iteration-level batching, so a lone request never waits
        for a full batch and a burst packs the step."""
        with self._cond:
            while not self._queue:
                if self.state in (DRAINING, STOPPED):
                    return None
                if self._pending_weights is not None:
                    return []  # idle swap: wake the loop to apply it
                self._cond.wait(0.1)
            if self.state == STOPPED:
                return None  # forced stop: stop() fails the queue
            if self._pending_weights is not None:
                return []  # staged weights land before the next batch
            if self.max_queue_ms > 0 and self.state == READY:
                deadline = time.perf_counter() + self.max_queue_ms / 1000.0
                while (len(self._queue) < self.max_batch_size
                       and self.state == READY):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            batch = [self._queue.popleft()
                     for _ in range(min(len(self._queue),
                                        self.max_batch_size))]
        t_admit = time.perf_counter()
        for r in batch:
            r.t_admit = t_admit
        return batch

    def _loop(self) -> None:
        while True:
            self._maybe_swap()
            reqs = self._admit()
            if reqs is None:
                with self._cond:
                    if self.state == DRAINING and self._queue:
                        continue  # raced a late submit while draining
                self._maybe_swap()  # a swap racing the drain still lands
                return
            if not reqs:
                continue  # woke for a weight swap (applied at the top)
            self._qhist.observe(self.queue_depth() + len(reqs),
                                replica=self.name)
            n = len(reqs)
            # pad to the fixed shape: the step always sees max_batch_size
            # rows, so admission depth never changes what it launches
            rows = [r.payload for r in reqs]
            rows += [rows[-1]] * (self.max_batch_size - n)
            batch = tuple(np.stack(col) for col in zip(*rows))
            t_fwd0 = time.perf_counter()
            try:
                host = _tree_map(_host, self.server.serve(batch))
            except ReplicaRankDied as exc:
                for req in reqs:
                    self._counters.inc("serving_dropped_requests",
                                       job=self.job)
                    req.fail(exc)
                self.rank_died(exc)
                return
            except Exception as exc:
                log.error("serve iteration failed", replica=self.name,
                          error=str(exc)[:200])
                for req in reqs:
                    self._counters.inc("serving_request_errors",
                                       job=self.job)
                    req.fail(exc)
                continue
            t_fwd1 = time.perf_counter()
            self.iterations += 1
            # iteration-level phases observed once per request so the
            # phase histograms and the request histogram share a
            # denominator
            for i, req in enumerate(reqs):
                req.t_forward0, req.t_forward1 = t_fwd0, t_fwd1
                req.complete(_tree_map(lambda a: a[i], host))
                self.requests_served += 1
                lat = req.latency_s
                self._hist.observe(lat, job=self.job)
                self._shist.observe(
                    max(req.t_queued - req.t_enqueue, 0.0), phase="admit")
                self._shist.observe(
                    max(req.t_admit - req.t_queued, 0.0), phase="queue")
                self._shist.observe(
                    max(t_fwd0 - req.t_admit, 0.0), phase="batch")
                self._shist.observe(t_fwd1 - t_fwd0, phase="forward")
                self._shist.observe(
                    max(req.t_done - t_fwd1, 0.0), phase="respond")
                self._counters.inc("serving_requests", job=self.job)
                if self.slo_p99_ms and lat * 1000.0 > self.slo_p99_ms:
                    req.slo_violation = True
                    self._counters.inc("serving_slo_violations",
                                       job=self.job)
                if req.trace_id or req.slo_violation:
                    self._emit_request_spans(req)
                if self._on_done is not None:
                    self._on_done(req)

    def _emit_request_spans(self, req: ServeRequest) -> None:
        """Turn one request's phase timestamps into a trace span tree
        (admit → queue → batch → forward → respond under one
        ``serving_request`` root).  Emitted for requests carrying a
        propagated trace_id and for SLO violations, each phase and the
        whole request also attached to its histogram bucket as a trace-id
        exemplar."""
        tracer = get_tracer()
        tid = req.trace_id or new_trace_id()
        root = tracer.record_span(
            "serving_request", "serving", req.t_enqueue, req.t_done,
            trace_id=tid, parent_id=req.parent_span,
            replica=self.name, job=self.job,
            request_id=req.id, latency_ms=round(req.latency_s * 1e3, 3),
            slo_violation=req.slo_violation,
            queue_ms=round(max(req.t_admit - req.t_queued, 0.0) * 1e3, 3),
            forward_ms=round((req.t_forward1 - req.t_forward0) * 1e3, 3))
        for phase, t0, t1 in (
                ("admit", req.t_enqueue, req.t_queued),
                ("queue", req.t_queued, req.t_admit),
                ("batch", req.t_admit, req.t_forward0),
                ("forward", req.t_forward0, req.t_forward1),
                ("respond", req.t_forward1, req.t_done)):
            tracer.record_span(f"serving_request.{phase}", "serving",
                               t0, max(t1, t0), trace_id=tid,
                               parent_id=root)
            self._shist.put_exemplar(max(t1 - t0, 0.0), tid, phase=phase)
        self._hist.put_exemplar(req.latency_s, tid, job=self.job)


#: completions a ServingFleet keeps for its windowed stats
STATS_WINDOW = 2048


class ServingFleet:
    """The replica set behind one serving Service: least-queue routing,
    hint→prewarm scale-up, graceful drain scale-down, rolling reloads.

    ``apply_fn(model, batch) -> outputs`` is the forward, ``init_params``
    the model (an ``nn.Module``, copied for each replica), ``example_row``
    one request's arrays (no batch dim).

    A replica of one device (``chips_per_replica`` 1) is a thread holding a
    world-1 :class:`ElasticServer`: each replica thread runs outside any
    process group this process joined (``mesh.outside_group``), so a fleet
    may share a process with an SPMD trainer rank.  A replica of n > 1
    devices is n rank processes (:class:`RankGroupServer`), each holding
    the SPMD :class:`ElasticServer` over the replica's own process group,
    the batch split over them; the fleet's process joins no group for
    them.  Replica ``slot`` takes devices as the JAX package's fleet
    slices them: ``devices[lo:lo+n]`` with ``lo = slot·n mod (len − n +
    1)``, at most ``len // n`` replicas, when ``devices`` is given;
    otherwise the cards of ``device``'s kind (``cuda:(slot·n + j) mod
    count`` when ``device`` is CUDA without an index, else ``device``),
    wrapping without bound.  On one card every replica and rank shares it,
    which proves the protocol, not added capacity."""

    def __init__(
        self,
        apply_fn: Callable[[Any, Any], Any],
        init_params: Any,
        example_row: tuple,
        *,
        job: str = "job",
        max_batch_size: int = 8,
        max_queue_ms: float = 2.0,
        slo_p99_ms: float = 0.0,
        drain_timeout_s: float = 30.0,
        chips_per_replica: int = 1,
        device="cuda",
        devices: Optional[Sequence] = None,
        kv=None,
    ) -> None:
        self.apply_fn = apply_fn
        self.init_params = init_params
        self.job = job
        self.max_batch_size = max(int(max_batch_size), 1)
        self.max_queue_ms = float(max_queue_ms)
        self.slo_p99_ms = float(slo_p99_ms)
        self.drain_timeout_s = float(drain_timeout_s)
        self.device = resolve(device)
        self.chips_per_replica = max(int(chips_per_replica), 1)
        self._devices = ([resolve(d) for d in devices] if devices is not None
                         else None)
        self._kv = kv
        #: the fixed batch: example_row stacked to max_batch_size
        self.example_batch = tuple(
            np.stack([np.asarray(a)] * self.max_batch_size)
            for a in example_row)
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self._rr = itertools.count()
        #: routable replicas (the active set the autoscaler dials)
        self._replicas: list[ServingReplica] = []
        #: hint-built standbys: building/warmed but NOT routable — a
        #: later scale_to() activates them (the prewarm hit)
        self._hinted: list[ServingReplica] = []
        #: lifetime count of drained/failed replicas — references are
        #: DROPPED once stopped (each retired replica holds a full set
        #: of weights on its device; retaining them turns a
        #: scale-oscillating fleet into a slow OOM)
        self.replicas_retired = 0
        #: (weights, generation) a replica must hold before it becomes
        #: routable: set by every rolling reload under the fleet lock, in
        #: the same section that picks the replicas it swaps, so a replica
        #: that joins later serves the fleet's CURRENT generation, not the
        #: boot weights
        self._gen: tuple[Any, int] = (init_params, 0)
        self.generation = 0
        self.prewarm_hits = 0
        self.prewarm_misses = 0
        #: rolling completion window: (t_done, latency_s)
        self._window: "collections.deque[tuple[float, float]]" = (
            collections.deque(maxlen=STATS_WINDOW))
        self._watcher: Optional[_WeightWatcher] = None
        self._metrics_srv = None
        self._addr_publisher = None
        self.register_metrics()

    # -- replica construction ----------------------------------------------

    def _slot_device(self, slot: int) -> torch.device:
        if self.device.type == "cuda" and self.device.index is None:
            return torch.device("cuda", slot % torch.cuda.device_count())
        return self.device

    def _max_replicas(self) -> Optional[int]:
        """The replicas ``devices`` holds (None: no bound)."""
        if self._devices is None:
            return None
        return max(len(self._devices) // self.chips_per_replica, 1)

    def _slot_devices(self, slot: int) -> list:
        n = self.chips_per_replica
        if self._devices is None:
            return [self._slot_device(slot * n + j) for j in range(n)]
        lo = (slot * n) % max(len(self._devices) - n + 1, 1)
        return [self._devices[(lo + j) % len(self._devices)]
                for j in range(n)]

    def _new_replica(self, slot: int) -> ServingReplica:
        devs = self._slot_devices(slot)
        params = self.init_params
        name = f"{self.job}/r{slot}"
        r: Optional[ServingReplica] = None

        def build():
            if len(devs) > 1:
                return RankGroupServer(self.apply_fn, params,
                                       self.example_batch, devs, name=name,
                                       on_death=r.rank_died)
            return ElasticServer(self.apply_fn, copy.deepcopy(params),
                                 devices=devs)

        r = ServingReplica(
            name=name, build=build,
            example_batch=self.example_batch,
            max_batch_size=self.max_batch_size,
            max_queue_ms=self.max_queue_ms, job=self.job,
            slo_p99_ms=self.slo_p99_ms, on_done=self._record)
        r.slot = slot
        r.devices = devs
        return r.start()

    def _capped(self, target: int) -> int:
        cap = self._max_replicas()
        return int(target) if cap is None else min(int(target), cap)

    def _next_slot(self) -> int:
        """Smallest device slot no live replica occupies — a drained
        replica's device is reusable by the next scale-up."""
        used = {getattr(r, "slot", -1) for r in self._replicas + self._hinted}
        slot = 0
        while slot in used:
            slot += 1
        return slot

    # -- scaling ------------------------------------------------------------

    def hint(self, target: int) -> int:
        """The autoscaler's plan hint: start building (and warming up)
        the replicas a scale-up to ``target`` will need, BEFORE the
        actuation/pods/traffic move — the serving twin of
        ``ElasticTrainer.prewarm``.  Returns how many builds started.
        Never blocks; never touches routing."""
        started = 0
        with self._lock:
            target = self._capped(target)
            want = target - len(self._replicas) - len(self._hinted)
            for _ in range(max(want, 0)):
                self._hinted.append(self._new_replica(self._next_slot()))
                started += 1
        if started:
            get_counters().inc("serving_prewarms", started, job=self.job)
            log.info("serving prewarm hint", job=self.job, target=target,
                     builds_started=started)
        return started

    def scale_to(self, target: int, wait_ready_s: float = 120.0) -> int:
        """Actuate the replica count.  Growing first adopts hint-built
        standbys (each one a recorded ``serving_prewarm_hit`` — its
        build started back at plan time, off the traffic path), then
        builds the remainder inline (misses).  Shrinking drains the
        newest replicas gracefully: routing stops immediately, queued
        requests are served out, nothing is dropped.  Returns the new
        active count."""
        to_stop: list[ServingReplica] = []
        adopted_total = 0
        with self._lock:
            target = max(1, self._capped(target))
            # a replica that died (a wide replica's rank) is no capacity:
            # it leaves first, so the shrink below drains live ones only
            dead = [r for r in self._replicas if r.state == STOPPED]
            for r in dead:
                self._replicas.remove(r)
                self.replicas_retired += 1
            while len(self._replicas) > target:
                to_stop.append(self._replicas.pop())
        # fill-then-prune, bounded: a replica whose background build
        # FAILED (state STOPPED) must not be counted as active capacity
        # forever — prune it and retry the slot a bounded number of
        # times; persistent failures leave the fleet under target, which
        # the scaler observes (replicas_active < target) and re-plans.
        for _attempt in range(3):
            adopted: list[ServingReplica] = []
            with self._lock:
                params, gen = self._gen
                while len(self._replicas) < target:
                    if self._hinted:
                        r = self._hinted.pop(0)
                        if r.state == STOPPED:
                            # the standby's build already failed: not a
                            # prewarm hit — drop it and fill the slot
                            # from the next source
                            self.replicas_retired += 1
                            get_counters().inc(
                                "serving_replica_build_failures",
                                job=self.job)
                            continue
                        self.prewarm_hits += 1
                        get_counters().inc("serving_prewarm_hits",
                                           job=self.job)
                    else:
                        r = self._new_replica(self._next_slot())
                        self.prewarm_misses += 1
                        get_counters().inc("serving_prewarm_misses",
                                           job=self.job)
                    if r.generation != gen:
                        # staged BEFORE it joins the routable set: it
                        # takes no traffic until the weights have landed
                        r.stage_weights(params, gen)
                    self._replicas.append(r)
                    adopted.append(r)
            for r in adopted:
                # the ready gate: traffic only routes to a replica once
                # its warm-up has run and it holds the fleet's generation
                # — with a hint's head start this wait is ~0; without one
                # it is the inline build, which still never rides a
                # REQUEST (existing replicas keep serving; the router
                # skips BUILDING ones)
                if r.wait_ready(wait_ready_s):
                    r.wait_weights(self.drain_timeout_s)
            adopted_total += len(adopted)
            with self._lock:
                dead = [r for r in self._replicas if r.state == STOPPED]
                for r in dead:
                    self._replicas.remove(r)
                    self.replicas_retired += 1
            for r in dead:
                log.warn("serving replica build failed; slot retried",
                         replica=r.name)
                get_counters().inc("serving_replica_build_failures",
                                   job=self.job)
            if not dead:
                break
        for r in to_stop:
            r.stop(drain=True, timeout_s=self.drain_timeout_s)
            with self._lock:
                self.replicas_retired += 1
        if to_stop or adopted_total:
            get_tracer().instant(
                "serving_scaled", category="serving", job=self.job,
                target=target, adopted=adopted_total,
                drained=len(to_stop), prewarm_hits=self.prewarm_hits)
        return len(self._replicas)

    # -- routing ------------------------------------------------------------

    def submit(self, payload: tuple, trace_id: Optional[str] = None,
               parent_span: Optional[str] = None) -> ServeRequest:
        """Admit one request: routed to the READY replica with the
        shortest queue (a building/reloading replica receives no new
        traffic; with none ready — transient, e.g. a single replica
        mid-build — the request queues on the least-loaded live replica
        and waits rather than failing).  ``trace_id`` makes the request's
        phase spans first-class trace events; ``parent_span`` parents
        their root (the LB's admission span)."""
        req = ServeRequest(payload=tuple(np.asarray(a) for a in payload),
                           id=next(self._ids),
                           t_enqueue=time.perf_counter(),
                           trace_id=trace_id, parent_span=parent_span)
        while True:
            with self._lock:
                live = [r for r in self._replicas if r.state != STOPPED]
                ready = [r for r in live if r.routable()]
                pool = ready or live
                if not pool:
                    raise RequestDropped(f"fleet {self.job} has no replicas")
                # round-robin among equal queue depths so single-burst
                # traffic spreads instead of piling on replica 0
                k = next(self._rr)
                target = min(
                    range(len(pool)),
                    key=lambda i: (pool[i].queue_depth(),
                                   (i - k) % len(pool)))
                replica = pool[target]
            try:
                replica.submit(req)
                return req
            except RequestDropped:
                continue  # raced a stop; re-route

    def _record(self, req: ServeRequest) -> None:
        with self._lock:
            self._window.append((req.t_done, req.latency_s))

    # -- observation --------------------------------------------------------

    def replicas(self) -> list[ServingReplica]:
        """The active replicas (a copy of the list)."""
        with self._lock:
            return list(self._replicas)

    def replicas_ready(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if r.routable())

    def replicas_active(self) -> int:
        with self._lock:
            return len(self._replicas)

    def queue_depth(self) -> int:
        with self._lock:
            return sum(r.queue_depth() for r in self._replicas)

    def stats(self, window_s: float = 10.0) -> FleetStats:
        """Windowed p50/p99/qps over recent completions — the signal the
        SLO policy scales on."""
        now = time.perf_counter()
        with self._lock:
            window = list(self._window)
            saturated = len(window) == self._window.maxlen
            ready, active = (sum(1 for r in self._replicas if r.routable()),
                             len(self._replicas))
            depth = sum(r.queue_depth() for r in self._replicas)
        recent = [(t, lat) for t, lat in window if now - t <= window_s]
        if recent:
            lats = np.sort(np.asarray([lat for _, lat in recent]))
            p50 = float(lats[int(0.50 * (len(lats) - 1))]) * 1000.0
            p99 = float(lats[int(0.99 * (len(lats) - 1))]) * 1000.0
        else:
            p50 = p99 = 0.0
        # QPS denominator: normally the window length — but when the
        # bounded deque EVICTED completions that were still inside the
        # window (high load), the span the kept entries cover is the
        # honest denominator
        denom = window_s
        if saturated and recent and (now - window[0][0]) <= window_s:
            denom = max(now - recent[0][0], 1e-3)
        return FleetStats(
            p50_ms=round(p50, 3), p99_ms=round(p99, 3),
            qps=round(len(recent) / denom, 2), queue_depth=depth,
            replicas_ready=ready, replicas_active=active,
            requests_windowed=len(recent))

    def register_metrics(self, registry=None) -> None:
        reg = registry if registry is not None else get_registry()
        reg.gauge_fn("serving_replicas_ready", self.replicas_ready,
                     help="replicas currently routable", job=self.job)
        reg.gauge_fn("serving_replicas_active", self.replicas_active,
                     help="replicas in the active set", job=self.job)
        reg.gauge_fn("serving_fleet_queue_depth", self.queue_depth,
                     help="queued requests across the fleet", job=self.job)

    def serve_metrics(self, port: int = 0, replica: Optional[str] = None,
                      ttl_s: Optional[float] = None):
        """Serve this process's ``/metrics`` + ``/healthz`` on every
        interface (shared registry — every ``edl_serving_*`` series this
        fleet records) and, when a coordinator KV client was given
        (``kv=``), publish the bound address under the TTL'd
        ``serving-metrics-addr/<job>/<replica>`` key.  Returns the HTTP
        server (also shut down by :meth:`stop`)."""
        import os
        import socket

        from edl_tpu_torch.observability.health import serve_health
        from edl_tpu_torch.observability.scrape import (
            DEFAULT_ADDR_TTL_S,
            SERVING_METRICS_ADDR_PREFIX,
            AddrPublisher,
            publish_host,
        )

        self._metrics_srv = serve_health(
            port, {"replicas_ready": lambda: self.replicas_ready() >= 1})
        bound = self._metrics_srv.server_address[1]
        if self._kv is not None:
            rep = replica or f"{socket.gethostname()}-{os.getpid()}"
            key = f"{SERVING_METRICS_ADDR_PREFIX}{self.job}/{rep}"
            self._addr_publisher = AddrPublisher(
                self._kv, key, f"{publish_host()}:{bound}",
                ttl_s=ttl_s if ttl_s is not None else DEFAULT_ADDR_TTL_S)
            self._addr_publisher.start()
            log.info("serving metrics published", job=self.job, key=key,
                     port=bound)
        return self._metrics_srv

    # -- rolling weight reloads --------------------------------------------

    def rolling_reload(self, params: Any, generation: int) -> int:
        """Swap every active replica to ``generation`` (``params``: a
        module, or its tensors by parameter name) ONE AT A TIME behind the
        ready gate: while a replica reloads it takes no new traffic (peers
        absorb it), its queued requests are served before the swap
        applies, and in-flight iterations always finish on the weights
        they started with — zero dropped requests by construction.  A
        single-replica fleet swaps in place (the iteration boundary is the
        gate).  Returns replicas swapped."""
        swapped = 0
        with self._lock:
            self._gen = (params, generation)
            replicas = list(self._replicas)
        for r in replicas:
            if r.state == STOPPED:
                continue
            with self._lock:
                others_ready = sum(1 for o in self._replicas
                                   if o is not r and o.routable())
            # the gate is a CAS under the REPLICA's lock: a concurrent
            # stop()/drain that won the state must not be clobbered
            gate = bool(others_ready) and r.gate()
            # wait for the gated replica's queue to empty so the swap
            # lands between iterations with nothing of the old
            # generation left waiting
            deadline = time.perf_counter() + self.drain_timeout_s
            while gate and r.queue_depth() > 0 \
                    and time.perf_counter() < deadline:
                time.sleep(0.001)
            if r.swap_weights(params, generation,
                              timeout_s=self.drain_timeout_s):
                swapped += 1
            if gate:
                r.ungate()
        self.generation = generation
        if self._kv is not None:
            try:
                self._kv.kv_set(SERVING_GEN_KEY.format(job=self.job),
                                str(generation).encode())
            except Exception as exc:  # KV is observability here, not truth
                log.warn("serving generation publish failed", job=self.job,
                         error=str(exc)[:120])
        log.info("rolling reload complete", job=self.job,
                 generation=generation, replicas=swapped)
        return swapped

    def reload_from_lineage(self, checkpointer) -> Optional[int]:
        """Roll onto the newest VERIFIED step of a training job's lineage
        (an :class:`~edl_tpu_torch.runtime.checkpoint.ElasticCheckpointer`
        whose steps hold ``{"params": model}``) if it is newer than what
        the fleet serves: the step is chosen and checked as
        :meth:`DecodeFleet.reload_from_lineage` chooses it, restored into a
        live replica's host copy of the model
        (:meth:`ElasticServer.params_host`) and swapped in by
        :meth:`rolling_reload`.  Returns the generation rolled to, or None
        when already current or skipped."""
        step = _lineage_step(checkpointer, self.generation, self.job)
        if step is None:
            return None
        with self._lock:
            template = next((r.server for r in self._replicas
                             if r.server is not None), None)
        if template is None:
            return None
        restored = checkpointer.restore({"params": template.params_host()},
                                        step=step)
        if not _landed(checkpointer, step, self.job):
            return None
        self.rolling_reload(restored["params"], step)
        return step

    def watch_lineage(self, checkpointer, poll_s: float = 5.0,
                      scan_backstop: int = 1) -> "_WeightWatcher":
        """Start the reload driver, as :meth:`DecodeFleet.watch_lineage`
        does: a thread that long-polls ``serving-gen/<job>`` when the
        fleet has a coordinator (``kv=``), else sleeps ``poll_s``, and
        calls :meth:`reload_from_lineage`; :meth:`stop` stops it."""
        self._watcher = _WeightWatcher(self, checkpointer, poll_s,
                                       scan_backstop=scan_backstop)
        self._watcher.start()
        return self._watcher

    # -- teardown -----------------------------------------------------------

    def stop(self, drain: bool = True) -> None:
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher = None
        if self._addr_publisher is not None:
            self._addr_publisher.stop()  # best-effort kv_del of the key
            self._addr_publisher = None
        if self._metrics_srv is not None:
            self._metrics_srv.shutdown()
            self._metrics_srv = None
        with self._lock:
            replicas = self._replicas + self._hinted
            self._replicas, self._hinted = [], []
        for r in replicas:
            r.stop(drain=drain, timeout_s=self.drain_timeout_s)


# -- traffic generation (harness) -----------------------------------------


class PoissonTraffic:
    """Seeded Poisson (exponential inter-arrival) open-loop traffic
    against a fleet: arrivals don't wait for replies, so a latency
    regression shows up as queue growth and p99, exactly like
    production."""

    def __init__(self, fleet: ServingFleet, make_row: Callable[[int], tuple],
                 qps: float, seed: int = 0) -> None:
        self.fleet = fleet
        self.make_row = make_row
        self.qps = float(qps)
        self.rng = np.random.default_rng(seed)
        self.sent: list[ServeRequest] = []

    def run(self, duration_s: float) -> list[ServeRequest]:
        """Fire requests for ``duration_s``; returns them all (callers
        wait()/assert).  Runs open-loop on the calling thread."""
        t_end = time.perf_counter() + duration_s
        i = len(self.sent)
        next_at = time.perf_counter()
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return self.sent
            if now < next_at:
                time.sleep(min(next_at - now, 0.005))
                continue
            self.sent.append(self.fleet.submit(self.make_row(i)))
            i += 1
            next_at += float(self.rng.exponential(1.0 / self.qps))

    def await_all(self, timeout_s: float = 30.0) -> dict:
        """Wait for every sent request; returns the closed-loop tally
        (served / dropped / errors / timeouts / latencies).  One SHARED
        condition wait: every request signals a common counter via its
        done-callback, so a wedged tail costs one deadline wait total."""
        pending = [r for r in self.sent if not r._done.is_set()]
        remaining = [len(pending)]
        cond = threading.Condition()

        def on_done(_req) -> None:
            with cond:
                remaining[0] -= 1
                if remaining[0] <= 0:
                    cond.notify_all()

        for req in pending:
            req.add_done_callback(on_done)
        deadline = time.perf_counter() + timeout_s
        with cond:
            while remaining[0] > 0:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                cond.wait(left)
        served = dropped = errors = timeouts = 0
        lats: list[float] = []
        for req in self.sent:
            if not req._done.is_set():
                timeouts += 1
            elif req.error is None:
                served += 1
                lats.append(req.latency_s)
            elif isinstance(req.error, RequestDropped):
                dropped += 1
            else:
                errors += 1
        lat = np.sort(np.asarray(lats)) if lats else np.asarray([0.0])
        return {
            "sent": len(self.sent), "served": served,
            "dropped": dropped, "errors": errors, "timeouts": timeouts,
            "p50_ms": round(float(lat[int(0.50 * (len(lat) - 1))]) * 1e3, 3),
            "p99_ms": round(float(lat[int(0.99 * (len(lat) - 1))]) * 1e3, 3),
            "max_ms": round(float(lat[-1]) * 1e3, 3),
        }


# -- pod entrypoint ----------------------------------------------------------


def serve_main(env=None, device="cuda") -> int:
    """Run one replica's model server from the EDL_SERVING_* env contract,
    on ``device`` (the card unless the caller asks for another).

    Loads the newest verified checkpoint generation from
    ``EDL_SERVING_MODEL_DIR`` (an ``ElasticCheckpointer`` lineage holding
    ``{"params": model}``), builds the model named by ``EDL_SERVING_MODEL``
    (``mlp:IN,HID..,OUT``), serves JSON ``POST /predict`` on
    ``EDL_SERVING_PORT``, watches the lineage for rolling reloads, and
    answers ``/healthz`` 503 until the replica's warm-up forward has run —
    the readiness gate the pod template probes.  SIGTERM drains the fleet
    and returns 0.  ``EDL_SERVING_FRONTDOOR`` picks the front door: the
    default ``async`` is :class:`~edl_tpu_torch.runtime.frontdoor.
    FrontDoor` over a :class:`~edl_tpu_torch.runtime.frontdoor.FleetApp`
    (keep-alive, pipelining, the raw-f32 fast path beside JSON);
    ``legacy`` is the thread-per-connection HTTP/1.1 server; any other
    value raises ``ValueError`` before a port is bound."""
    import json as _json
    import os
    import signal
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from edl_tpu_torch.coord.client import client_from_env
    from edl_tpu_torch.models import mlp
    from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer

    env = os.environ if env is None else env
    frontdoor_kind = env.get("EDL_SERVING_FRONTDOOR", "async")
    if frontdoor_kind not in ("async", "legacy"):
        # before anything is bound or made: a typo must not silently pick
        # a front door
        raise ValueError(f"EDL_SERVING_FRONTDOOR={frontdoor_kind!r}: the "
                         "front doors are 'async' and 'legacy'")
    model_dir = env.get("EDL_SERVING_MODEL_DIR", "")
    if not model_dir:
        print("error: EDL_SERVING_MODEL_DIR not set (the jobparser emits "
              "it from spec.server.model_dir)")
        return 2
    model = env.get("EDL_SERVING_MODEL", "mlp:16,32,4")
    kind, _, shape = model.partition(":")
    if kind != "mlp":
        print(f"error: unknown EDL_SERVING_MODEL kind {kind!r}")
        return 2
    sizes = [int(x) for x in shape.split(",")]

    ckpt = ElasticCheckpointer(model_dir)
    template = {"params": mlp.MLP(sizes, device="cpu", seed=0)}
    step = ckpt.latest_verified_step()
    params = (ckpt.restore(template, step=step)["params"]
              if step is not None else template["params"])
    job = (f"{env.get('EDL_NAMESPACE', 'default')}/"
           f"{env.get('EDL_JOB_NAME', 'serving')}")
    # coordinator KV (optional): where the replica publishes its /metrics
    # address and the lineage watcher long-polls serving-gen/<job> — set
    # EDL_COORD_ENDPOINT (host:port) to enable
    kv = client_from_env(env, disabled="metrics address not published")
    fleet = ServingFleet(
        lambda p, b: mlp.apply(p, b[0]), params,
        example_row=(np.zeros((sizes[0],), np.float32),),
        job=job, kv=kv, device=device,
        max_batch_size=int(env.get("EDL_SERVING_MAX_BATCH", "8")),
        max_queue_ms=float(env.get("EDL_SERVING_MAX_QUEUE_MS", "2.0")),
        slo_p99_ms=float(env.get("EDL_SERVING_SLO_P99_MS", "0")),
        drain_timeout_s=float(env.get("EDL_SERVING_DRAIN_S", "30")))
    fleet.generation = step or 0
    fleet.scale_to(1)
    poll_s = float(env.get("EDL_SERVING_RELOAD_POLL_S", "5"))
    if poll_s > 0:
        # EDL_SERVING_SCAN_BACKSTOP > 1 trusts the serving-gen KV key as
        # the reload signal and scans the lineage only every N cycles
        fleet.watch_lineage(
            ckpt, poll_s,
            scan_backstop=int(env.get("EDL_SERVING_SCAN_BACKSTOP", "1")))

    health_port = int(env.get("EDL_HEALTH_PORT", "8080"))
    health = None
    if health_port >= 0:
        # the readiness gate AND the scrape endpoint, its bound address
        # published to coordinator KV when a coordinator is reachable
        health = fleet.serve_metrics(
            health_port,
            replica=env.get("EDL_POD_NAME") or None,
            ttl_s=float(env.get("EDL_SERVING_METRICS_TTL_S", "30")))

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 with Content-Length on every reply = keep-alive; the
        # read timeout bounds how long an idle keep-alive client may pin
        # its thread
        protocol_version = "HTTP/1.1"
        timeout = 60

        def do_GET(self):  # noqa: N802 (http.server casing)
            if self.path != "/healthz":
                self.send_error(404)
                return
            ready = fleet.replicas_ready() >= 1
            self.send_response(200 if ready else 503)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_POST(self):  # noqa: N802 (http.server casing)
            if self.path != "/predict":
                self.send_error(404)
                return
            try:
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", "0")))
                row = _json.loads(body.decode())["inputs"]
                # X-EDL-Trace-Id rides into the request's phase spans and
                # back out on the reply
                trace_id = self.headers.get("X-EDL-Trace-Id") or None
                req = fleet.submit((np.asarray(row, np.float32),),
                                   trace_id=trace_id)
                out = req.wait(timeout=30.0)
                payload = _json.dumps({
                    "outputs": np.asarray(out).tolist(),
                    "generation": fleet.generation,
                    "latency_ms": round(req.latency_s * 1000, 3),
                }).encode()
            except Exception as exc:
                self.send_error(500, str(exc)[:120])
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            if trace_id:
                self.send_header("X-EDL-Trace-Id", trace_id)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):  # quiet; metrics carry the signal
            pass

    port = int(env.get("EDL_SERVING_PORT", "8500"))
    srv = door = None
    if frontdoor_kind == "legacy":
        srv = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        bound = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    else:
        from edl_tpu_torch.runtime.frontdoor import FleetApp, FrontDoor

        door = FrontDoor(FleetApp(fleet, sizes[0]), port=port, job=job)
        door.start()
        bound = door.port
    log.info("model server ready", job=job, generation=fleet.generation,
             port=bound, frontdoor=frontdoor_kind)
    # machine-parseable ready marker (harnesses wait on it to learn an
    # ephemeral port)
    print(f"model server ready port={bound} frontdoor={frontdoor_kind} "
          f"generation={fleet.generation}", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not the main thread
    try:
        while not stop.wait(0.5):
            pass
    finally:
        if srv is not None:
            srv.shutdown()
        if door is not None:
            door.stop()
        # graceful: finish the queue, drop nothing; also unpublishes the
        # metrics address and stops /metrics
        fleet.stop(drain=True)
        if health is not None:
            health.shutdown()
        if kv is not None:
            try:
                kv.close()
            except Exception:
                pass
        ckpt.close()
    return 0


if __name__ == "__main__":
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description="one model server replica from the EDL_SERVING_* env")
    parser.add_argument("--device", default="cuda")
    sys.exit(serve_main(device=parser.parse_args().device))
