"""Token-level decode serving — the decode half of
edl_tpu.runtime.serving, on one torch device.

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
current stream; it reads the device once an iteration (the argmax of every
slot).  Replicas take a ``device`` (CUDA by default); a fleet places all
of its replicas on one device.

Scrape names (``edl_`` prefix): ``serving_ttft_seconds`` /
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
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np

from edl_tpu_torch.models import llama
from edl_tpu_torch.observability import calib
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import (
    SERVING_TPOT_BUCKETS,
    SERVING_TTFT_BUCKETS,
    get_registry,
)
from edl_tpu_torch.observability.tracing import get_tracer
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
    ``on_handoff(sess, host_kv)``."""

    def __init__(self, name: str, params: Any, cfg, *, job: str = "job",
                 role: str = "decode", slots: int = 4,
                 prefill_chunk: int = 16, kv_blocks: int = 64,
                 kv_block_size: int = 16, max_blocks_per_session: int = 8,
                 eos_id: Optional[int] = None,
                 scheduler: Optional[TokenScheduler] = None,
                 ttft_slo_ms: float = 0.0, tpot_slo_ms: float = 0.0,
                 spec_tokens: int = 0, spec_ngram: int = 3,
                 device="cuda", kv_quantize: Optional[str] = None,
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
                                quantize=kv_quantize)
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
                                   device=self.pool.device)
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
        :meth:`resume` (or a stop) releases it."""
        with self._cond:
            if self.state == STOPPED:
                return False
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
    wrap-around when a host has fewer devices than replicas."""

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
                 device="cuda") -> None:
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
        self._wfq_weights = dict(wfq_weights) if wfq_weights else None
        self._decode_per_prefill = int(decode_per_prefill)
        self._tpot_budget_ms = float(tpot_budget_ms)
        self.max_queued_sessions = int(max_queued_sessions)
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

    def _new_replica(self, role: str) -> DecodeReplica:
        idx = next(self._rep_seq)
        r = DecodeReplica(
            f"{self.job}/{role[0]}{idx}", self._gen_params, self.cfg,
            job=self.job, role=role, device=self.device,
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
                k = payload.arrays["k"]
                # what the host path would ship for this session: the
                # trimmed dequantized f32 pair, off the device and back
                trimmed = (2 * int(k.shape[0]) * int(payload.length)
                           * int(k.shape[3]) * int(k.shape[4]) * 4)
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
        refresh = getattr(checkpointer, "refresh", None)
        if refresh is not None:
            refresh()
        step = checkpointer.latest_verified_step()
        if step is None or step <= self.generation:
            return None
        verified_fn = getattr(checkpointer, "manifest_verified", None)
        verified = verified_fn(step) if verified_fn is not None else True
        if verified is None:
            return None
        if verified is False:
            log.warn("decode reload SKIPPED unverified generation",
                     job=self.job, generation=step)
            self._counters.inc("serving_reload_skipped_unverified")
            return None
        restored = checkpointer.restore(
            {"params": llama.param_template(self.cfg)}, step=step)
        landed = getattr(checkpointer, "last_restored_step", step)
        if landed is not None and landed != step:
            log.warn("decode reload SKIPPED generation that failed "
                     "verification at restore", job=self.job,
                     generation=step, landed=landed)
            self._counters.inc("serving_reload_skipped_unverified")
            return None
        params = llama.as_decode_params(restored.pop("params"), self.device,
                                        self.cfg)
        self.rolling_reload(params, step)
        return step

    def watch_lineage(self, checkpointer,
                      poll_s: float = 5.0) -> "_WeightWatcher":
        """Start the reload driver: a thread that, every ``poll_s``, calls
        :meth:`reload_from_lineage` (a failure is logged and the next poll
        tries again).  :meth:`stop` stops it."""
        self._watcher = _WeightWatcher(self, checkpointer, poll_s)
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

    def chips(self) -> int:
        """Devices backing active replicas, one each (a shared device
        counted once per replica, as the JAX package counts wrapped
        slices)."""
        with self._lock:
            return sum(1 for r in self._replicas if r.state != STOPPED)

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


class _WeightWatcher(threading.Thread):
    """:meth:`DecodeFleet.watch_lineage`'s thread: sleeps ``poll_s`` (at
    least 0.1 s), then scans the lineage, until :meth:`stop`.  This is the
    reference watcher's path without a coordinator; its long-poll of the
    fleet's generation key, which skips scans while nothing changed, waits
    for the port's coordinator (ROADMAP.md, queue 1 item 4)."""

    def __init__(self, fleet: DecodeFleet, checkpointer,
                 poll_s: float) -> None:
        super().__init__(name=f"serving-reload-{fleet.job}", daemon=True)
        self.fleet = fleet
        self.checkpointer = checkpointer
        self.poll_s = max(float(poll_s), 0.1)
        # not named _stop: threading.Thread has a _stop method
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(self.poll_s):
            try:
                self.fleet.reload_from_lineage(self.checkpointer)
            except Exception as exc:  # keep watching; the step is skipped
                log.warn("lineage reload failed", job=self.fleet.job,
                         error=str(exc)[:200])

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=30)
