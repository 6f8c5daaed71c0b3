"""Elastic paged KV-cache pool — the port of edl_tpu.runtime.kvcache.

A session's K/V history lives in fixed-size blocks of one device cache
(:func:`edl_tpu_torch.models.llama.init_cache`); a session owns a *list*
of blocks, so any free block serves any session.

* **Refcounted sharing.**  Sessions with a common prompt prefix share the
  sealed (full) blocks covering it (the prefix cache); a forked session
  shares its parent's chain copy-on-write (:meth:`KVBlockPool.make_writable`
  copies a block on the first divergent write).  Sealed blocks whose last
  owner left stay in a reclaimable LRU so later identical prompts still hit.
* **Bounded admission.**  Allocation failure is a typed
  :class:`KVPoolExhausted` (the serving layer's 429), never an OOM.
* **Accounted.**  :meth:`KVBlockPool.total_bytes` is the pool's residency.
* **Evacuation.**  :meth:`KVBlockPool.export_session_device` →
  :meth:`KVBlockPool.reserve_import_device` /
  :meth:`KVBlockPool.apply_import_device` moves a session's blocks device
  to device, priced by :func:`plan_move` (``kv_migration_bytes{path=
  "ici"}``); :meth:`KVBlockPool.export_session` /
  :meth:`KVBlockPool.import_session` go through the host (``path="host"``)
  and convert between storage modes.

A pool lives on one ``torch.device``: the JAX package's heads- or
pages-sharded pool over several devices is not ported.

Scrape names: ``edl_serving_kv_blocks_used`` / ``_total`` / ``_cached``
(gauges, labeled ``job=``/``replica=``),
``edl_serving_kv_admission_rejects_total`` / ``edl_kv_prefix_hits_total``
/ ``edl_kv_prefix_tokens_saved_total`` / ``edl_kv_cow_copies_total`` /
``edl_kv_migration_bytes_total{path="ici"|"host"}`` (counters).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from edl_tpu_torch.models import llama
from edl_tpu_torch.observability import calib
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.metrics import get_registry


class KVPoolExhausted(RuntimeError):
    """Typed bounded-admission signal: the pool cannot hold the requested
    tokens right now.  A full pool sheds; it never OOMs."""


class SessionUnknown(KeyError):
    """The pool holds no blocks for this session id."""


@dataclass(frozen=True)
class TransferPlan:
    """The byte accounting of one move, under the names of the JAX
    package's ``ReshardPlan``: bytes already on the destination
    (``bytes_stay``), bytes a device-to-device hop fetches from a device
    that stays (``bytes_ici``), and bytes whose only source is a device
    leaving the move's destination (``bytes_dcn``)."""

    bytes_total: int
    bytes_stay: int
    bytes_ici: int
    bytes_dcn: int


def plan_move(arrays: dict, dst_device) -> TransferPlan:
    """Price moving ``arrays`` (each whole on one device) whole onto
    ``dst_device``: what ``plan_reshard`` gives for a one-device to
    one-device move — ``bytes_stay`` when source and destination are one
    device, else ``bytes_dcn`` (the source device is not on the
    destination's mesh)."""
    total = stay = dcn = 0
    for t in arrays.values():
        nbytes = t.numel() * t.element_size()
        total += nbytes
        if llama.same_device(t.device, dst_device):
            stay += nbytes
        else:
            dcn += nbytes
    return TransferPlan(total, stay, 0, dcn)


class KVDevicePayload:
    """A D2D migration in flight: one session's blocked cache tensors,
    already gathered off the source pool (new tensors: the source may free
    or decode at once), with the :class:`TransferPlan` of the move."""

    __slots__ = ("arrays", "length", "quantize", "plan")

    def __init__(self, arrays: dict, length: int, quantize: Optional[str],
                 plan: Optional[TransferPlan] = None) -> None:
        self.arrays = arrays
        self.length = int(length)
        self.quantize = quantize
        self.plan = plan

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values())


def payload_to_host(payload: KVDevicePayload, block_size: int,
                    job: str = "job") -> dict:
    """Flatten a D2D payload into the host format (dequantized float32
    ``{"k", "v"}`` CPU tensors of ``[L, length, kv, hd]``) — the fallback
    when no survivor takes the payload device to device.  Accounted as
    ``path="host"`` migration bytes."""
    k = payload.arrays["k"].float().cpu()  # [L, n, bs, kv, hd]
    v = payload.arrays["v"].float().cpu()
    if payload.quantize == "int8":
        k = k * payload.arrays["k_scale"].cpu()[..., None, None]
        v = v * payload.arrays["v_scale"].cpu()[..., None, None]
    L, n = k.shape[0], k.shape[1]
    out = {name: t.reshape(L, n * block_size, *t.shape[3:])
           [:, :payload.length].contiguous()
           for name, t in (("k", k), ("v", v))}
    get_counters().inc("kv_migration_bytes",
                       sum(t.numel() * t.element_size()
                           for t in out.values()),
                       job=job, path="host")
    return out


class KVBlockPool:
    """Block allocator and accounting over one replica's paged device
    cache.  Thread-safe: the serve loop allocates and frees while
    admission probes :meth:`can_admit` from other threads.

    The pool owns the cache tensors (``self.cache``); the entry points of
    :mod:`edl_tpu_torch.models.llama` update them in place.
    ``quantize="int8"`` stores blocks as int8 with per-row scales."""

    def __init__(self, cfg, num_blocks: int, block_size: int,
                 max_blocks_per_session: int, *, job: str = "job",
                 replica: str = "", registry=None, device="cuda",
                 devices=None, quantize: Optional[str] = None) -> None:
        if devices is not None:
            if len(devices) > 1:
                raise NotImplementedError(
                    "a KV pool sharded over several devices is not ported; "
                    "give one device")
            device = devices[0]
        self.cfg = cfg
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_session = int(max_blocks_per_session)
        self.job = job
        self.replica = replica
        self.quantize = quantize
        self.cache = llama.init_cache(cfg, self.num_blocks, self.block_size,
                                      quantize=quantize, device=device)
        #: the pool's one device, as its tensors name it
        self.device = self.cache["k"].device
        self._free: "collections.deque[int]" = collections.deque(
            range(self.num_blocks))
        self._sessions: dict[int, list[int]] = {}
        #: block id → owner count (present only while > 0)
        self._ref: dict[int, int] = {}
        #: sealed-prefix chain key → block id, and its reverse
        self._prefix_index: dict[int, int] = {}
        self._block_key: dict[int, int] = {}
        #: refcount-0 blocks still sealed in the index — reclaimable LRU
        self._cached_free: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._c = get_counters()
        reg = registry if registry is not None else get_registry()
        labels = {"job": job}
        if replica:
            labels["replica"] = replica
        reg.gauge_fn("serving_kv_blocks_used", self.blocks_used,
                     help="KV pool blocks currently owned by sessions",
                     **labels)
        reg.gauge_fn("serving_kv_blocks_total", lambda: self.num_blocks,
                     help="KV pool capacity in blocks", **labels)
        reg.gauge_fn("serving_kv_blocks_cached", self.blocks_cached,
                     help="sealed prefix blocks retained reclaimable",
                     **labels)
        # zero-pre-registration: every series exists from the first scrape
        self._c.inc("serving_kv_admission_rejects", 0, job=job)
        self._c.inc("kv_prefix_hits", 0, job=job)
        self._c.inc("kv_prefix_tokens_saved", 0, job=job)
        self._c.inc("kv_cow_copies", 0, job=job)
        for path in ("ici", "host"):
            self._c.inc("kv_migration_bytes", 0, job=job, path=path)

    # -- observation ---------------------------------------------------------

    def blocks_used(self) -> int:
        """Blocks owned by at least one session (a shared block counts
        once)."""
        with self._lock:
            return (self.num_blocks - len(self._free)
                    - len(self._cached_free))

    def blocks_free(self) -> int:
        """Allocatable blocks: truly free plus reclaimable sealed ones."""
        with self._lock:
            return len(self._free) + len(self._cached_free)

    def blocks_cached(self) -> int:
        with self._lock:
            return len(self._cached_free)

    def sessions(self) -> list[int]:
        with self._lock:
            return list(self._sessions)

    def session_blocks(self, sid: int) -> list[int]:
        with self._lock:
            if sid not in self._sessions:
                raise SessionUnknown(sid)
            return list(self._sessions[sid])

    def blocks_held(self, sid: int) -> int:
        """Blocks owned by ``sid``; 0 for an unknown session."""
        with self._lock:
            return len(self._sessions.get(sid, ()))

    def block_refcount(self, block: int) -> int:
        with self._lock:
            return self._ref.get(block, 0)

    @property
    def bytes_per_block(self) -> int:
        return llama.cache_bytes(self.cfg, 1, self.block_size, self.quantize)

    def total_bytes(self) -> int:
        """Resident bytes of the whole pool."""
        return llama.cache_bytes(self.cfg, self.num_blocks, self.block_size,
                                 self.quantize)

    def used_bytes(self) -> int:
        return self.blocks_used() * self.bytes_per_block

    # -- admission / growth --------------------------------------------------

    def _blocks_for(self, tokens: int) -> int:
        return max(-(-int(tokens) // self.block_size), 1)

    def can_admit(self, tokens: int) -> bool:
        """Would :meth:`ensure_capacity` for a NEW session of ``tokens``
        succeed right now?"""
        need = self._blocks_for(tokens)
        with self._lock:
            return (need <= len(self._free) + len(self._cached_free)
                    and need <= self.max_blocks_per_session)

    def _alloc_locked(self, n: int) -> list[int]:
        """Pop ``n`` fresh blocks (refcount 1 each): truly free first, then
        reclaim sealed LRU blocks, purging their index entries."""
        got: list[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.popleft()
            elif self._cached_free:
                b, _ = self._cached_free.popitem(last=False)
                key = self._block_key.pop(b, None)
                if key is not None and self._prefix_index.get(key) == b:
                    del self._prefix_index[key]
            else:  # the caller checked; defensive
                for g in got:
                    self._free.append(g)
                    del self._ref[g]
                raise KVPoolExhausted("pool empty mid-allocation")
            self._ref[b] = 1
            got.append(b)
        return got

    def _incref_locked(self, b: int) -> None:
        r = self._ref.get(b, 0)
        if r == 0:
            self._cached_free.pop(b, None)  # resurrect a sealed block
        self._ref[b] = r + 1

    def _decref_locked(self, b: int) -> None:
        r = self._ref.get(b, 0) - 1
        if r > 0:
            self._ref[b] = r
            return
        self._ref.pop(b, None)
        key = self._block_key.get(b)
        if key is not None and self._prefix_index.get(key) == b:
            self._cached_free[b] = None  # sealed: retain reclaimable
        else:
            self._block_key.pop(b, None)
            self._free.append(b)

    def ensure_capacity(self, sid: int, tokens: int) -> list[int]:
        """Grow session ``sid``'s block list to cover ``tokens`` tokens.
        Returns the logical-order block list.  Raises
        :class:`KVPoolExhausted` — the session's blocks untouched — when
        the pool or the per-session cap cannot cover it."""
        with self._lock:
            return self._ensure_capacity_locked(sid, tokens)

    def _ensure_capacity_locked(self, sid: int, tokens: int) -> list[int]:
        need = self._blocks_for(tokens)
        have = self._sessions.setdefault(sid, [])
        if need <= len(have):
            return list(have)
        if need > self.max_blocks_per_session:
            if not have:  # a failed NEW session must not linger
                del self._sessions[sid]
            self._c.inc("serving_kv_admission_rejects", job=self.job)
            raise KVPoolExhausted(
                f"session {sid}: {tokens} tokens needs {need} blocks, "
                f"per-session cap is {self.max_blocks_per_session}")
        grow = need - len(have)
        if grow > len(self._free) + len(self._cached_free):
            if not have:
                del self._sessions[sid]
            self._c.inc("serving_kv_admission_rejects", job=self.job)
            raise KVPoolExhausted(
                f"session {sid}: needs {grow} more blocks, "
                f"pool has {len(self._free) + len(self._cached_free)} "
                f"free of {self.num_blocks}")
        have.extend(self._alloc_locked(grow))
        return list(have)

    def free_session(self, sid: int) -> int:
        """Drop the session's ownership of every block it holds.  Unknown
        sids are a no-op (frees are idempotent).  Returns blocks
        released."""
        with self._lock:
            blocks = self._sessions.pop(sid, None)
            if not blocks:
                return 0
            for b in blocks:
                self._decref_locked(b)
            return len(blocks)

    def block_table(self, sid: int) -> np.ndarray:
        """``[max_blocks_per_session]`` int32 table, padded with the
        sentinel ``num_blocks``."""
        table = np.full(self.max_blocks_per_session, self.num_blocks,
                        np.int32)
        with self._lock:
            blocks = self._sessions.get(sid)
            if blocks is None:
                raise SessionUnknown(sid)
            table[:len(blocks)] = blocks
        return table

    # -- prefix sharing / copy-on-write ------------------------------------

    def _chain_keys(self, tokens):
        """(chain key, tokens covered) per FULL block of ``tokens``; the
        key hashes the whole prefix up to that boundary."""
        h = 0
        bs = self.block_size
        for i in range(len(tokens) // bs):
            h = hash((h, tuple(tokens[i * bs:(i + 1) * bs])))
            yield h, (i + 1) * bs

    def match_prefix(self, tokens) -> int:
        """Tokens an :meth:`admit_with_prefix` of this prompt would adopt
        from sealed blocks right now (probe only)."""
        tokens = [int(t) for t in tokens]
        cap = max(((len(tokens) - 1) // self.block_size)
                  * self.block_size, 0)
        covered = 0
        with self._lock:
            for key, cov in self._chain_keys(tokens):
                if cov > cap or key not in self._prefix_index:
                    break
                covered = cov
        return covered

    def admit_with_prefix(self, sid: int, tokens,
                          total_tokens: int) -> tuple[list[int], int]:
        """Admit a NEW session, adopting every sealed block whose chain key
        matches the prompt's prefix and allocating fresh blocks for the
        rest of the full reservation.  The prompt's final token is always
        left to prefill.  Returns (block list, tokens covered by adopted
        blocks).  Atomic: on :class:`KVPoolExhausted` nothing attaches."""
        tokens = [int(t) for t in tokens]
        need = self._blocks_for(total_tokens)
        cap = max(((len(tokens) - 1) // self.block_size)
                  * self.block_size, 0)
        with self._lock:
            if sid in self._sessions:
                raise ValueError(f"session {sid} already resident")
            if need > self.max_blocks_per_session:
                self._c.inc("serving_kv_admission_rejects", job=self.job)
                raise KVPoolExhausted(
                    f"session {sid}: {total_tokens} tokens needs {need} "
                    f"blocks, per-session cap is "
                    f"{self.max_blocks_per_session}")
            shared: list[int] = []
            covered = 0
            for key, cov in self._chain_keys(tokens):
                if cov > cap:
                    break
                b = self._prefix_index.get(key)
                if b is None:
                    break
                shared.append(b)
                covered = cov
            fresh_needed = need - len(shared)
            # adopted blocks that are reclaimable shrink the allocatable
            # pool once adopted
            reclaimable_adopted = sum(
                1 for b in shared if b in self._cached_free)
            if fresh_needed > (len(self._free) + len(self._cached_free)
                               - reclaimable_adopted):
                self._c.inc("serving_kv_admission_rejects", job=self.job)
                raise KVPoolExhausted(
                    f"session {sid}: needs {fresh_needed} fresh blocks "
                    f"beyond {len(shared)} shared")
            for b in shared:
                self._incref_locked(b)
            blocks = shared + self._alloc_locked(fresh_needed)
            self._sessions[sid] = blocks
            if covered:
                self._c.inc("kv_prefix_hits", job=self.job)
                self._c.inc("kv_prefix_tokens_saved", covered, job=self.job)
            return list(blocks), covered

    def register_prefix(self, sid: int, tokens) -> int:
        """Seal the session's FULL prompt blocks into the prefix index
        (once its prefill completed).  Returns newly registered blocks."""
        tokens = [int(t) for t in tokens]
        added = 0
        with self._lock:
            blocks = self._sessions.get(sid)
            if blocks is None:
                return 0
            for key, cov in self._chain_keys(tokens):
                i = cov // self.block_size - 1
                if i >= len(blocks):
                    break
                if key in self._prefix_index:
                    continue
                b = blocks[i]
                if b in self._block_key:
                    continue  # already seals a different chain
                self._prefix_index[key] = b
                self._block_key[b] = key
                added += 1
        return added

    def fork_session(self, src: int, dst: int) -> list[int]:
        """Clone ``src``'s whole block chain into a new session ``dst``
        copy-on-write (refcount++ on every block, the partial tail
        included)."""
        with self._lock:
            if dst in self._sessions:
                raise ValueError(f"session {dst} already resident")
            blocks = self._sessions.get(src)
            if blocks is None:
                raise SessionUnknown(src)
            for b in blocks:
                self._incref_locked(b)
            self._sessions[dst] = list(blocks)
            return list(blocks)

    def make_writable(self, sid: int, start_pos: int, end_pos: int) -> int:
        """Copy-on-write guard for a write of positions ``[start_pos,
        end_pos)``: each covered block the session does not own alone
        (shared, or sealed in the prefix index) is replaced by a fresh
        copy on the device.  Runs on the thread that owns cache mutation.
        Returns the copies made."""
        if end_pos <= start_pos:
            return 0
        lo = start_pos // self.block_size
        hi = (end_pos - 1) // self.block_size
        copies = []
        with self._lock:
            blocks = self._sessions.get(sid)
            if blocks is None:
                raise SessionUnknown(sid)
            for i in range(lo, min(hi + 1, len(blocks))):
                b = blocks[i]
                if self._ref.get(b, 0) == 1 and b not in self._block_key:
                    continue
                nb = self._alloc_locked(1)[0]
                copies.append((b, nb))
                blocks[i] = nb
                self._decref_locked(b)
        if not copies:
            return 0
        src = torch.tensor([s for s, _ in copies], device=self.device)
        dst = torch.tensor([d for _, d in copies], device=self.device)
        with torch.no_grad():
            for t in self.cache.values():
                t.index_copy_(1, dst, t.index_select(1, src))
        self._c.inc("kv_cow_copies", len(copies), job=self.job)
        return len(copies)

    # -- evacuation (migration / handoff / rescue) ---------------------------

    def export_session(self, sid: int, length: int) -> dict:
        """Host copy of the session's K/V (``[L, length, kv, hd]`` CPU
        tensors, dequantized) — the fallback migration payload and the
        converter between storage modes.  Accounted as ``path="host"``."""
        out = llama.gather_session_kv(self.cache, self.session_blocks(sid),
                                      int(length), self.block_size)
        self._c.inc("kv_migration_bytes",
                    sum(t.numel() * t.element_size() for t in out.values()),
                    job=self.job, path="host")
        return out

    def import_session(self, sid: int, host_kv: dict) -> list[int]:
        """Adopt an exported session: allocate blocks here and scatter the
        host K/V in.  Raises :class:`KVPoolExhausted` with nothing held
        (the caller keeps the host copy and may retry elsewhere)."""
        length = int(host_kv["k"].shape[1])
        # the residency check and the allocation under one lock hold: two
        # imports of one sid must not both pass the duplicate guard
        with self._lock:
            if sid in self._sessions:
                raise ValueError(f"session {sid} already resident")
            blocks = self._ensure_capacity_locked(sid, max(length, 1))
        try:
            llama.scatter_session_kv(self.cache, blocks, host_kv,
                                     self.block_size)
        except Exception:
            self.free_session(sid)
            raise
        return blocks

    def export_session_device(self, sid: int, length: int
                              ) -> KVDevicePayload:
        """Blocked DEVICE copy of the session (no host roundtrip) — the
        D2D payload.  Only the blocks covering ``length`` ship."""
        blocks = self.session_blocks(sid)
        covering = -(-max(int(length), 1) // self.block_size)
        arrays = llama.gather_session_kv_device(self.cache,
                                                blocks[:covering])
        return KVDevicePayload(arrays, length, self.quantize)

    def reserve_import_device(self, sid: int,
                              payload: KVDevicePayload) -> list[int]:
        """First half of a D2D import: the duplicate guard and the block
        reservation under one lock hold, then the payload placed on this
        pool's device with its :func:`plan_move` accounting
        (``path="ici"`` bytes).  The scatter is the caller's to run at its
        loop's iteration boundary (:meth:`apply_import_device`).  Raises
        :class:`KVPoolExhausted` / :class:`ValueError` with nothing
        held."""
        if payload.quantize != self.quantize:
            raise ValueError(
                f"D2D import needs matching storage modes "
                f"(src={payload.quantize!r}, dst={self.quantize!r})")
        n = int(payload.arrays["k"].shape[1])
        with self._lock:
            if sid in self._sessions:
                raise ValueError(f"session {sid} already resident")
            free = len(self._free) + len(self._cached_free)
            if n > self.max_blocks_per_session or n > free:
                self._c.inc("serving_kv_admission_rejects", job=self.job)
                raise KVPoolExhausted(
                    f"session {sid}: needs {n} blocks, {free} free, "
                    f"per-session cap {self.max_blocks_per_session}")
            self._sessions[sid] = self._alloc_locked(n)
            blocks = list(self._sessions[sid])
        try:
            t0 = time.perf_counter()
            placed = {name: t.to(self.device)
                      for name, t in payload.arrays.items()}
            if (calib.get_process_calib() is not None
                    and self.device.type == "cuda"):
                # only when calibration is armed: wait for the copy so the
                # wall below is the move, not its launch
                torch.cuda.synchronize(self.device)
            move_s = time.perf_counter() - t0
            payload.plan = plan_move(payload.arrays, self.device)
            payload.arrays = placed
            self._c.inc("kv_migration_bytes", payload.plan.bytes_total,
                        job=self.job, path="ici")
            calib.record(
                "kv_move_seconds",
                calib.nominal_transfer_seconds(payload.plan.bytes_ici,
                                               payload.plan.bytes_dcn),
                move_s, unit="s", job=self.job)
        except Exception:
            self.free_session(sid)
            raise
        return blocks

    def apply_import_device(self, sid: int, blocks: list,
                            payload: KVDevicePayload) -> None:
        """Second half of a D2D import: the blocked scatter on the device.
        Runs where cache mutation is race-free (the owning loop at an
        iteration boundary, or quiesced)."""
        llama.scatter_session_kv_device(self.cache, blocks, payload.arrays)

    def evacuate(self, lengths: dict[int, int]) -> dict[int, dict]:
        """Export every resident session (``sid → current token count``)
        through the host.  Sessions stay allocated here until
        :meth:`free_session`."""
        return {sid: self.export_session(sid, lengths[sid])
                for sid in self.sessions() if sid in lengths}
