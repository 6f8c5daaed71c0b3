"""Silent-data-corruption (SDC) defense plane — the port of
edl_tpu.runtime.sdc.

Every fault the rest of the stack survives is loud: a crash closes a socket,
a stall stops the beats.  A flipped bit in a gradient or a parameter
corrupts the model silently — the loss keeps printing and the checkpoints
keep landing.  This module is the detect → confirm → rollback → quarantine
ladder for that failure class, built on two properties the port already
has: in ``accum_mode="replicated"`` the update at step ``s`` is a bitwise
function of ``(dataset, V, s)`` at any world size and layout, and the
virtual-worker cursors plus verified checkpoints make "roll back to step k
and replay" exact.

1. **Fingerprint** (:class:`UpdateFingerprinter`) — a cadenced hash of the
   parameters after each update, published to a KV store
   (``sdc-fp/<job>/<step>/<worker>``) so that replicas cross-check one step
   and the minority worker is the named suspect.
2. **Anomaly** (:class:`AnomalyDetector`) — a fingerprint mismatch, a loss
   z-score trip against an EWMA baseline, or NaN/inf.
3. **Shadow recompute** (:class:`ShadowRecompute`) — re-execute the
   suspect steps from the last verified checkpoint on an independent
   trainer and compare bitwise; ``sdc_verdicts{outcome=confirmed|
   refuted}``.
4. **Escalate** (:class:`SdcPlane`) — a confirmed corruption names the
   verified step the loop rolls back to, quarantines the suspect
   (``sdc-quarantine/<name>``) and dumps a flight record with the verdict
   trail.

**Folds.**  A leaf's fold is the xor of its raw little-endian bytes taken as
4-byte lanes (a byte count that is not a multiple of 4 is padded with
zeros), then mixed with its byte length and the numpy name of its dtype
(``float32``, ``bfloat16``, ``int32``), so a truncation or a dtype drift
cannot fold to an honest leaf's value.  Leaves are keyed by their JAX
keystr path (``['params']['w0']``, :func:`edl_tpu_torch.interop.keystr`)
and taken in the JAX package's flatten order (sorted dict keys, list
indices; a module's parameters by their dotted names' paths), so the same
bytes under the same path fold, fingerprint and flip as the JAX package's.
On a CUDA tensor the lane xor runs on the device
(:func:`device_tree_folds`: an int32 view xor-reduced by halving), and only
one word a leaf crosses to the host; the first device fold of a
fingerprinter is held against the host fold, and a disagreement, or a dtype
the device fold cannot lane, raises — nothing falls back.  On a CPU tensor
the host fold is the path.

**SPMD.**  The reference is one controller; here every rank of the default
process group runs the virtual-worker loop.  :meth:`SdcPlane.after_step`
then takes ``gather``, which hands every rank's values to every rank:
each live rank fingerprints its own replica and rank 0 observes the loss,
so every rank learns one trigger (the loss gate's, or a split between the
replicas' fingerprints); every rank builds the shadow trainer (at world 1
the others stand by, and only rank 0 replays), and rank 0's verdict —
outcome, rollback step, the shadow's loss — is every rank's, so the whole
world restores the same step at the same boundary.
"""

from __future__ import annotations

import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from edl_tpu_torch.interop import _to_tensor, keystr
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import (dump_flight_record,
                                                 get_registry)
from edl_tpu_torch.observability.tracing import get_tracer

log = get_logger("runtime.sdc")

#: KV keys.  Fingerprints are per (job, step, worker) so replicas publish
#: side by side and the cross-check lists one step's prefix; quarantine
#: markers are per worker and outlive the job.
SDC_FP_KEY = "sdc-fp/{job}/{step}/{worker}"
SDC_FP_STEP_PREFIX = "sdc-fp/{job}/{step}/"
SDC_QUARANTINE_KEY = "sdc-quarantine/{name}"

_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


# -- fingerprint primitives --------------------------------------------------


def _dtype_name(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _host_bytes(x: Any) -> tuple[np.ndarray, str]:
    """The leaf's raw bytes as a flat uint8 array, and its dtype's numpy
    name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy(), _dtype_name(t)
    a = np.ascontiguousarray(np.asarray(x))
    return a.reshape(-1).view(np.uint8), str(a.dtype)


def leaf_fold(x: Any) -> int:
    """xor-fold the raw bytes of one leaf into 64 bits: the xor of its
    4-byte lanes (commutative, so any lane order gives the same value),
    then :func:`_mix_tail` of its byte length and dtype name."""
    raw, dtype = _host_bytes(x)
    n = raw.size
    if n % 4 == 0 and n:
        lanes = raw.view(np.uint32)
    else:
        buf = raw.tobytes() + b"\0" * ((-n) % 4)
        lanes = np.frombuffer(buf, dtype=np.uint32)
    acc = int(np.bitwise_xor.reduce(lanes)) if lanes.size else 0
    return _mix_tail(acc, n, dtype)


def _mix_tail(acc: int, nbytes: int, dtype_str: str) -> int:
    """The order-sensitive tail mix shared by the host and device folds:
    length and dtype name keep shape and type drift from folding to an
    honest leaf's value."""
    acc = ((acc * _FNV_PRIME) ^ nbytes) & _MASK64
    for ch in dtype_str.encode():
        acc = ((acc * _FNV_PRIME) ^ ch) & _MASK64
    return acc


def _name_path(name: str) -> tuple:
    """A parameter's dotted name as its path: ``"layers.0.wq"`` →
    ``("layers", 0, "wq")``."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def _leaves_with_path(tree: Any, path: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) of every leaf in the JAX package's flatten order:
    nested dicts by sorted key, lists and tuples by index, and a module's
    parameters by their names' paths."""
    if isinstance(tree, nn.Module):
        named = sorted((_name_path(n), p.detach())
                       for n, p in tree.named_parameters())
        for sub, p in named:
            yield path + sub, p
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves_with_path(sub, path + (i,))
    else:
        yield path, tree


def tree_leaf_folds(tree: Any) -> dict[str, int]:
    """Per-leaf folds keyed by keystr path — the unit of blame a
    fingerprint mismatch localizes to, and what checkpoint manifests store
    so a partial restore can verify the paths it shares."""
    return {keystr(path): leaf_fold(leaf)
            for path, leaf in _leaves_with_path(tree)}


def tree_fingerprint(tree: Any) -> str:
    """16-hex-digit order-sensitive mix over the sorted per-leaf folds."""
    return fold_fingerprint(tree_leaf_folds(tree))


def fold_fingerprint(folds: dict[str, int]) -> str:
    """Fingerprint from precomputed per-leaf folds (FNV-1a over each sorted
    path's bytes, then its fold)."""
    acc = 0xCBF29CE484222325  # FNV-1a offset basis
    for path in sorted(folds):
        for ch in path.encode():
            acc = ((acc ^ ch) * _FNV_PRIME) & _MASK64
        acc = ((acc ^ (int(folds[path]) & _MASK64)) * _FNV_PRIME) & _MASK64
    return f"{acc:016x}"


def _lane_words(x: torch.Tensor) -> torch.Tensor:
    """One leaf's 4-byte lanes as a flat int32 tensor on its device: an
    int32 view of a 4-byte (or wider) dtype; a 16-bit dtype pairs adjacent
    elements into little-endian words (an odd count padded with one zero);
    a sub-16-bit dtype raises."""
    flat = x.detach().contiguous().reshape(-1)
    size = flat.element_size()
    if size % 4 == 0:
        return flat.view(torch.int32)
    if size == 2:
        half = flat.view(torch.int16).to(torch.int32) & 0xFFFF
        if half.numel() % 2:
            half = torch.cat([half, half.new_zeros(1)])
        pairs = half.view(-1, 2)
        return pairs[:, 0] | (pairs[:, 1] << 16)
    raise NotImplementedError(
        f"the device fold lanes 16-bit and wider dtypes, not {x.dtype}")


def _xor_rows(words: list[torch.Tensor]) -> torch.Tensor:
    """The xor of each of ``words`` (flat int32 tensors of one length n >= 1
    on one device), as a [len(words)] tensor, by halving: the first halving
    writes each leaf's two halves' xor into one [k, ⌈n/2⌉] buffer, and the
    rest halve the buffer in place, every leaf at once."""
    n = words[0].numel()
    h, m = (n + 1) // 2, n // 2
    buf = torch.empty((len(words), h), dtype=torch.int32,
                      device=words[0].device)
    for row, w in zip(buf, words):
        torch.bitwise_xor(w[:m], w[h:], out=row[:m])
        if h > m:
            row[m:].copy_(w[m:h])
    while buf.shape[1] > 1:
        n = buf.shape[1]
        h, m = (n + 1) // 2, n // 2
        buf[:, :m].bitwise_xor_(buf[:, h:])
        buf = buf[:, :h]
    return buf[:, 0]


def device_tree_folds(tree: Any) -> list[int]:
    """Each leaf's lane xor (a uint32 value: the xor of its 4-byte lanes,
    as :func:`leaf_fold` takes them), in flatten order, computed where the
    leaf lives — on a CUDA tensor an int32 view xor-reduced by halving on
    the device, leaves of one length and device reduced together — so the
    step loop moves one word a leaf to the host instead of the update.  A
    numpy leaf is folded as a CPU tensor.  Raises for a dtype the device
    fold cannot lane."""
    return lane_xors([_lane_words(leaf if isinstance(leaf, torch.Tensor)
                                  else _to_tensor(np.asarray(leaf)))
                      for _, leaf in _leaves_with_path(tree)])


def block_words(block: torch.Tensor, index: Sequence[tuple[int, int]],
                shape: Sequence[int]) -> torch.Tensor:
    """The words whose xor is one block's share of its whole leaf's lane
    xor: ``block`` holds the ranges ``index`` (``(start, stop)`` a
    dimension) of a leaf of ``shape``.  A 4-byte or wider element is whole
    lanes; a 16-bit element fills the low or the high half of its lane by
    the parity of its flat index in the whole leaf, so the blocks of a leaf
    split anywhere xor to the leaf's lane xor.  Raises for a sub-16-bit
    dtype."""
    flat = block.detach().contiguous().reshape(-1)
    size = flat.element_size()
    if size % 4 == 0:
        return flat.view(torch.int32)
    if size != 2:
        raise NotImplementedError(
            f"the device fold lanes 16-bit and wider dtypes, not "
            f"{block.dtype}")
    parity = torch.zeros((), dtype=torch.int64, device=flat.device)
    stride = 1
    for d in reversed(range(len(shape))):
        lo, hi = index[d]
        at = (torch.arange(lo, hi, device=flat.device) * stride) % 2
        parity = parity + at.view((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= shape[d]
    half = flat.view(torch.int16).to(torch.int32) & 0xFFFF
    return half << (16 * (parity.reshape(-1) % 2)).to(torch.int32)


def lane_xors(words: list[torch.Tensor]) -> list[int]:
    """The xor of each flat int32 tensor of ``words``, as uint32 values:
    tensors of one length and device halve together
    (:func:`_xor_rows`)."""
    groups: dict[tuple, list[int]] = {}
    for i, w in enumerate(words):
        groups.setdefault((w.device, w.numel()), []).append(i)
    out = [0] * len(words)
    for (_, n), idx in groups.items():
        if n == 0:
            continue  # the xor of no lanes
        folded = _xor_rows([words[i] for i in idx]).tolist()
        for i, v in zip(idx, folded):
            out[i] = int(v) & _MASK32
    return out


def _flip_bit_(raw: Any, bit: int) -> None:
    """Flip bit ``bit % 8`` of byte ``(bit // 8) % nbytes`` of a flat uint8
    view, in place."""
    pos = (bit // 8) % len(raw)
    if isinstance(raw, torch.Tensor):
        raw[pos:pos + 1].bitwise_xor_(1 << (bit % 8))
    else:
        raw[pos] ^= np.uint8(1 << (bit % 8))


def flip_tree_bit(tree: Any, leaf: int = 0, bit: int = 17) -> Any:
    """A copy of ``tree`` (nested dicts, lists and tuples of numpy arrays or
    tensors) with ONE bit flipped: bit ``bit % 8`` of byte ``(bit // 8) %
    nbytes`` of leaf ``leaf % n``, leaves counted in flatten order — the
    minimal silent corruption the drills inject.  Only the flipped leaf is
    copied.  A module's parameter is flipped in place by
    :meth:`~edl_tpu_torch.runtime.elastic.ElasticTrainer.flip_param_bits`
    instead."""
    if isinstance(tree, nn.Module):
        raise TypeError("flip a module's parameter in place with "
                        "ElasticTrainer.flip_param_bits")
    leaves = list(_leaves_with_path(tree))
    path, x = leaves[leaf % len(leaves)]
    if isinstance(x, torch.Tensor):
        copy = x.detach().clone().contiguous()
        _flip_bit_(copy.reshape(-1).view(torch.uint8), bit)
    else:
        copy = np.array(x)  # an owned, contiguous copy
        _flip_bit_(copy.reshape(-1).view(np.uint8), bit)
    return _replace(tree, path, copy)


def _replace(tree: Any, path: tuple, value: Any) -> Any:
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {**tree, head: _replace(tree[head], rest, value)}
    items = list(tree)
    items[head] = _replace(items[head], rest, value)
    return type(tree)(items)


@dataclass
class BlockFolds:
    """A tree held in blocks across ranks (a sharded trainer's parameters),
    as the fingerprinter takes it: ``lanes()`` gives each whole leaf's
    ``(keystr path, lane xor, byte count, dtype name)``, the blocks' shares
    (:func:`block_words`) combined across the live ranks, and ``whole()``
    the whole leaves by keystr path, for the check against the host fold.
    Both are collective over the live group, so every live rank
    fingerprints at the same step."""

    lanes: Callable[[], list[tuple[str, int, int, str]]]
    whole: Callable[[], dict[str, torch.Tensor]]
    device: torch.device
    #: the layout the blocks lie in: the first fold of each layout is held
    #: against the host fold, at one step on all of its live ranks
    layout: Any = None


# -- an in-memory KV store ---------------------------------------------------


class MemoryKV:
    """The KV store the plane needs — ``kv_set``, ``kv_get``, ``kv_del``,
    ``kv_keys(prefix)`` — over a dict in this process, for workers that
    share one process.  Across processes the coordinator's
    :class:`~edl_tpu_torch.coord.client.CoordClient` serves the same four
    calls."""

    def __init__(self) -> None:
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def kv_set(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(value)

    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def kv_del(self, key: str) -> bool:
        with self._lock:
            return self._data.pop(key, None) is not None

    def kv_keys(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))


# -- the cadenced fingerprinter ----------------------------------------------


@dataclass
class CrossCheck:
    """One step's cross-check across workers."""

    step: int
    fingerprints: dict[str, str]
    mismatch: bool = False
    #: minority workers named by majority vote; empty on an even split
    #: (the shadow recompute resolves which side was honest)
    suspects: list[str] = field(default_factory=list)


class UpdateFingerprinter:
    """Cadenced post-step fingerprint publisher and cross-checker.

    The step loop pays the fold (on a CUDA tensor, on the device, one word
    a leaf to the host), recorded in ``pauses_s``; the KV publish runs on a
    background thread, at most one in flight."""

    def __init__(self, kv=None, job: str = "job", worker: str = "w0",
                 cadence: int = 1) -> None:
        self.kv = kv
        self.job = job
        self.worker = worker
        self.cadence = max(int(cadence), 1)
        #: step → fingerprint, locally observed (kept bounded)
        self.local: dict[int, str] = {}
        self.pauses_s: list[float] = []
        self._inflight: Optional[threading.Thread] = None
        #: None → decide from the first tree (device fold when a leaf is
        #: on a CUDA device, host fold otherwise); tests pin it
        self._prefer_device: Optional[bool] = None
        #: the device fold has been held against the host fold once (a
        #: tree in blocks: once in each layout)
        self._device_checked = False
        self._checked_layouts: set = set()

    def due(self, step: int) -> bool:
        return step % self.cadence == 0

    def record(self, step: int, tree: Any) -> Optional[str]:
        """Fingerprint ``tree`` at ``step`` if the cadence says so, publish
        it in the background, and return it (None off-cadence)."""
        if not self.due(step):
            return None
        devices = ({tree.device} if isinstance(tree, BlockFolds) else
                   {x.device for _, x in _leaves_with_path(tree)
                    if isinstance(x, torch.Tensor)})
        for dev in {d for d in devices if d.type == "cuda"}:
            # the update's own kernels finish whether or not we fold: only
            # the fold is the defense's pause
            torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        fp = self.fingerprint(tree)
        self.local[step] = fp
        if len(self.local) > 64:
            self.local.pop(min(self.local))
        get_counters().inc("sdc_fingerprints")
        if self.kv is not None:
            self._publish_bg(step, fp)
        pause = time.monotonic() - t0
        self.pauses_s.append(pause)
        get_registry().histogram(
            "sdc_fingerprint_seconds",
            help="step-loop pause per update fingerprint").observe(pause)
        return fp

    def fingerprint(self, tree: Any) -> str:
        """The tree's fingerprint, by the device fold when a leaf lies on a
        CUDA device (or ``_prefer_device`` says so), else the host fold.
        The first device fold is held against the host fold; a
        disagreement raises, as does a dtype the device cannot lane.  A
        :class:`BlockFolds` is folded block by block where its blocks live,
        its first fold in each layout held against the host fold of its
        whole leaves."""
        if isinstance(tree, BlockFolds):
            fp = fold_fingerprint({path: _mix_tail(w, nbytes, dtype)
                                   for path, w, nbytes, dtype in tree.lanes()})
            if tree.layout not in self._checked_layouts:
                self._check(fp, fold_fingerprint(
                    {p: leaf_fold(x) for p, x in tree.whole().items()}))
                self._checked_layouts.add(tree.layout)
            return fp
        leaves = list(_leaves_with_path(tree))
        if self._prefer_device is None:
            self._prefer_device = any(
                isinstance(x, torch.Tensor) and x.is_cuda for _, x in leaves)
        if not self._prefer_device:
            return fold_fingerprint({keystr(p): leaf_fold(x)
                                     for p, x in leaves})
        words = device_tree_folds(tree)
        fp = fold_fingerprint({
            keystr(p): _mix_tail(w, _nbytes(x), _dtype_name(x))
            for (p, x), w in zip(leaves, words)})
        if not self._device_checked:
            self._check(fp, tree_fingerprint(tree))
        return fp

    def _check(self, fp: str, ref: str) -> None:
        if fp != ref:
            raise RuntimeError(f"the device fold's fingerprint {fp} "
                               f"disagrees with the host fold's {ref}")
        self._device_checked = True

    def _publish_bg(self, step: int, fp: str) -> None:
        prev = self._inflight
        if prev is not None:
            prev.join()  # bounded: one publish in flight

        def publish() -> None:
            try:
                self.kv.kv_set(
                    SDC_FP_KEY.format(job=self.job, step=step,
                                      worker=self.worker), fp.encode())
            except Exception as exc:  # advisory plane: never kill a step
                log.warn("sdc fingerprint publish failed", step=step,
                         error=str(exc)[:120])

        t = threading.Thread(target=publish, daemon=True,
                             name=f"sdc-fp-{step}")
        self._inflight = t
        t.start()

    def drain(self) -> None:
        t = self._inflight
        if t is not None:
            t.join()
            self._inflight = None

    def cross_check(self, step: int) -> Optional[CrossCheck]:
        """Compare every worker's published fingerprint for ``step``.
        Majority vote names the minority suspect(s); a 2-way even split is
        still a mismatch, with no named suspect.  None without a KV or when
        fewer than 2 workers published."""
        if self.kv is None:
            return None
        self.drain()  # our own publish must be visible to the scan
        fps: dict[str, str] = {}
        prefix = SDC_FP_STEP_PREFIX.format(job=self.job, step=step)
        try:
            for key in self.kv.kv_keys(prefix):
                raw = self.kv.kv_get(key)
                if raw is not None:
                    fps[key[len(prefix):]] = raw.decode()
        except Exception as exc:
            log.warn("sdc cross-check scan failed", step=step,
                     error=str(exc)[:120])
            return None
        if len(fps) < 2:
            return None
        return _vote(step, fps)


def _vote(step: int, fps: dict[str, str]) -> CrossCheck:
    """The cross-check of one step's fingerprints by worker: majority vote
    names the minority suspect(s); a 2-way even split is still a mismatch,
    with no named suspect."""
    votes: dict[str, int] = {}
    for fp in fps.values():
        votes[fp] = votes.get(fp, 0) + 1
    if len(votes) == 1:
        return CrossCheck(step=step, fingerprints=fps)
    majority = max(votes.values())
    winners = [fp for fp, n in votes.items() if n == majority]
    suspects: list[str] = []
    if len(winners) == 1:
        suspects = sorted(w for w, fp in fps.items() if fp != winners[0])
    log.warn("sdc fingerprint mismatch across workers", step=step,
             fingerprints=fps, suspects=suspects)
    return CrossCheck(step=step, fingerprints=fps, mismatch=True,
                      suspects=suspects)


# -- anomaly detection -------------------------------------------------------


class AnomalyDetector:
    """Loss-stream anomaly gate: NaN/inf always trips; after a warmup, a
    z-score against an EWMA mean/variance baseline trips on spikes.  Cheap
    and jumpy — the shadow recompute is the arbiter."""

    def __init__(self, z: float = 6.0, warmup: int = 8,
                 alpha: float = 0.25) -> None:
        self.z = float(z)
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.seen = 0

    def observe(self, loss: float) -> Optional[str]:
        """Feed one loss; returns the trigger ("nan" | "loss_spike") or
        None.  An anomalous sample is not folded into the baseline."""
        if not math.isfinite(loss):
            return "nan"
        if self.mean is None:
            self.mean, self.seen = float(loss), 1
            return None
        delta = float(loss) - self.mean
        # absolute-explosion guard, live even during warmup
        if abs(delta) > 1e3 * (abs(self.mean) + 1.0):
            return "loss_spike"
        std = math.sqrt(self.var)
        if self.seen >= self.warmup and std > 0.0:
            if abs(delta) > self.z * std:
                return "loss_spike"
        self.mean += self.alpha * delta
        self.var = (1.0 - self.alpha) * (self.var
                                         + self.alpha * delta * delta)
        self.seen += 1
        return None


# -- shadow recompute --------------------------------------------------------


@dataclass
class Verdict:
    """The outcome of one anomaly → shadow-recompute episode (the flight
    record's payload)."""

    step: int
    trigger: str                       # nan | loss_spike | fp_mismatch
    outcome: str                       # confirmed | refuted | unresolved
    anchor_step: int = 0               # shadow's replay start (verified)
    replayed_steps: int = 0
    live_fingerprint: str = ""
    shadow_fingerprint: str = ""
    shadow_loss: float = float("nan")
    live_loss: float = float("nan")
    suspects: list[str] = field(default_factory=list)
    quarantined: Optional[str] = None
    rollback_step: Optional[int] = None

    def to_dict(self) -> dict:
        return {"step": self.step, "trigger": self.trigger,
                "outcome": self.outcome, "anchor_step": self.anchor_step,
                "replayed_steps": self.replayed_steps,
                "live_fingerprint": self.live_fingerprint,
                "shadow_fingerprint": self.shadow_fingerprint,
                "shadow_loss": self.shadow_loss,
                "live_loss": self.live_loss,
                "suspects": list(self.suspects),
                "quarantined": self.quarantined,
                "rollback_step": self.rollback_step}


def _verified_before(ck, step: int) -> Optional[int]:
    """The newest step of ``ck`` before ``step`` that verifies, or None."""
    for s in sorted(ck._all_steps(), reverse=True):
        if s < step and ck.verify(s):
            return int(s)
    return None


class ShadowRecompute:
    """Re-execute suspect steps on an INDEPENDENT trainer and compare.

    ``make_trainer()`` builds a fresh trainer at the job's init params (in
    replicated accumulation any world size computes the same update
    bitwise, so the shadow may be a world of 1; under a process group
    every rank calls it, and the ranks past the first stand by);
    ``make_batches()`` a fresh :class:`~edl_tpu_torch.runtime.virtual.
    VirtualBatches` over the same dataset.  The shadow restores the last
    VERIFIED checkpoint before the suspect step (or starts from init),
    winds the stream to it through ``cursors_for_step``, replays to the
    suspect step and compares fingerprints bitwise (replicated) or losses
    within the documented dp tolerance."""

    def __init__(self, make_trainer: Callable[[], Any],
                 make_batches: Callable[[], Any],
                 cfg, checkpointer=None,
                 mode: str = "replicated") -> None:
        from edl_tpu_torch.runtime.virtual import (DEFAULT_LOSS_ATOL,
                                                   DEFAULT_LOSS_RTOL)

        self.make_trainer = make_trainer
        self.make_batches = make_batches
        self.cfg = cfg
        self.checkpointer = checkpointer
        self.mode = mode
        self.atol, self.rtol = DEFAULT_LOSS_ATOL, DEFAULT_LOSS_RTOL

    def _anchor(self, step: int) -> int:
        if self.checkpointer is None:
            return 0
        anchor = self.checkpointer.latest_verified_step()
        if anchor is not None and anchor < step:
            return int(anchor)
        # the corruption landed before (or at) the newest verified step:
        # re-anchor one verified step earlier, else replay from init
        return _verified_before(self.checkpointer, step) or 0

    def judge(self, verdict: Verdict) -> Verdict:
        """Fill in the shadow half of ``verdict`` and rule: confirmed = the
        live execution disagrees with the honest recomputation; refuted =
        they match (a poisoned loss report over clean params, or a false
        alarm).  A rank whose shadow trainer stands by leaves the verdict
        unresolved: the judging rank rules."""
        from edl_tpu_torch.runtime.virtual import vw_keys

        t0 = time.monotonic()
        step = verdict.step
        trainer = self.make_trainer()
        batches = self.make_batches()
        if not trainer.live:
            return verdict
        anchor = self._anchor(step)
        if anchor > 0:
            tree = {"params": trainer.state.params,
                    "opt": trainer.state.opt_state}
            self.checkpointer.restore(tree, step=anchor, shardings=trainer)
            trainer.state.step = anchor
        batches.restore(batches.cursors_for_step(anchor))
        verdict.anchor_step = anchor
        loss = float("nan")
        replayed = 0
        while batches.step < step:
            micro = batches.next_step()
            if micro is None:
                break
            keys = None
            if trainer.rng_in_loss:
                keys = vw_keys(self.cfg.job_seed, self.cfg.vw_count,
                               batches.step - 1, device=trainer.device)
            loss = trainer.step_accumulate(micro, rng_keys=keys)
            replayed += 1
        verdict.replayed_steps = replayed
        verdict.shadow_loss = float(loss)
        verdict.shadow_fingerprint = tree_fingerprint(trainer.state.params)
        if self.mode == "replicated" and verdict.live_fingerprint:
            confirmed = (verdict.shadow_fingerprint
                         != verdict.live_fingerprint)
        elif math.isfinite(verdict.live_loss):
            confirmed = not (math.isfinite(verdict.shadow_loss)
                             and abs(verdict.shadow_loss - verdict.live_loss)
                             <= self.atol
                             + self.rtol * abs(verdict.shadow_loss))
        else:
            # live loss was NaN: if the honest recompute is finite, the
            # live execution was corrupt
            confirmed = math.isfinite(verdict.shadow_loss)
        verdict.outcome = "confirmed" if confirmed else "refuted"
        get_tracer().instant(
            "sdc_shadow_recompute", category="chaos", step=step,
            anchor=anchor, outcome=verdict.outcome, replayed=replayed,
            elapsed_ms=round((time.monotonic() - t0) * 1000, 2))
        return verdict


# -- quarantine --------------------------------------------------------------


def quarantine_worker(kv, name: str, reason: str = "sdc-confirmed",
                      by: str = "sdc") -> bool:
    """Write the durable quarantine marker for ``name``.  The membership
    machinery honours it: :meth:`~edl_tpu_torch.runtime.multihost.
    ElasticWorld.evicted_names` keeps a marked worker out of every world
    plan, and its keepalive declines the rejoin
    (:class:`~edl_tpu_torch.runtime.discovery.CoordDiscovery`).  Amnesty
    follows the eviction rules: a fresh incarnation clears its own marker
    (:func:`clear_quarantine`)."""
    if kv is None:
        return False
    try:
        kv.kv_set(SDC_QUARANTINE_KEY.format(name=name),
                  f"{by}:{reason}".encode())
    except Exception as exc:
        log.warn("sdc quarantine marker write failed", member=name,
                 error=str(exc)[:120])
        return False
    log.warn("worker quarantined for silent data corruption",
             member=name, reason=reason)
    get_tracer().instant("sdc_quarantined", category="chaos",
                         member=name, reason=reason)
    get_counters().inc("sdc_quarantines")
    return True


def quarantined_names(kv) -> set[str]:
    try:
        return {key.split("/", 1)[1]
                for key in kv.kv_keys("sdc-quarantine/")}
    except Exception:
        return set()


def clear_quarantine(kv, name: str) -> bool:
    """Fresh-start amnesty: a restarted incarnation of the suspect lifts
    its own marker; if it corrupts again it is re-quarantined."""
    key = SDC_QUARANTINE_KEY.format(name=name)
    try:
        if kv.kv_get(key) is None:
            return False
        kv.kv_del(key)
    except Exception:
        return False
    log.warn("clearing own sdc quarantine marker on fresh start",
             member=name)
    get_counters().inc("sdc_quarantines_cleared")
    return True


# -- the plane ---------------------------------------------------------------


#: the codes rank 0's trigger and outcome cross the process group under
_TRIGGERS = (None, "nan", "loss_spike", "fp_mismatch")
_OUTCOMES = ("unresolved", "confirmed", "refuted")


class SdcPlane:
    """The assembled ladder, wired into a training loop after each applied
    update (``VirtualWorkerLoop(sdc=...)`` drives it)::

        verdict = plane.after_step(step, loss, trainer.state.params)
        if verdict is not None and verdict.outcome == "confirmed":
            # roll back to verdict.rollback_step and replay

    ``healthy()``, a ``flight_dir`` falling back to ``EDL_FLIGHTREC_DIR``,
    an ``on_confirmed`` escalation callback, and flight records carrying
    the verdict trail, as the stall watchdog has."""

    def __init__(self, fingerprinter: Optional[UpdateFingerprinter] = None,
                 detector: Optional[AnomalyDetector] = None,
                 shadow: Optional[ShadowRecompute] = None,
                 checkpointer=None, kv=None,
                 on_confirmed: Optional[Callable[[Verdict], None]] = None,
                 flight_dir: Optional[str] = None) -> None:
        self.fingerprinter = fingerprinter or UpdateFingerprinter()
        self.detector = detector or AnomalyDetector()
        self.shadow = shadow
        self.checkpointer = checkpointer
        self.kv = kv if kv is not None else self.fingerprinter.kv
        self.on_confirmed = on_confirmed
        self.flight_dir = (flight_dir if flight_dir is not None
                           else os.environ.get("EDL_FLIGHTREC_DIR", ""))
        #: every completed episode, oldest first (bounded)
        self.verdicts: list[Verdict] = []

    def healthy(self) -> bool:
        return not any(v.outcome == "confirmed" for v in self.verdicts)

    # -- the per-step hook ----------------------------------------------

    def after_step(self, step: int, loss: Optional[float], params: Any,
                   gather: Optional[Callable[[Sequence[float]],
                                             list[list[float]]]] = None
                   ) -> Optional[Verdict]:
        """Run the ladder for one applied update.  Returns a Verdict when
        an anomaly was escalated to the shadow recompute (whatever the
        outcome), else None.

        ``gather(values)`` returns every rank's ``values`` of the default
        process group, by rank.  Given it, every rank calls this at the
        same step (a rank standing by with ``loss`` None): each live rank
        fingerprints its replica, rank 0 observes the loss, and one gather
        shares both, so every rank takes rank 0's trigger, or
        ``fp_mismatch`` when the live replicas' fingerprints differ (the
        replicas cross-check each other as workers do through the KV);
        rank 0 judges, a mismatch is confirmed when a replica disagrees
        with the shadow, which names it, and every rank returns rank 0's
        verdict (see the module docstring)."""
        judge = gather is None or dist.get_rank() == 0
        trigger, fp, check = None, None, None
        if judge:
            trigger = self.detector.observe(float(loss))
        if loss is not None:
            fp = self.fingerprinter.record(step, params)
        if gather is None:
            if trigger is None and fp is not None:
                check = self.fingerprinter.cross_check(step)
        else:
            word = -1 if fp is None else int(fp, 16)
            rows = gather([_TRIGGERS.index(trigger), word >> 32,
                           word & _MASK32])
            trigger = _TRIGGERS[int(rows[0][0])]
            fps = {f"rank{r}": f"{(int(hi) << 32) | int(lo):016x}"
                   for r, (_, hi, lo) in enumerate(rows) if hi >= 0}
            if trigger is None and len(fps) > 1:
                check = _vote(step, fps)
        if trigger is None and check is not None and check.mismatch:
            trigger = "fp_mismatch"
        if trigger is None:
            return None
        get_counters().inc("sdc_anomalies", trigger=trigger)
        get_tracer().instant("sdc_anomaly", category="chaos", step=step,
                             trigger=trigger,
                             loss=float("nan") if loss is None
                             else float(loss))
        verdict = Verdict(step=step, trigger=trigger, outcome="unresolved",
                          live_fingerprint=fp or
                          self.fingerprinter.local.get(step, ""),
                          live_loss=float("nan") if loss is None
                          else float(loss),
                          suspects=check.suspects if check else [])
        if verdict.live_fingerprint == "" and loss is not None:
            # escalation needs the live fingerprint even off-cadence; every
            # live rank takes it, as a sharded tree's fold is collective
            verdict.live_fingerprint = self.fingerprinter.fingerprint(params)
        if self.shadow is not None:
            verdict = self.shadow.judge(verdict)
            if check is not None and check.mismatch and \
                    verdict.shadow_fingerprint:
                # whoever published a fingerprint that disagrees with the
                # honest shadow is the suspect (it breaks an even split);
                # among replicas the judge may be the honest one, so any
                # disagreeing replica confirms
                bad = sorted(w for w, f in check.fingerprints.items()
                             if f != verdict.shadow_fingerprint)
                if gather is not None:
                    verdict.outcome = "confirmed" if bad else "refuted"
                if verdict.outcome == "confirmed" and not verdict.suspects:
                    verdict.suspects = bad
        if judge and verdict.outcome == "confirmed":
            self._escalate(verdict)
        if gather is not None:
            outcome, target, shadow_loss = gather([
                _OUTCOMES.index(verdict.outcome),
                -1 if verdict.rollback_step is None
                else verdict.rollback_step, verdict.shadow_loss])[0]
            verdict.outcome = _OUTCOMES[int(outcome)]
            verdict.rollback_step = None if target < 0 else int(target)
            verdict.shadow_loss = float(shadow_loss)
        get_counters().inc("sdc_verdicts", outcome=verdict.outcome)
        self.verdicts.append(verdict)
        if len(self.verdicts) > 32:
            self.verdicts.pop(0)
        return verdict

    # -- escalation ------------------------------------------------------

    def _escalate(self, verdict: Verdict) -> None:
        ck = self.checkpointer or (self.shadow.checkpointer
                                   if self.shadow is not None else None)
        if ck is not None:
            # rollback target: the newest verified step BEFORE the corrupt
            # one — the caller restores and replays through it
            step = ck.latest_verified_step()
            target = (int(step) if step is not None and step < verdict.step
                      else _verified_before(ck, verdict.step))
            verdict.rollback_step = target if target is not None else 0
        suspect = verdict.suspects[0] if verdict.suspects else None
        if suspect is not None and self.kv is not None:
            if quarantine_worker(self.kv, suspect,
                                 reason=f"sdc step {verdict.step}"):
                verdict.quarantined = suspect
        log.warn("sdc corruption CONFIRMED", step=verdict.step,
                 trigger=verdict.trigger,
                 rollback_step=verdict.rollback_step,
                 quarantined=verdict.quarantined)
        if self.flight_dir:
            trail = [v.to_dict() for v in self.verdicts[-8:]]
            trail.append(verdict.to_dict())
            try:
                dump_flight_record(
                    self.flight_dir, "sdc-corruption",
                    extra={"sdc": verdict.to_dict(),
                           "sdc_verdict_trail": trail})
            except Exception as exc:
                log.warn("sdc flight record failed", error=str(exc)[:120])
        if self.on_confirmed is not None:
            try:
                self.on_confirmed(verdict)
            except Exception as exc:
                log.warn("sdc on_confirmed callback failed",
                         error=str(exc)[:120])
