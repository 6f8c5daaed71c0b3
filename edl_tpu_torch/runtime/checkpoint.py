"""Checkpoint/restore with integrity — the port of
edl_tpu.runtime.checkpoint over ``torch.distributed.checkpoint`` (DCP).

Each step is one DCP directory, ``<dir>/<step>``, written by this process
alone (``no_dist``): under an initialised process group DCP would otherwise
save collectively and may write any rank's copy of a replicated tensor,
including the stale copy of a rank standing by.  A step is written into a
temporary directory and renamed into place, so a reader never sees half of
one.

A tree is nested dicts, lists and tuples whose leaves are torch tensors or
numpy arrays, where an ``nn.Module`` stands for its parameters and a
``torch.optim.Optimizer`` for its state, keyed by parameter name (torch's
integer ids change with the optimizer).  Every leaf is stored under its JAX
keystr path, so the trainer's tree ``{"params": module, "opt": optimizer}``
stores ``['params']['w0']`` and ``['opt']['w0']['exp_avg']``, and a
manifest's ``leaves`` for ``['params']…`` equal the JAX package's for the
same weights.  ``restore`` reads a step into host memory, verifies it, and
only then loads it in place: into the module's own parameters and, through
``Optimizer.load_state_dict`` (which builds the state a fresh optimizer does
not have yet), into the optimizer, on the parameters' device.

A sharded trainer's rank holds one block of each leaf, so its state is
saved whole: :meth:`~edl_tpu_torch.runtime.elastic.ElasticTrainer.
whole_state` gathers it leaf by leaf to rank 0's host memory under the same
paths (a :class:`Snapshot`), so a step is layout-free and byte for byte a
replicated trainer's save of the same state.  ``restore(...,
shardings=trainer)`` reads a step whole and verified, then every rank of
the trainer takes its own block of each leaf under its live layout — the
reference's restore onto other shardings, into any world size and kind.

On top of the step store, as in the reference:

* **Torn/corrupt steps** — every completed save is fingerprinted into a
  per-step integrity manifest (relative path → size + CRC32, stored under
  ``<dir>/.integrity/<step>.json``, with the per-leaf folds of the tree it
  saved).  ``restore()`` verifies a step before trusting it and falls back
  to the newest step that still verifies, parses and hashes to its
  manifest, counting ``checkpoint_corruption_detected`` and the recovery
  (``recoveries_completed{type=corrupt_checkpoint}``).
* **Disk-full at the persist boundary** — ``save(..., best_effort=True)``
  turns an ``OSError`` (ENOSPC for real, or injected via
  :meth:`ElasticCheckpointer.inject_save_failures`) into a logged, counted
  skip; the first successful save afterwards counts
  ``recoveries_completed{type=disk_full}``.

**Async pipeline** (:meth:`ElasticCheckpointer.save_async`): the step loop
pays only the device→host copy; persist, fsync and the manifest run on a
background thread, never more than one in flight.  ``save(wait=False)``
writes in the background too, and owes its manifest to :meth:`finalize`.
"""

from __future__ import annotations

import errno
import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed.checkpoint as dcp
import torch.nn as nn
from torch.distributed.checkpoint.api import CheckpointException

from edl_tpu_torch.interop import _to_tensor, keystr
from edl_tpu_torch.observability import goodput
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability.logging import get_logger
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.observability.tracing import get_tracer
from edl_tpu_torch.runtime.sdc import fold_fingerprint, leaf_fold

log = get_logger("runtime.checkpoint")

_MANIFEST_DIRNAME = ".integrity"
_TMP_PREFIX = ".tmp-"

#: integrity-manifest schema version.  v1 manifests had only {step,
#: files}; v2 adds {"version": 2, "meta": [size, crc] | None} for the
#: training-meta sidecar; v3 adds the verified lineage: a ``verified`` bit,
#: the tree fingerprint ``tree_hash`` and the per-leaf folds ``leaves``.
#: verify()/restore() accept all three.
_MANIFEST_VERSION = 3


def _fingerprint_tree(root: Path) -> dict[str, list]:
    """Relative path → [size, crc32] for every regular file under root."""
    out: dict[str, list] = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            p = Path(dirpath) / fn
            crc = 0
            with open(p, "rb") as f:
                while chunk := f.read(1 << 20):
                    crc = zlib.crc32(chunk, crc)
            out[str(p.relative_to(root))] = [p.stat().st_size,
                                             crc & 0xFFFFFFFF]
    return out


def _stat_signature(root: Path) -> tuple:
    """(relative path, size, mtime, inode) of every regular file under
    root: what changes when a file is written, replaced or torn."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            p = Path(dirpath) / fn
            st = p.stat()
            out.append((str(p.relative_to(root)), st.st_size,
                        st.st_mtime_ns, st.st_ino))
    return tuple(sorted(out))


class CheckpointCorruption(RuntimeError):
    """No step in the store survives integrity verification + restore."""


class Snapshot(dict):
    """A tree already flattened to ``{keystr path: leaf}`` whose leaves are
    host tensors it alone holds (a save's copy, or a sharded trainer's
    gathered state): saved as it is, without another host copy."""


def param_path(name: str) -> tuple:
    """A parameter's dotted name as its path: ``"layers.0.wq"`` →
    ``("layers", 0, "wq")``."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def _param_paths(tree: Any) -> dict[int, tuple]:
    """id(parameter) → its path inside its module, for every module of
    ``tree`` (an optimizer's state is keyed by these)."""
    out: dict[int, tuple] = {}
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            out[id(p)] = param_path(name)
    elif isinstance(tree, dict):
        for sub in tree.values():
            out.update(_param_paths(sub))
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            out.update(_param_paths(sub))
    return out


def _optimizer_params(opt: torch.optim.Optimizer) -> list:
    return [p for group in opt.param_groups for p in group["params"]]


def _flatten(tree: Any, path: tuple = (),
             names: Optional[dict] = None) -> dict:
    """``{keystr path: leaf}`` of every leaf of ``tree`` (see the module
    docstring for modules and optimizers)."""
    if isinstance(tree, Snapshot):
        return tree
    if names is None:
        names = _param_paths(tree)
    out: dict = {}
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            out[keystr(path + param_path(name))] = p.detach()
    elif isinstance(tree, torch.optim.Optimizer):
        for p in _optimizer_params(tree):
            if id(p) not in names:
                raise KeyError("an optimizer's parameter belongs to no "
                               "module of the tree")
            for k, v in tree.state.get(p, {}).items():
                out[keystr(path + names[id(p)] + (k,))] = (
                    v if isinstance(v, torch.Tensor) else torch.tensor(v))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            out.update(_flatten(tree[key], path + (key,), names))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out.update(_flatten(sub, path + (i,), names))
    else:
        out[keystr(path)] = tree
    return out


def _without_optimizers(tree: Any) -> Any:
    """``tree`` with each optimizer left out."""
    if isinstance(tree, torch.optim.Optimizer):
        return {}
    if isinstance(tree, dict):
        return {k: _without_optimizers(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_without_optimizers(v) for v in tree)
    return tree


def _as_tensor(leaf: Any) -> torch.Tensor:
    """A leaf as a tensor (a numpy leaf is copied)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return _to_tensor(np.asarray(leaf))


def _host_copy(flat: dict) -> Snapshot:
    """A host copy of every leaf, complete when this returns: a background
    persist must never see later steps' in-place updates (on the CPU,
    ``t.cpu()`` would return ``t`` itself)."""
    return Snapshot({k: (v.detach().to("cpu", copy=True)
                      if isinstance(v, torch.Tensor) else _as_tensor(v))
                  for k, v in flat.items()})


def _snapshot(tree: Any) -> Snapshot:
    """``tree`` in host memory no later step can write: a
    :class:`Snapshot` as it is, anything else flattened and copied."""
    return tree if isinstance(tree, Snapshot) else _host_copy(_flatten(tree))


def _resolve(tree: Any) -> Any:
    """The tree of a save: ``tree``, or what ``tree()`` returns when it is
    a function (a sharded trainer's gather)."""
    if callable(tree) and not isinstance(tree, nn.Module):
        return tree()
    return tree


def _unwrap(exc: BaseException) -> BaseException:
    """DCP reports a failure as a CheckpointException (a BaseException)
    wrapping each rank's error; the first wrapped error is the one that
    counts."""
    if isinstance(exc, CheckpointException) and exc.failures:
        inner, _trace = next(iter(exc.failures.values()))
        return inner
    return exc


def _writer_alive(tmp: Path) -> bool:
    """True when the process that named ``<dir>/.tmp-<step>-<pid>`` is
    still running on this host."""
    try:
        os.kill(int(tmp.name.rsplit("-", 1)[1]), 0)
    except (ValueError, IndexError, ProcessLookupError):
        return False
    except PermissionError:
        return True
    return True


def _write_step(path: Path, flat: dict) -> None:
    """One DCP save of ``flat`` into ``path``, by this process alone."""
    try:
        dcp.save({k: _as_tensor(v) for k, v in flat.items()},
                 storage_writer=dcp.FileSystemWriter(path, sync_files=True),
                 no_dist=True)
    except CheckpointException as exc:
        raise _unwrap(exc) from exc


def _read_step(path: Path, keys) -> dict[str, torch.Tensor]:
    """The leaves ``keys`` of the step at ``path``, into host memory."""
    reader = dcp.FileSystemReader(path)
    saved = reader.read_metadata().state_dict_metadata
    missing = [k for k in keys if k not in saved]
    if missing:
        raise KeyError(f"checkpoint holds no leaf {missing[:4]}")
    out = {k: torch.empty(tuple(saved[k].size),
                          dtype=saved[k].properties.dtype) for k in keys}
    try:
        dcp.load(out, storage_reader=reader, no_dist=True)
    except CheckpointException as exc:
        raise _unwrap(exc) from exc
    return out


def _saved_keys(path: Path) -> list[str]:
    return list(dcp.FileSystemReader(path).read_metadata()
                .state_dict_metadata)


class ElasticCheckpointer:
    """A DCP step store keyed by step, with integrity manifests."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3) -> None:
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        # a save aborted mid-write leaves its temporary directory behind;
        # clear those of processes that are gone (a live writer's, such as
        # rank 0's while another rank opens the store, stays)
        for entry in self.directory.glob(f"{_TMP_PREFIX}*"):
            if not _writer_alive(entry):
                shutil.rmtree(entry, ignore_errors=True)
        #: injected persist-boundary failures: each makes one save raise
        #: ENOSPC
        self._injected_save_failures = 0
        #: consecutive failed saves — the degraded window whose end is the
        #: disk_full recovery transition
        self._save_failure_streak = 0
        #: steps saved with wait=False whose manifest is owed at finalize
        self._unfinalized: set[int] = set()
        #: training-meta sidecars owed by those saves
        self._pending_meta: dict[int, dict] = {}
        #: per-leaf folds owed by those saves (taken from the snapshot at
        #: submit time)
        self._pending_folds: dict[int, dict] = {}
        #: the last successful restore's step and whether its tree-hash
        #: matched the manifest (None = no hash evidence: pre-v3 manifest)
        self.last_restored_step: Optional[int] = None
        self.last_restore_hash_ok: Optional[bool] = None
        #: the async pipeline: at most ONE persist thread in flight
        self._inflight: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        #: step-loop pause of each save_async call, for percentiles
        self.async_pauses_s: list[float] = []
        #: verify()'s last answer for each step, with the stat signature of
        #: the files and the manifest it read
        self._verified: dict[int, tuple] = {}

    # -- fault injection (chaos drills) ------------------------------------

    def inject_save_failures(self, n: int = 1) -> None:
        """Make the next ``n`` save() calls fail with ENOSPC at the persist
        boundary — exactly where a full disk would first bite."""
        self._injected_save_failures += n

    # -- the step store ------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(step)

    def _all_steps(self) -> list[int]:
        """Every step in the store, read from disk (so a step written by
        another process is seen at once)."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and p.is_dir())

    def _prune_steps(self) -> None:
        if self.max_to_keep is None or self.max_to_keep <= 0:
            return
        for step in self._all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    # -- integrity manifests -----------------------------------------------

    def _manifest_path(self, step: int) -> Path:
        return self.directory / _MANIFEST_DIRNAME / f"{step}.json"

    def _meta_path(self, step: int) -> Path:
        return self.directory / _MANIFEST_DIRNAME / f"{step}.meta.json"

    def _write_meta(self, step: int, meta: dict) -> None:
        """Persist the training-meta sidecar (data cursors, RNG lineage).
        Atomic and fsync'd like the manifest; written BEFORE the manifest
        so the manifest can fingerprint it."""
        payload = json.dumps({"step": step, "meta": meta},
                             sort_keys=True).encode()
        dest = self._meta_path(step)
        dest.parent.mkdir(parents=True, exist_ok=True)
        tmp = dest.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dest)

    def _drop_stale_meta(self, step: int) -> None:
        """A meta-less save of a step must not leave an earlier save's
        sidecar behind for the new manifest to fingerprint as valid."""
        try:
            self._meta_path(step).unlink()
        except FileNotFoundError:
            pass

    def load_meta(self, step: int) -> Optional[dict]:
        """The step's training-meta sidecar, or None.  A torn sidecar
        (unparseable, or mismatching the manifest's fingerprint) is
        counted (``checkpoint_meta_torn``) and returns None: callers
        re-derive cursors from the step count."""
        mpath = self._meta_path(step)
        if not mpath.exists():
            return None
        try:
            raw = mpath.read_bytes()
            doc = json.loads(raw.decode())
            meta = doc["meta"]
        except (OSError, ValueError, KeyError) as exc:
            log.warn("torn training-meta sidecar; cursors fall back to "
                     "derive-from-step", step=step, error=str(exc)[:120])
            get_counters().inc("checkpoint_meta_torn")
            return None
        expect = (self.manifest(step) or {}).get("meta")
        if expect is not None and expect != [len(raw),
                                             zlib.crc32(raw) & 0xFFFFFFFF]:
            log.warn("training-meta sidecar fails manifest fingerprint; "
                     "cursors fall back to derive-from-step", step=step)
            get_counters().inc("checkpoint_meta_torn")
            return None
        return meta

    @staticmethod
    def _tree_folds(tree: Any) -> dict[str, int]:
        """Per-leaf folds of the tree (keystr path → fold)."""
        return {path: leaf_fold(leaf) for path, leaf in _flatten(tree).items()}

    def _write_manifest(self, step: int,
                        folds: Optional[dict] = None) -> None:
        root = self._step_dir(step)
        manifest = {"version": _MANIFEST_VERSION, "step": step,
                    "files": _fingerprint_tree(root)}
        if folds is not None:
            # the verified-lineage bit: the hash of the TREE the trainer
            # held, not just of the bytes the filesystem returned
            manifest["verified"] = True
            manifest["tree_hash"] = fold_fingerprint(folds)
            manifest["leaves"] = {path: f"{fold:016x}"
                                  for path, fold in sorted(folds.items())}
        mpath = self._meta_path(step)
        if mpath.exists():
            raw = mpath.read_bytes()
            manifest["meta"] = [len(raw), zlib.crc32(raw) & 0xFFFFFFFF]
        dest = self._manifest_path(step)
        dest.parent.mkdir(parents=True, exist_ok=True)
        tmp = dest.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())  # a manifest that "exists" must be whole
        os.replace(tmp, dest)
        self._prune_manifests()

    def _prune_manifests(self) -> None:
        """Drop manifests and sidecars of steps no longer in the store."""
        mdir = self.directory / _MANIFEST_DIRNAME
        if not mdir.is_dir():
            return
        live = {str(s) for s in self._all_steps()}
        for entry in mdir.glob("*.json"):
            stem = entry.stem  # "5" for 5.json, "5.meta" for 5.meta.json
            if stem.endswith(".meta"):
                stem = stem[:-len(".meta")]
            if stem not in live:
                entry.unlink(missing_ok=True)

    def verify(self, step: int) -> bool:
        """True iff the step's on-disk files match its manifest.  A step
        without a manifest verifies vacuously — restore() still catches a
        torn read when DCP fails to parse it.  The CRCs are taken again
        only when a file or the manifest changed (by size, mtime or inode)
        since this checkpointer last took them, so a watcher polling the
        lineage, and a restore right after ``latest_verified_step``, do not
        read an unchanged step twice."""
        mpath = self._manifest_path(step)
        if not mpath.exists():
            return True
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            stamp = mpath.stat().st_mtime_ns
        except (OSError, ValueError):
            return True  # unreadable manifest is no evidence against data
        try:
            signature = (_stat_signature(self._step_dir(step)), stamp)
        except OSError:
            return False  # files listed in the manifest are unreadable
        seen = self._verified.get(step)
        if seen is not None and seen[0] == signature:
            return seen[1]
        try:
            found = _fingerprint_tree(self._step_dir(step))
        except OSError:
            return False  # files listed in the manifest are unreadable
        ok = found == manifest["files"]
        self._verified[step] = (signature, ok)
        return ok

    def manifest(self, step: int) -> Optional[dict]:
        """The step's integrity manifest, or None (absent/unreadable)."""
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def manifest_verified(self, step: int) -> Optional[bool]:
        """True when the manifest carries the v3 verified bit and tree
        hash, False when it exists without them, None with no manifest."""
        manifest = self.manifest(step)
        if manifest is None:
            return None
        return bool(manifest.get("verified")) and "tree_hash" in manifest

    def verify_restored(self, step: int, tree: Any) -> Optional[bool]:
        """Spot-check a restored tree against the manifest's per-leaf
        folds, over the leaf paths present in both (a partial tree verifies
        its shared subset).  None when there is no hash evidence."""
        return self._check_folds(step, self._tree_folds(tree))

    def _check_folds(self, step: int, folds: dict) -> Optional[bool]:
        leaves = (self.manifest(step) or {}).get("leaves")
        if not leaves:
            return None
        shared = [p for p in folds if p in leaves]
        if not shared:
            return None
        for path in shared:
            if f"{folds[path]:016x}" != leaves[path]:
                log.warn("restored tree fails manifest param hash",
                         step=step, leaf=path)
                return False
        return True

    # -- save/restore -------------------------------------------------------

    def save(self, step: int, tree: Any, wait: bool = True,
             best_effort: bool = False, meta: Optional[dict] = None) -> bool:
        """Persist ``tree`` at ``step``; returns True on success.

        ``best_effort``: an OSError at the persist boundary (disk full,
        injected or real) is logged and counted instead of raised.

        ``wait=False`` copies the tree to the host and writes it in the
        background; the step's manifest is owed and written by
        :meth:`finalize` (or :meth:`close`).  Prefer :meth:`save_async`,
        which finalizes each step itself.

        ``meta`` is the training-meta sidecar (data cursors, RNG lineage);
        read it back with :meth:`load_meta`.

        ``tree`` may be a function returning the tree, such as a sharded
        trainer's :meth:`~edl_tpu_torch.runtime.elastic.ElasticTrainer.
        whole_state`: it is called first, whatever happens after (its peers
        gather with it), and its time is part of the save's pause."""
        t0 = time.monotonic()
        tree = _resolve(tree)
        self.wait_pending()  # one persist pipeline: saves never overlap
        try:
            # meta passed only when present: test seams wrap _persist with
            # the 4-argument signature
            return self._persist(step, tree, wait=wait,
                                 best_effort=best_effort,
                                 **({"meta": meta} if meta is not None
                                    else {}))
        finally:
            # goodput: a synchronous save bills the step loop for the
            # whole persist
            goodput.note_span(goodput.CHECKPOINT_PAUSE,
                              time.monotonic() - t0)

    def _persist(self, step: int, tree: Any, wait: bool,
                 best_effort: bool, meta: Optional[dict] = None) -> bool:
        """The persist body shared by the sync and async paths — runs on
        one thread at a time (callers serialize through
        :meth:`wait_pending`).  The tree is copied to the host once; the
        files and the folds are made from that copy."""
        flat = _snapshot(tree)
        try:
            if self._injected_save_failures > 0:
                self._injected_save_failures -= 1
                raise OSError(errno.ENOSPC,
                              "No space left on device (injected)")
            if wait:
                self._write_files(step, flat)
            else:
                t = threading.Thread(target=self._write_bg,
                                     args=(step, flat),
                                     name=f"ckpt-write-{step}")
                self._inflight = t
                t.start()
        except OSError as exc:
            if not best_effort:
                raise
            self._save_failure_streak += 1
            log.warn("checkpoint save failed; continuing without it",
                     step=step, error=str(exc),
                     consecutive_failures=self._save_failure_streak)
            get_tracer().instant("checkpoint_save_failed", category="chaos",
                                 step=step, error=str(exc)[:120])
            get_counters().inc("checkpoint_save_failures")
            return False
        if wait:
            # meta first: the manifest fingerprints the sidecar
            if meta is not None:
                self._write_meta(step, meta)
            else:
                self._drop_stale_meta(step)
            self._write_manifest(step, folds=self._tree_folds(flat))
            self._unfinalized.discard(step)
            self._pending_meta.pop(step, None)
            self._pending_folds.pop(step, None)
        else:
            self._unfinalized.add(step)
            if meta is not None:
                self._pending_meta[step] = meta
            # hash the snapshot NOW: the files are still being written
            self._pending_folds[step] = self._tree_folds(flat)
        if self._save_failure_streak:
            log.info("checkpoint saves recovered", step=step,
                     after_failures=self._save_failure_streak)
            get_tracer().instant("checkpoint_save_recovered",
                                 category="chaos", step=step)
            get_counters().inc("recoveries_completed", type="disk_full")
            self._save_failure_streak = 0
        return True

    def _write_files(self, step: int, flat: dict) -> None:
        """The step's DCP directory, written beside it and renamed into
        place (replacing an earlier save of the step), then the store
        pruned to ``max_to_keep`` steps."""
        tmp = self.directory / f"{_TMP_PREFIX}{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            _write_step(tmp, flat)
            dest = self._step_dir(step)
            if dest.exists():
                shutil.rmtree(dest)
            os.replace(tmp, dest)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self._prune_steps()

    def _write_bg(self, step: int, snap: Snapshot) -> None:
        try:
            self._write_files(step, snap)
        except BaseException as exc:  # surfaced at the next sync point
            self._async_error = exc

    # -- the async pipeline -------------------------------------------------

    def save_async(self, step: int, tree: Any,
                   best_effort: bool = False,
                   skip_if_busy: bool = False,
                   meta: Optional[dict] = None) -> float:
        """Checkpoint ``step`` without stalling the step loop.

        Copies ``tree`` to the host on the calling thread (complete when
        the copy returns; the only cost the caller pays when the pipeline
        is idle), then persists and finalizes — manifest included — in the
        background.  If the previous persist hasn't landed, blocks until
        it has, unless ``skip_if_busy``: then the tick is dropped (counted
        ``checkpoint_async_skipped``).  Returns the seconds this call
        paused the caller.  A background failure without ``best_effort``
        re-raises at the next sync point (any save/restore/wait/close).

        ``tree`` may be a function returning the tree, as for :meth:`save`:
        a sharded trainer's gather is then part of the pause (and runs even
        when the tick is dropped, since its peers gather with it)."""
        t0 = time.monotonic()
        tree = _resolve(tree)
        if skip_if_busy:
            t = self._inflight
            if t is not None and t.is_alive():
                get_counters().inc("checkpoint_async_skipped")
                pause = time.monotonic() - t0
                self.async_pauses_s.append(pause)
                goodput.note_span(goodput.CHECKPOINT_PAUSE, pause)
                return pause
        self.wait_pending()
        host_tree = _snapshot(tree)
        # non-daemon: a persist mid-write at interpreter exit is joined
        t = threading.Thread(target=self._persist_bg,
                             args=(step, host_tree, best_effort, meta),
                             name=f"ckpt-persist-{step}")
        self._inflight = t
        t.start()
        pause = time.monotonic() - t0
        self.async_pauses_s.append(pause)
        get_counters().inc("checkpoint_async_saves")
        get_registry().histogram(
            "checkpoint_pause_seconds",
            help="step-loop pause per async checkpoint save").observe(pause)
        # goodput: only the snapshot+handoff pause is the step loop's cost
        goodput.note_span(goodput.CHECKPOINT_PAUSE, pause)
        return pause

    def _persist_bg(self, step: int, host_tree: Snapshot,
                    best_effort: bool, meta: Optional[dict] = None) -> None:
        t0 = time.monotonic()
        try:
            if self._persist(step, host_tree, wait=True,
                             best_effort=best_effort,
                             **({"meta": meta} if meta is not None
                                else {})):
                get_tracer().instant(
                    "checkpoint_async_persisted", category="checkpoint",
                    step=step,
                    persist_ms=round((time.monotonic() - t0) * 1000, 1))
        except BaseException as exc:  # surfaced at the next sync point
            self._async_error = exc

    def wait_pending(self) -> None:
        """Block until the in-flight background write (if any) has landed;
        re-raises the failure of a non-best-effort background persist."""
        t = self._inflight
        if t is not None:
            t.join()
            self._inflight = None
        err, self._async_error = self._async_error, None
        if err is not None:
            raise err

    def finalize(self) -> None:
        """Land every pending write and write every owed manifest: after
        it returns, every step submitted is on disk with its manifest."""
        self.wait_pending()
        for step in sorted(self._unfinalized):
            if step not in self._all_steps():
                continue  # pruned before its manifest was due
            meta = self._pending_meta.pop(step, None)
            if meta is not None:
                self._write_meta(step, meta)
            else:
                self._drop_stale_meta(step)
            self._write_manifest(step,
                                 folds=self._pending_folds.pop(step, None))
        self._unfinalized.clear()
        self._pending_meta.clear()
        self._pending_folds.clear()

    def refresh(self) -> None:
        """Re-read the step store: the store is listed from disk on every
        call, so this only drains the pipeline."""
        self.wait_pending()

    def latest_step(self) -> Optional[int]:
        self.wait_pending()
        steps = self._all_steps()
        return steps[-1] if steps else None

    def latest_verified_step(self) -> Optional[int]:
        """Newest step whose integrity manifest matches the files."""
        self.wait_pending()
        for step in reversed(self._all_steps()):
            if self.verify(step):
                return step
        return None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None, parse_fallback: bool = True) -> Any:
        """Restore the newest good step (or ``step``, or the newest good
        one before it) into ``tree_like``: a module's parameters and an
        optimizer's state are loaded in place and the same objects
        returned; a tensor or numpy leaf comes back as a new one of its
        kind and device.

        ``shardings`` is the layout to restore onto, which may differ from
        the one that saved: an
        :class:`~edl_tpu_torch.runtime.elastic.ElasticTrainer` of any world
        size and kind, ``tree_like`` its ``{"params": module, "opt":
        optimizer}``.  The step is read whole (the module's leaves and every
        saved entry of the optimizer) and verified, then each rank of the
        trainer takes its own block of every leaf under its live layout
        (:meth:`~edl_tpu_torch.runtime.elastic.ElasticTrainer.
        load_whole_state`); ``tree_like`` is returned.

        A torn or corrupt step (manifest mismatch, DCP failing to parse it,
        or a parsed tree whose folds differ from the manifest's) is skipped
        with a warning, and the restore falls back to the newest older step
        that verifies, parses and hashes.  ``parse_fallback=False``
        re-raises a parse failure instead."""
        self.wait_pending()  # never read the store under an in-flight write
        steps = sorted(self._all_steps(), reverse=True)
        if step is not None:
            if step not in steps:
                # silently handing back an older step would diverge a
                # resume whose peers agreed on ``step``
                raise FileNotFoundError(
                    f"requested checkpoint step {step} not in "
                    f"{self.directory} (have {sorted(steps)})")
            steps = [s for s in steps if s <= step]
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")

        fell_back = False
        manifest_failed = False
        last_exc: Optional[BaseException] = None
        exc_types: set = set()
        # parse failures (manifest OK, DCP raised) might not be corruption
        # at all — if EVERY step fails that way identically the caller's
        # tree changed; defer their counters until that is decided
        deferred: list[tuple[int, str]] = []

        def flush_deferred() -> None:
            for s, err in deferred:
                get_tracer().instant("checkpoint_corruption_detected",
                                     category="chaos", step=s, error=err)
                get_counters().inc("checkpoint_corruption_detected")
            deferred.clear()

        all_manifested = True
        for candidate in steps:
            if not self._manifest_path(candidate).exists():
                all_manifested = False
            if not self.verify(candidate):
                log.warn("checkpoint step failed integrity verification; "
                         "falling back", step=candidate)
                get_tracer().instant("checkpoint_corruption_detected",
                                     category="chaos", step=candidate)
                get_counters().inc("checkpoint_corruption_detected")
                fell_back = True
                manifest_failed = True
                continue
            try:
                host = self._read(candidate, tree_like)
            except (Exception, CheckpointException) as exc:
                if not parse_fallback:
                    raise
                exc = _unwrap(exc)
                log.warn("checkpoint step unreadable; falling back",
                         step=candidate, error=str(exc))
                deferred.append((candidate, str(exc)[:120]))
                fell_back = True
                last_exc = exc
                exc_types.add(type(exc))
                continue
            hash_ok = self._check_folds(
                candidate, {p: leaf_fold(t) for p, t in host.items()})
            if hash_ok is False:
                log.warn("restored checkpoint fails param tree-hash; "
                         "falling back", step=candidate)
                get_tracer().instant("checkpoint_corruption_detected",
                                     category="chaos", step=candidate,
                                     error="param tree-hash mismatch")
                get_counters().inc("checkpoint_corruption_detected")
                get_counters().inc("checkpoint_tree_hash_mismatch")
                fell_back = True
                manifest_failed = True
                continue
            if shardings is None:
                restored = _load_into(tree_like, host)
            else:
                shardings.load_whole_state(host)
                restored = tree_like
            if fell_back:
                flush_deferred()  # a later step restored — those WERE torn
                log.warn("restored from fallback checkpoint after "
                         "corruption", step=candidate)
                get_tracer().instant("checkpoint_fallback_restore",
                                     category="chaos", step=candidate)
                get_counters().inc("recoveries_completed",
                                   type="corrupt_checkpoint")
            log.info("restored checkpoint", step=candidate,
                     dir=str(self.directory))
            self.last_restored_step = candidate
            self.last_restore_hash_ok = hash_ok
            return restored
        if (all_manifested and not manifest_failed and last_exc is not None
                and len(exc_types) == 1
                and not isinstance(last_exc, OSError)):
            # every step's bytes are exactly what save() wrote, yet DCP
            # failed identically on all of them: a caller-side mismatch
            # (the tree's structure changed), not corruption
            raise last_exc
        flush_deferred()
        raise CheckpointCorruption(
            f"every checkpoint step in {self.directory} is corrupt "
            f"(tried {steps})") from last_exc

    def _read(self, step: int, tree_like: Any) -> dict[str, torch.Tensor]:
        """The leaves ``tree_like`` needs from ``step``, in host memory:
        its own leaves, and every saved state entry of its optimizers
        (whatever state they hold now: a sharded trainer's optimizer steps
        blocks that no module of the tree holds)."""
        root = self._step_dir(step)
        keys = list(_flatten(_without_optimizers(tree_like)))
        opts = _optimizer_prefixes(tree_like)
        if opts:
            keys += [k for k in _saved_keys(root) if k.startswith(opts)]
        return _read_step(root, keys)

    def close(self) -> None:
        try:
            self.finalize()
        except Exception as exc:
            # close() must still close, but a swallowed persist failure
            # would be silent data loss — say it loudly
            log.warn("pending checkpoint work failed at close",
                     error=str(exc))


def _optimizer_prefixes(tree: Any, path: tuple = ()) -> tuple[str, ...]:
    """The keystr prefix of every optimizer's state in ``tree``."""
    if isinstance(tree, torch.optim.Optimizer):
        return (keystr(path) + "[",)
    out: tuple[str, ...] = ()
    if isinstance(tree, dict):
        for key, sub in tree.items():
            out += _optimizer_prefixes(sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out += _optimizer_prefixes(sub, path + (i,))
    return out


def _load_into(tree: Any, host: dict, path: tuple = (),
               names: Optional[dict] = None) -> Any:
    """``tree`` with the host leaves loaded: modules and optimizers in
    place, other leaves as new tensors or numpy arrays."""
    if names is None:
        names = _param_paths(tree)
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, p in tree.named_parameters():
                p.copy_(host[keystr(path + param_path(name))])
        return tree
    if isinstance(tree, torch.optim.Optimizer):
        prefix = keystr(path)
        state = {}
        for i, p in enumerate(_optimizer_params(tree)):
            pre = prefix + keystr(names[id(p)]) + "['"
            entries = {k[len(pre):-2]: v for k, v in host.items()
                       if k.startswith(pre) and "[" not in k[len(pre):]}
            if entries:
                state[i] = entries
        # builds the state a fresh optimizer lacks, on each parameter's
        # device (Adam's step stays a host tensor), in the same object
        tree.load_state_dict({"state": state, "param_groups":
                              tree.state_dict()["param_groups"]})
        return tree
    if isinstance(tree, dict):
        return {k: _load_into(v, host, path + (k,), names)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_load_into(v, host, path + (i,), names)
                          for i, v in enumerate(tree))
    got = host[keystr(path)]
    if isinstance(tree, torch.Tensor):
        return got.to(tree.device)
    return got.numpy()
