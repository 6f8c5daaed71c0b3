"""TrainingJob CRD sync loop — the deployed control plane's watch; the
port's copy of edl_tpu.controller.sync.

Role of the reference's informer loop (reference pkg/controller.go:79-108:
``cache.NewListWatchFromClient`` + ``cache.NewInformer`` dispatching
onAdd/onUpdate/onDelete) plus the status write-back its Gen-2 updater added
(``updateCRDStatus``, reference pkg/updater/trainingJobUpdater.go:295-307).
This is what makes ``python -m edl_tpu_torch.cli controller`` on a real
cluster actually manage jobs: users ``kubectl apply`` TrainingJob custom
objects; the loop diffs the listed set against the controller's registry
and forwards

  new CR          → Controller.submit   (validate → materialize → phases)
  spec changed    → Controller.modify
  CR gone         → Controller.delete   (full teardown)

and each tick writes every job's phase + per-role replica statuses into
the CR's status subresource (only on change), so ``kubectl get tj`` shows
the lifecycle the way the reference's CRD printer columns did.

Two watch modes share the same diff/dispatch core:

* **poll-list** (default off the deployed path's critical sections, and
  the fallback everywhere): a full LIST each tick; the diff is driven
  purely by listed spec content, not resourceVersion bookkeeping, so a
  missed tick never loses an event — the next tick sees the same truth.
* **streaming watch** (``watch=True``; the reference informer's
  event-driven ListWatch, pkg/controller.go:87-107): a LIST anchors a
  resourceVersion, then watch events drive add/update/delete with no
  O(cluster) LIST per tick.  The stream is re-anchored by a fresh LIST
  on any error — including 410 Gone after apiserver compaction — and a
  periodic full resync (every ``resync_every`` windows) keeps the orphan
  sweep and any missed-event drift bounded, which is exactly the
  re-list discipline a production informer follows.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional, Protocol

from edl_tpu_torch.api.serde import manifest_from_dict, status_to_dict
from edl_tpu_torch.api.types import JobPhase, ServingJob, TrainingJob
from edl_tpu_torch.controller.controller import Controller
from edl_tpu_torch.observability.logging import get_logger

log = get_logger("crd-sync")


class TrainingJobStore(Protocol):
    """The CR surface the loop needs (K8sCluster implements it; the test
    stub's CustomObjectsApi backs it; any in-memory store with these two
    methods will do)."""

    def list_training_job_crs(self) -> list[dict]: ...

    def patch_training_job_status(self, name: str, status: dict,
                                  namespace: str | None = None) -> bool: ...


class TrainingJobSyncLoop:
    """Diff-based CR → controller synchronizer with status write-back."""

    def __init__(
        self,
        store: TrainingJobStore,
        controller: Controller,
        poll_seconds: float = 5.0,
        gc_orphans: bool = True,
        orphan_grace_ticks: int = 3,
        watch: bool = False,
        resync_every: int = 6,
    ) -> None:
        self.store = store
        self.controller = controller
        self.poll_seconds = poll_seconds
        #: True → consume streaming watch events between full LISTs.
        #: A store with no watch surface gets poll-list cadence outright —
        #: staying in "watch mode" against such a store would silently
        #: stretch reconcile latency from poll_seconds to
        #: resync_every*poll_seconds with no events ever arriving.
        if watch and getattr(store, "watch_training_job_crs", None) is None:
            log.warn("store has no watch surface; using poll-list cadence")
            watch = False
        self.watch = watch
        #: full LIST resync after this many watch windows (window length
        #: = poll_seconds), bounding sweep latency and any event drift
        self.resync_every = max(1, resync_every)
        #: resourceVersion of the last LIST (anchors the watch stream)
        self._last_rv: Optional[str] = None
        #: False → the orphan sweep only logs, never deletes (operator
        #: opt-out for clusters where other tooling shares the job label)
        self.gc_orphans = gc_orphans
        #: a group must be CR-less for this many CONSECUTIVE ticks before
        #: teardown — never on the first tick after controller start, so a
        #: transient LIST miss or a CR created moments after its resources
        #: cannot destroy running training work irreversibly.  The clamp
        #: floor of 2 enforces that invariant even for --orphan-grace-ticks 1
        self.orphan_grace_ticks = max(2, orphan_grace_ticks)
        #: (ns, name) → consecutive ticks observed CR-less
        self._orphan_strikes: dict[tuple[str, str], int] = {}
        #: uid → the spec dict we last acted on (change detection; spec
        #: content, not resourceVersion, so replays are harmless)
        self._seen_specs: dict[str, Any] = {}
        #: uid → job object handed to the controller (delete needs it)
        self._jobs: dict[str, TrainingJob] = {}
        #: uid → last status dict written to the CR (write only on change,
        #: reference trainingJobUpdater.go:295-307)
        self._written_status: dict[str, dict] = {}
        #: uid → (monotonic deadline before which no retry, current delay):
        #: per-job exponential backoff with jitter on failed status patches,
        #: so one job whose PATCH 500s doesn't get hammered every window
        #: while healthy jobs proceed (the reference informer's rate-limited
        #: workqueue discipline, pkg/controller.go:87-107)
        self._patch_backoff: dict[str, tuple[float, float]] = {}
        self.patch_backoff_base_s = 1.0
        self.patch_backoff_cap_s = 60.0
        #: uid → spec dict rejected by validation (retry only when the
        #: user edits the spec, not every tick)
        self._rejected_specs: dict[str, Any] = {}
        #: uid → reason a spec EDIT was rejected while the job keeps
        #: running under its last valid spec (surfaced via status.reason)
        self._rejected_update_reason: dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="trainingjob-sync")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def is_alive(self) -> bool:
        """Liveness of the background loop — the /healthz probe truth."""
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        windows = 0
        while not self._stop.is_set():
            if (not self.watch or self._last_rv is None
                    or windows % self.resync_every == 0):
                try:
                    self.run_once()
                except Exception as exc:  # LIST failure must not kill the loop
                    log.error("sync tick failed", error=str(exc))
            if self.watch and self._last_rv is not None:
                try:
                    self._watch_window(self.poll_seconds)
                except Exception as exc:
                    # 410 Gone (compaction), dropped connection, anything:
                    # the informer answer is a fresh LIST re-anchor
                    log.warn("watch stream failed; re-listing",
                             error=str(exc))
                    self._last_rv = None
                # phase transitions happen without CR events (pods coming
                # ready); flush recorded statuses every window
                self._write_back_statuses()
            else:
                self._stop.wait(self.poll_seconds)
            windows += 1

    def _watch_window(self, seconds: float) -> None:
        """Consume watch events for one window.

        The stream normally ends at its server-side timeout, but a proxy
        or apiserver may close it early (idle-close, EOF-after-open);
        sleeping out the remainder of the window keeps the loop paced —
        without it an early-closing connection turns the controller into
        a hot loop of watch requests."""
        t0 = time.monotonic()
        try:
            stream = getattr(self.store, "watch_training_job_crs", None)
            if stream is None:  # store has no watch surface: stay poll-list
                return
            for ev in stream(self._last_rv,
                             timeout_seconds=max(1, int(seconds))):
                if self._stop.is_set():
                    return
                self._handle_event(ev)
        finally:
            remaining = seconds - (time.monotonic() - t0)
            if remaining > 0 and not self._stop.is_set():
                self._stop.wait(remaining)

    def _handle_event(self, ev: dict) -> None:
        typ = ev.get("type")
        cr = ev.get("object") or {}
        meta = cr.get("metadata") or {}
        name = meta.get("name", "")
        if not name:
            return
        uid = f"{meta.get('namespace', 'default')}/{name}"
        rv = meta.get("resourceVersion")
        if rv:
            self._last_rv = str(rv)
        try:
            if typ == "DELETED":
                if uid in self._seen_specs or uid in self._jobs:
                    self._on_delete(uid)
                self._rejected_specs.pop(uid, None)
                self._written_status.pop(uid, None)
            elif typ in ("ADDED", "MODIFIED"):
                spec = cr.get("spec") or {}
                if uid not in self._seen_specs:
                    self._on_add(uid, cr, spec)
                elif spec != self._seen_specs[uid]:
                    self._on_update(uid, cr, spec)
        except Exception as exc:  # one CR must never kill the stream
            log.error("watch event dispatch failed", job=uid,
                      error=str(exc))

    # -- one reconcile tick ------------------------------------------------

    def run_once(self) -> None:
        """One list → diff → dispatch → status write-back pass.  Both
        job kinds ride the same diff: ServingJob CRs (when the store
        exposes ``list_serving_job_crs``) are listed alongside
        TrainingJobs each tick — the watch stream covers training CRs
        only, so serving reconcile latency is bounded by the periodic
        LIST, which every tick here is."""
        lister = getattr(self.store, "list_training_job_crs_with_rv", None)
        if lister is not None:
            items, rv = lister()
            self._last_rv = rv or None
        else:
            items = self.store.list_training_job_crs()
        serving_lister = getattr(self.store, "list_serving_job_crs", None)
        serving_items: list[dict] = []
        if serving_lister is not None:
            # NO try/except: like the training LIST above, a failed
            # serving LIST must abort the whole tick (caught by _run's
            # tick guard).  Swallowing it would leave every registered
            # ServingJob out of `listed`, and the delete pass below
            # would tear down live fleets — and permanently sweep their
            # job-scoped coordinator KV — on a single apiserver blip.
            serving_items = [dict(cr, kind=cr.get("kind", "ServingJob"))
                             for cr in serving_lister()]
        listed: dict[str, dict] = {}
        for cr in list(items) + serving_items:
            meta = cr.get("metadata") or {}
            name = meta.get("name", "")
            if not name:
                continue
            ns = meta.get("namespace", "default")
            uid = f"{ns}/{name}"
            if uid in listed:
                # a TrainingJob and a ServingJob may legally share a
                # name across their two CRDs, but the controller keys
                # jobs by ns/name — adopting the second kind would
                # repoint the first kind's updater at the wrong object.
                # First listed (training) wins; say so loudly.
                log.error("CR kind collision: this uid is already "
                          "managed by another kind; the later CR is "
                          "IGNORED — rename one of them",
                          job=uid,
                          kept=listed[uid].get("kind", "TrainingJob"),
                          ignored=cr.get("kind", "ServingJob"))
                continue
            listed[uid] = cr

        for uid, cr in listed.items():
            spec = cr.get("spec") or {}
            try:
                if uid not in self._seen_specs:
                    self._on_add(uid, cr, spec)
                elif spec != self._seen_specs[uid]:
                    self._on_update(uid, cr, spec)
            except Exception as exc:
                # One CR must never block the tick for every other CR —
                # the delete pass, orphan sweep and status write-back
                # below run regardless (the _on_* handlers already treat
                # any parse/validate failure as a recorded rejection; this
                # guard catches what they could not foresee).
                log.error("CR dispatch failed", job=uid, error=str(exc))

        for uid in list(self._seen_specs):
            if uid not in listed:
                self._on_delete(uid)
        for uid in list(self._rejected_specs):
            if uid not in listed:  # a rejected CR deleted without ever
                self._rejected_specs.pop(uid, None)  # becoming a job
                self._written_status.pop(uid, None)

        self._sweep_orphans(listed)
        self._write_back_statuses(listed)

    def _sweep_orphans(self, listed: dict[str, dict]) -> None:
        """Tear down trainer groups whose CR no longer exists — a
        `kubectl delete tj` issued while the controller was down leaves
        resources no in-memory diff can see (the restart-blind spot of
        the reference's informer too; its del_jobs.sh was the manual
        fix).  On the CRD-driven control plane the CR is the source of
        truth, so a group without a CR is garbage.  Cluster-wide, to
        match the cluster-wide CR watch.

        Deletion is irreversible, so three guards apply: jobs the
        in-process controller registry manages (the pre-CR submit flow)
        are never candidates; a candidate must stay CR-less for
        ``orphan_grace_ticks`` consecutive ticks (log-only until then);
        and ``gc_orphans=False`` turns the sweep into pure logging."""
        lister = getattr(self.store, "list_trainer_groups", None)
        deleter = getattr(self.store, "delete_resources", None)
        if lister is None or deleter is None:
            return
        cr_pairs = {tuple(uid.split("/", 1)) for uid in listed}
        managed = {tuple(uid.split("/", 1)) for uid in self._jobs}
        # jobs submitted in-process (Controller.submit without a CR —
        # tests, demos, legacy tooling) are owned work, not garbage
        managed |= {(j.namespace, j.name) for j in self.controller.jobs()}
        try:
            groups = set(lister())
        except Exception as exc:
            log.error("orphan sweep list failed", error=str(exc))
            return
        candidates = groups - cr_pairs - managed
        # a group that regained its CR (or vanished) resets its strikes
        for pair in list(self._orphan_strikes):
            if pair not in candidates:
                del self._orphan_strikes[pair]
        for ns, name in sorted(candidates):
            strikes = self._orphan_strikes.get((ns, name), 0) + 1
            self._orphan_strikes[(ns, name)] = strikes
            if strikes < self.orphan_grace_ticks:
                log.warn("orphaned job resources (no CR); will tear down "
                         "if still orphaned",
                         job=f"{ns}/{name}",
                         strike=f"{strikes}/{self.orphan_grace_ticks}")
                continue
            if not self.gc_orphans:
                log.warn("orphaned job resources (no CR); gc disabled, "
                         "leaving in place", job=f"{ns}/{name}")
                continue
            log.warn("tearing down orphaned job resources (no CR)",
                     job=f"{ns}/{name}")
            try:
                deleter(TrainingJob(name=name, namespace=ns))
                del self._orphan_strikes[(ns, name)]
            except Exception as exc:
                log.error("orphan teardown failed", job=f"{ns}/{name}",
                          error=str(exc))

    def _on_add(self, uid: str, cr: dict, spec: Any) -> None:
        if self._rejected_specs.get(uid) == spec:
            return  # unchanged invalid spec: don't re-reject every tick
        try:
            job = manifest_from_dict(cr)
            self.controller.submit(job)
        except Exception as exc:
            # Any failure to turn an arbitrary user dict into a registered
            # job is a spec rejection (the CRD schema's
            # x-kubernetes-preserve-unknown-fields admits shapes the
            # parser cannot — a string where a map belongs raises
            # AttributeError, an explicit null TypeError; all of them must
            # land in the CR status, not in a crash-looping tick).
            # surface the rejection where the user submitted it
            log.warn("TrainingJob rejected", job=uid, error=str(exc))
            self._rejected_specs[uid] = spec
            meta = cr.get("metadata") or {}
            self._patch_status(uid, {
                "phase": JobPhase.FAILED.value,
                "reason": f"invalid spec: {exc}",
                "replica_statuses": [],
            }, name=meta.get("name", ""),
                namespace=meta.get("namespace", "default"),
                serving=cr.get("kind") == "ServingJob")
            return
        self._rejected_specs.pop(uid, None)
        self._seen_specs[uid] = spec
        self._jobs[uid] = job
        log.info("TrainingJob added", job=uid)

    def _on_update(self, uid: str, cr: dict, spec: Any) -> None:
        try:
            job = manifest_from_dict(cr)
            self.controller.modify(job)
        except Exception as exc:  # same rejection surface as _on_add
            # Keep managing the last valid spec, but (a) record the spec so
            # the rejection isn't re-logged every tick and (b) surface the
            # reason in the CR status — the user must see the edit was
            # rejected where they submitted it.
            log.warn("TrainingJob update rejected", job=uid, error=str(exc))
            self._seen_specs[uid] = spec
            self._rejected_update_reason[uid] = str(exc)
            return
        self._rejected_update_reason.pop(uid, None)
        self._seen_specs[uid] = spec
        self._jobs[uid] = job
        log.info("TrainingJob updated", job=uid)

    def _on_delete(self, uid: str) -> None:
        job = self._jobs.pop(uid, None)
        self._seen_specs.pop(uid, None)
        self._written_status.pop(uid, None)
        self._patch_backoff.pop(uid, None)
        self._rejected_specs.pop(uid, None)
        self._rejected_update_reason.pop(uid, None)
        if job is not None:
            try:
                self.controller.delete(job)
            except Exception as exc:
                log.error("teardown failed", job=uid, error=str(exc))
        log.info("TrainingJob deleted", job=uid)

    # -- status write-back -------------------------------------------------

    def _write_back_statuses(self,
                             listed: Optional[dict[str, dict]] = None
                             ) -> None:
        """Record every managed job's phase into its CR status.  ``listed``
        (the LIST path) restricts to CRs seen this tick; the watch path
        passes None and patches by the registry's name/namespace — a CR
        deleted under us patches as a 404 no-op until the DELETED event
        or the next resync cleans the registry."""
        for uid, job in self._jobs.items():
            if listed is not None and uid not in listed:
                continue
            updater = self.controller.get_updater(job)
            if updater is None:
                continue
            status = status_to_dict(updater.job.status)
            reason = self._rejected_update_reason.get(uid)
            if reason is not None:
                status["reason"] = (f"spec update rejected: {reason}; "
                                    "running with last valid spec")
            self._patch_status(uid, status, name=job.name,
                               namespace=job.namespace,
                               serving=isinstance(job, ServingJob))

    def _patch_status(self, uid: str, status: dict, *, name: str,
                      namespace: str, serving: bool = False) -> None:
        if self._written_status.get(uid) == status:
            return
        patch = self.store.patch_training_job_status
        if serving:
            patch = getattr(self.store, "patch_serving_job_status", None)
            if patch is None:  # store predates the serving kind
                return
        deadline, delay = self._patch_backoff.get(uid, (0.0, 0.0))
        now = time.monotonic()
        if now < deadline:
            return  # this job is backing off; others are unaffected
        try:
            if patch(name, status, namespace=namespace):
                self._written_status[uid] = status
            self._patch_backoff.pop(uid, None)
        except Exception as exc:
            # exponential backoff + jitter; the in-memory phase machine is
            # unaffected and the patch retries once the deadline passes
            import random

            delay = min(self.patch_backoff_cap_s,
                        max(self.patch_backoff_base_s, delay * 2))
            jittered = delay * (0.5 + random.random() * 0.5)
            self._patch_backoff[uid] = (now + jittered, delay)
            log.error("status write-back failed; backing off", job=uid,
                      error=str(exc), retry_in_s=round(jittered, 2))
