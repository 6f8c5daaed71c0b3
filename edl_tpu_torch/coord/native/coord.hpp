// edl_tpu_torch coordination core: task-lease queue + membership epochs + KV.
//
// Native (C++) replacement for the reference's external Go services:
//  * the master task-queue server (invoked at /usr/bin/master,
//    reference docker/paddle_k8s:26-32): data tasks are leased to trainers
//    and re-dispatched if not completed within a timeout
//    (-task-timout-dur=16s, paddle_k8s:30), so a dead trainer's work is
//    recovered without restarting the job;
//  * etcd (sidecar, reference pkg/jobparser.go:167-184): membership,
//    discovery and small-state KV. Here membership is epoch-versioned —
//    every join/leave/expiry bumps the epoch, which is what the elastic
//    JAX runtime watches to trigger a reshard.
//
// The core is header-declared / coord.cc-implemented, wrapped by
//  * capi.cc  — flat C ABI for in-process use via Python ctypes, and
//  * server.cc — a TCP server speaking a newline-delimited protocol for
//    multi-process / multi-host use.
//
// All operations take an explicit `now_ms` so tests control time; the
// wrappers pass a monotonic clock.

#pragma once

#include <atomic>
#include <cstdint>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace edlcoord {

// Binary-safe hex framing shared by the wire protocol (server.cc) and the
// snapshot format (Service::Snapshot) — one codec, one behavior.
std::string HexEncode(const std::string& in);
bool HexDecode(const std::string& in, std::string* out);

// Dead-trainer work re-dispatch bound (reference docker/paddle_k8s:30).
constexpr int64_t kDefaultTaskTimeoutMs = 16000;
// A task failing this often is dropped (poison-pill guard).
constexpr int kDefaultMaxTaskFailures = 3;
// Liveness TTL for members; ~3 missed 5s heartbeats.
constexpr int64_t kDefaultMemberTtlMs = 15000;

struct Task {
  int64_t id = 0;
  std::string payload;
  int failures = 0;
};

struct Lease {
  int64_t task_id = -1;
  std::string payload;
};

enum class LeaseResult { kOk, kEmpty, kAllDone };

// Task-lease queue with timeout re-dispatch and multi-pass support.
class TaskQueue {
 public:
  TaskQueue(int64_t timeout_ms = kDefaultTaskTimeoutMs,
            int passes = 1,
            int max_failures = kDefaultMaxTaskFailures);

  int64_t AddTask(const std::string& payload);
  LeaseResult LeaseTask(const std::string& worker, int64_t now_ms, Lease* out);
  // If `worker` is non-empty, completion/failure is rejected unless that
  // worker still holds the lease (guards against a timed-out straggler's
  // late call voiding a re-dispatched lease).
  bool Complete(int64_t task_id, const std::string& worker = "");
  // Payload of a currently-leased task (for buffer grow-and-retry in the
  // C ABI); false if the task is not leased.
  bool PeekLeased(int64_t task_id, std::string* payload) const;
  bool Fail(int64_t task_id, const std::string& worker = "");
  // Extend a held lease's deadline (long-running shard keep-alive).
  bool Renew(int64_t task_id, const std::string& worker, int64_t now_ms);
  // Return timed-out leases to the todo queue; called inline by LeaseTask
  // but also usable standalone. Returns number re-dispatched.
  int Redispatch(int64_t now_ms);
  // Drop all leases held by a worker back to todo (explicit worker death).
  int ReleaseWorker(const std::string& worker);

  bool AllDone() const;
  int CurrentPass() const;
  // pending (todo), leased, done, dropped counts
  void Stats(int64_t* todo, int64_t* leased, int64_t* done,
             int64_t* dropped) const;

  // Durability (the etcd-sidecar role, reference pkg/jobparser.go:167-184):
  // append this queue's section to a snapshot / restore it.  Leased tasks
  // serialize as todo — after a coordinator restart the lease owners are
  // unknown, so the tasks re-dispatch (the same at-least-once contract as
  // the 16 s lease timeout).
  void SerializeTo(std::string* out) const;
  // Restore one snapshot line ("Q ..."/"T ..."/"D ..."); unknown tags are
  // ignored so the format can grow.
  void RestoreLine(const std::string& line);

  // Bumped whenever a field that appears in SerializeTo changes — including
  // the lease-driven paths (pass rollover, poison-pill drop) that no
  // explicit client command announces.  The server persists when this
  // moves, so a LEASE that rolls the pass over is durable before its ack.
  int64_t DurableVersion() const { return version_.load(); }

  // Replication restore: drop every task and reset pass bookkeeping so a
  // full-snapshot apply can never leave deleted entries behind.
  void Clear();

  // Delta-log replay surface (standby mirror applying framed op records,
  // doc/coordinator_scale.md).  The mirror never tracks leases — the
  // snapshot discipline serializes leased-as-todo — so task transitions
  // replay as direct todo/done moves keyed by task id.  Each returns
  // false when the referenced task is not where the record claims (the
  // mirror has diverged; the caller rejects the whole delta and the
  // primary falls back to a compaction checkpoint).
  bool ReplayAdd(int64_t id, const std::string& payload);
  bool ReplayComplete(int64_t id);
  bool ReplayFail(int64_t id);
  // Replay of a pass rollover ('R' record): runs the same deterministic
  // MaybeAdvancePass rule the primary ran — mirrored state in, mirrored
  // state out (requires both nodes configured with the same `passes`).
  void ForceAdvance();

 private:
  struct Leased {
    Task task;
    std::string worker;
    int64_t deadline_ms = 0;
  };

  void MaybeAdvancePass();

  mutable std::mutex mu_;
  std::atomic<int64_t> version_{0};
  int64_t timeout_ms_;
  int total_passes_;
  int max_failures_;
  int pass_ = 0;
  int64_t next_id_ = 0;
  int64_t dropped_ = 0;
  std::deque<Task> todo_;
  std::map<int64_t, Leased> leased_;
  std::vector<Task> done_;
};

struct MemberInfo {
  std::string name;
  std::string address;  // opaque contact string (host:port etc.)
  int64_t deadline_ms = 0;
};

// Epoch-versioned membership. Any composition change bumps the epoch.
class Membership {
 public:
  explicit Membership(int64_t ttl_ms = kDefaultMemberTtlMs);

  // Join (or refresh) a member; returns the current epoch.
  int64_t Join(const std::string& name, const std::string& address,
               int64_t now_ms);
  // Heartbeat; false if the member is unknown (it must re-Join).
  bool Heartbeat(const std::string& name, int64_t now_ms);
  // Graceful leave; bumps epoch if the member existed.
  bool Leave(const std::string& name);
  // Expire members whose TTL lapsed; returns number expired.
  int Expire(int64_t now_ms);

  int64_t Epoch() const;
  // Restore path only: epoch monotonicity must survive a coordinator
  // restart (state generations are keyed gen = epoch + 1; a reset epoch
  // would mis-order them).  Members are NOT restored — they re-Join when
  // their heartbeats bounce, each bumping the epoch further.
  void ForceEpoch(int64_t epoch);
  // Replication-restore surface (HA standby mirror).  The standby's
  // member table is a shadow of the primary's — never epoch-authoritative
  // — so these mutate WITHOUT bumping the epoch (ForceEpoch carries it):
  // ResetMembers drops the table, RestoreMember seeds one entry with a
  // fresh TTL (deadlines are process-local monotonic time and cannot
  // cross hosts), RefreshAll re-arms every deadline at promotion so a
  // member of an idle job gets a full TTL to re-heartbeat before the new
  // primary's first expiry sweep can prune it (which would bump the
  // epoch and reform every world the failover promised not to touch).
  void ResetMembers();
  void RestoreMember(const std::string& name, const std::string& address,
                     int64_t now_ms);
  // Quiet single-member removal for delta replay of an expiry batch
  // ('X' record): the primary swept N members under ONE epoch bump, so
  // the mirror removes each quietly and the record's ForceEpoch carries
  // the bump — N mirrored Leave()s would inflate the epoch by N-1 and a
  // failover would reform every world over a phantom membership change.
  void RemoveMirror(const std::string& name);
  void RefreshAll(int64_t now_ms);
  // Sorted by name — this order IS the rank assignment for an epoch
  // (replacing the reference's IP-sort ranks, docker/k8s_tools.py:113-121,
  // with an explicit, coordinator-owned ordering).
  std::vector<MemberInfo> Members(int64_t now_ms);

  // Bumped on every epoch change (the only membership field a snapshot
  // carries).
  int64_t DurableVersion() const { return version_.load(); }

 private:
  mutable std::mutex mu_;
  std::atomic<int64_t> version_{0};
  int64_t ttl_ms_;
  int64_t epoch_ = 0;
  std::map<std::string, MemberInfo> members_;
};

// Tiny etcd-role KV store (discovery, checkpoints metadata, barriers).
class KvStore {
 public:
  void Set(const std::string& key, const std::string& value);
  bool Get(const std::string& key, std::string* value) const;
  bool Del(const std::string& key);
  // Compare-and-swap: set to `value` iff current == `expect` (empty expect
  // means "must not exist"). The pserver slot-claim primitive.
  bool Cas(const std::string& key, const std::string& expect,
           const std::string& value);
  std::vector<std::string> Keys(const std::string& prefix) const;
  std::vector<std::pair<std::string, std::string>> Items() const;
  // Replication restore: a full-snapshot apply clears first so a key the
  // primary deleted cannot linger on the standby.
  void Clear();

  int64_t DurableVersion() const { return version_.load(); }

 private:
  mutable std::mutex mu_;
  std::atomic<int64_t> version_{0};
  std::unordered_map<std::string, std::string> kv_;
};

// One job's coordination state: queue + membership + kv.
struct Service {
  TaskQueue queue;
  Membership membership;
  KvStore kv;

  Service(int64_t task_timeout_ms, int passes, int64_t member_ttl_ms)
      : queue(task_timeout_ms, passes), membership(member_ttl_ms) {}

  // HA control-plane state.  `fence` is the monotonically-increasing
  // fencing token (bumped by every promotion; durable via the snapshot's
  // F line) that makes split-brain safe: a deposed primary's replication
  // stream carries a stale fence and is rejected, at which point it
  // fences itself off from clients.  `version_base` re-anchors the
  // replication stream position across restarts and promotions:
  // DurableVersion() is a process-local mutation count, so the exported
  // position is base + DurableVersion(), seeded from the snapshot's F
  // line — monotonic along any chain of failovers.
  std::atomic<int64_t> fence{0};
  std::atomic<int64_t> version_base{0};
  int64_t StreamVersion() const {
    return version_base.load() + DurableVersion();
  }

  // Whole-service snapshot (queue + membership epoch + KV + the HA F
  // line) as a versioned, binary-safe text blob; Restore applies one.
  // Used by the server's write-through persistence so a coordinator pod
  // restart keeps the job's accounting, checkpoint pointers and epoch
  // ordering — the role of the reference's etcd sidecar
  // (pkg/jobparser.go:167-184).
  std::string Snapshot() const;
  bool Restore(const std::string& blob);
  // Replication-stream snapshot/apply (HA primary → standby): the disk
  // format plus M member lines (old Restore ignores unknown tags, so the
  // formats stay mutually forward-compatible).  RestoreRepl CLEARS the
  // queue/KV first — deletions must propagate — and seeds members with
  // fresh TTLs at `now_ms` (deadlines never cross processes).
  std::string SnapshotRepl(int64_t now_ms);
  bool RestoreRepl(const std::string& blob, int64_t now_ms);
  // Log-structured delta replication (doc/coordinator_scale.md).  A
  // delta blob frames the op records that move a mirror from stream
  // position `from` to `to`:
  //
  //   EDLDELTA1 <from> <to>
  //   K <hexkey> <hexval|->      kv put (KVSET / winning KVCAS)
  //   k <hexkey>                 kv delete
  //   J <hexname> <hexaddr|->    member join / address change
  //   L <hexname>                member leave (graceful)
  //   X <hexname,hexname,...>    TTL-expiry batch (one epoch bump)
  //   A <id> <hexpayload|->      task added
  //   C <id>                     task completed (pending -> done)
  //   F <id>                     task failed (failures+1; drops at limit)
  //   R                          pass rollover (deterministic replay)
  //   .
  //
  // Empty binary fields frame as "-" exactly like the snapshot format.
  // ParseDeltaHeader validates magic + terminator (a torn blob must be
  // rejected WITHOUT ratcheting fence/position — the same rule snapshots
  // pin) and reports the position range; ApplyDelta applies the records
  // in order, returning false on the first one the mirror cannot replay
  // (caller then requests a compaction checkpoint instead).  The caller
  // re-anchors version_base at `to` after a successful apply.
  static bool ParseDeltaHeader(const std::string& blob, int64_t* from,
                               int64_t* to);
  bool ApplyDelta(const std::string& blob, int64_t now_ms);
  // The one checked entry point both the wire server (SYNC) and the C
  // ABI use — the dirty-mirror zeroing rule is safety-critical (a
  // mirror claiming a stale position can win a promotion) and must not
  // exist in two copies.  Returns the new stream version (>= 0), -1 for
  // a torn/unreplayable blob (torn: nothing touched; unreplayable: a
  // prefix may have applied, so this mirror's claimed position is
  // ZEROED until a checkpoint restores it), or -2 when the blob's
  // `from` is not this mirror's position (caller requests a
  // compaction checkpoint).
  int64_t ApplyDeltaChecked(const std::string& blob, int64_t now_ms);
  // Atomic, host-crash-durable file write-through (temp + fsync + rename +
  // directory fsync) / startup load.
  bool SaveTo(const std::string& path) const;
  bool LoadFrom(const std::string& path);

  // Test-only fault injection, called INSIDE SaveTo at its real
  // boundaries — "tmp": temp file written+fsynced, rename not yet done
  // (the torn-write window) — so the injected crash can never diverge
  // from the actual persist mechanics.  Null in production.
  mutable std::function<void(const char*)> persist_hook;

  // Sum of the components' durable-state versions: cheap change detection
  // for the server's persist gate (no O(state) serialize-and-compare on
  // read-mostly commands like the per-step MEMBERS poll).
  int64_t DurableVersion() const {
    return queue.DurableVersion() + membership.DurableVersion() +
           kv.DurableVersion();
  }
};

}  // namespace edlcoord
