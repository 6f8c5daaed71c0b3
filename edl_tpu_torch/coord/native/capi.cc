// Flat C ABI over the coordination core, for Python ctypes
// (edl_tpu_torch/coord/bindings.py). All buffers are caller-allocated; string
// returns report required length so callers can retry with a bigger buffer.

#include <chrono>
#include <cstring>

#include "coord.hpp"

using edlcoord::Lease;
using edlcoord::LeaseResult;
using edlcoord::MemberInfo;
using edlcoord::Service;

namespace {

int64_t CopyOut(const std::string& s, char* buf, int64_t cap) {
  const int64_t n = static_cast<int64_t>(s.size());
  if (buf != nullptr && cap >= n) std::memcpy(buf, s.data(), n);
  return n;
}

}  // namespace

extern "C" {

void* edl_service_new(int64_t task_timeout_ms, int passes,
                      int64_t member_ttl_ms) {
  return new Service(task_timeout_ms, passes, member_ttl_ms);
}

void edl_service_free(void* h) { delete static_cast<Service*>(h); }

int64_t edl_now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---- task queue ----

int64_t edl_tq_add(void* h, const char* payload, int64_t len) {
  return static_cast<Service*>(h)->queue.AddTask(std::string(payload, len));
}

// returns 0 leased / 1 empty / 2 all-done; on 0 fills task_id and payload.
int edl_tq_lease(void* h, const char* worker, int64_t now_ms, int64_t* task_id,
                 char* buf, int64_t cap, int64_t* payload_len) {
  Lease lease;
  LeaseResult r = static_cast<Service*>(h)->queue.LeaseTask(
      worker ? worker : "", now_ms, &lease);
  if (r == LeaseResult::kOk) {
    *task_id = lease.task_id;
    *payload_len = CopyOut(lease.payload, buf, cap);
    return 0;
  }
  return r == LeaseResult::kEmpty ? 1 : 2;
}

int edl_tq_complete(void* h, int64_t task_id, const char* worker) {
  return static_cast<Service*>(h)->queue.Complete(task_id,
                                                  worker ? worker : "")
             ? 1
             : 0;
}

int edl_tq_fail(void* h, int64_t task_id, const char* worker) {
  return static_cast<Service*>(h)->queue.Fail(task_id, worker ? worker : "")
             ? 1
             : 0;
}

int edl_tq_renew(void* h, int64_t task_id, const char* worker,
                 int64_t now_ms) {
  return static_cast<Service*>(h)->queue.Renew(task_id, worker ? worker : "",
                                               now_ms)
             ? 1
             : 0;
}

// Payload of a currently-leased task: returns length (copy if cap fits),
// or -1 if not leased.  Lets bindings retry with a bigger buffer after a
// truncated edl_tq_lease.
int64_t edl_tq_peek_leased(void* h, int64_t task_id, char* buf, int64_t cap) {
  std::string payload;
  if (!static_cast<Service*>(h)->queue.PeekLeased(task_id, &payload))
    return -1;
  return CopyOut(payload, buf, cap);
}

int edl_tq_redispatch(void* h, int64_t now_ms) {
  return static_cast<Service*>(h)->queue.Redispatch(now_ms);
}

int edl_tq_release_worker(void* h, const char* worker) {
  return static_cast<Service*>(h)->queue.ReleaseWorker(worker ? worker : "");
}

int edl_tq_all_done(void* h) {
  return static_cast<Service*>(h)->queue.AllDone() ? 1 : 0;
}

int edl_tq_pass(void* h) { return static_cast<Service*>(h)->queue.CurrentPass(); }

void edl_tq_stats(void* h, int64_t* todo, int64_t* leased, int64_t* done,
                  int64_t* dropped) {
  static_cast<Service*>(h)->queue.Stats(todo, leased, done, dropped);
}

// ---- membership ----

int64_t edl_mb_join(void* h, const char* name, const char* addr,
                    int64_t now_ms) {
  return static_cast<Service*>(h)->membership.Join(name ? name : "",
                                                   addr ? addr : "", now_ms);
}

int edl_mb_heartbeat(void* h, const char* name, int64_t now_ms) {
  return static_cast<Service*>(h)->membership.Heartbeat(name ? name : "",
                                                        now_ms)
             ? 1
             : 0;
}

int edl_mb_leave(void* h, const char* name) {
  return static_cast<Service*>(h)->membership.Leave(name ? name : "") ? 1 : 0;
}

int edl_mb_expire(void* h, int64_t now_ms) {
  return static_cast<Service*>(h)->membership.Expire(now_ms);
}

int64_t edl_mb_epoch(void* h) {
  return static_cast<Service*>(h)->membership.Epoch();
}

// Serialized as "name=addr\n" lines, name-sorted (= rank order).
int64_t edl_mb_members(void* h, int64_t now_ms, char* buf, int64_t cap) {
  std::string out;
  for (const MemberInfo& m :
       static_cast<Service*>(h)->membership.Members(now_ms)) {
    out += m.name;
    out += '=';
    out += m.address;
    out += '\n';
  }
  return CopyOut(out, buf, cap);
}

// ---- kv ----

void edl_kv_set(void* h, const char* k, const char* v, int64_t vlen) {
  static_cast<Service*>(h)->kv.Set(k ? k : "", std::string(v, vlen));
}

// returns value length, or -1 if the key is missing.
int64_t edl_kv_get(void* h, const char* k, char* buf, int64_t cap) {
  std::string v;
  if (!static_cast<Service*>(h)->kv.Get(k ? k : "", &v)) return -1;
  return CopyOut(v, buf, cap);
}

int edl_kv_del(void* h, const char* k) {
  return static_cast<Service*>(h)->kv.Del(k ? k : "") ? 1 : 0;
}

int edl_kv_cas(void* h, const char* k, const char* expect, int64_t elen,
               const char* v, int64_t vlen) {
  return static_cast<Service*>(h)->kv.Cas(k ? k : "",
                                          std::string(expect, elen),
                                          std::string(v, vlen))
             ? 1
             : 0;
}

int64_t edl_kv_keys(void* h, const char* prefix, char* buf, int64_t cap) {
  std::string out;
  for (const std::string& k :
       static_cast<Service*>(h)->kv.Keys(prefix ? prefix : "")) {
    out += k;
    out += '\n';
  }
  return CopyOut(out, buf, cap);
}

// ---- snapshot / restore (HA replication + durability parity) ----

int64_t edl_svc_snapshot(void* h, char* buf, int64_t cap) {
  return CopyOut(static_cast<Service*>(h)->Snapshot(), buf, cap);
}

int64_t edl_svc_snapshot_repl(void* h, int64_t now_ms, char* buf,
                              int64_t cap) {
  return CopyOut(static_cast<Service*>(h)->SnapshotRepl(now_ms), buf, cap);
}

int edl_svc_restore(void* h, const char* blob, int64_t len) {
  return static_cast<Service*>(h)->Restore(std::string(blob, len)) ? 1 : 0;
}

int edl_svc_restore_repl(void* h, const char* blob, int64_t len,
                         int64_t now_ms) {
  return static_cast<Service*>(h)->RestoreRepl(std::string(blob, len), now_ms)
             ? 1
             : 0;
}

// Delta-log apply (log-structured replication): validates framing +
// position contiguity, applies the records, re-anchors the exported
// stream position at the blob's `to`.  Returns the new stream version,
// -1 on a torn/unparseable/unreplayable blob (the caller must not
// ratchet anything), or -2 when the blob's `from` does not match this
// mirror's position (the caller requests a compaction checkpoint).
int64_t edl_svc_apply_delta(void* h, const char* blob, int64_t len,
                            int64_t now_ms) {
  return static_cast<Service*>(h)->ApplyDeltaChecked(
      std::string(blob, len), now_ms);
}

int64_t edl_svc_fence(void* h) {
  return static_cast<Service*>(h)->fence.load();
}

int64_t edl_svc_stream_version(void* h) {
  return static_cast<Service*>(h)->StreamVersion();
}

}  // extern "C"
