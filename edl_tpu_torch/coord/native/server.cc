// TCP coordination server: the process trainers/coordinators talk to in
// multi-process and multi-host deployments (role of the reference's
// master RPC on :8080 + etcd on :2379, docker/paddle_k8s:26-32 and
// pkg/jobparser.go:249-261, collapsed into one endpoint).
//
// Newline-delimited text protocol, hex-encoded binary fields:
//   LEASE <worker>                 -> OK <id> <hex> | EMPTY | DONE
//   ADD <hex>                      -> OK <id>
//   COMPLETE <id> [worker]         -> OK | ERR (worker: ownership check)
//   FAIL <id> [worker]             -> OK | ERR
//   RENEW <id> [worker]            -> OK | ERR (lease keep-alive)
//   RELEASE <worker>               -> OK <n>
//   STATS                          -> OK <todo> <leased> <done> <dropped> <pass>
//   JOIN <name> <addr>             -> OK <epoch>
//   HB <name>                      -> OK | ERR rejoin
//   LEAVE <name>                   -> OK | ERR
//   MEMBERS                        -> OK <epoch> <name=addr,...>
//   KVSET <k> <hex>                -> OK
//   KVGET <k>                      -> OK <hex> | NONE
//   KVDEL <k>                      -> OK | NONE
//   KVCAS <k> <hex-expect|-> <hex> -> OK | FAIL
//   KEYS <prefix?>                 -> OK <k1,k2,...>
//   PING                           -> PONG
//   CONFIG                         -> OK <task_timeout_ms> <passes> <member_ttl_ms>
//   WAITEPOCH <epoch> <timeout_ms> -> OK <epoch>  (long-poll: parks until
//                                     the membership epoch != <epoch> or
//                                     the timeout lapses)
//   KVWAIT <k> <timeout_ms> <epoch|-> -> OK <hex> | EPOCH <n> | NONE
//                                     (parks until the key exists, the
//                                     epoch moves off <epoch>, or timeout)
//   KVWAITNE <k> <hexold|-> <timeout_ms> -> OK <hex> | GONE | NONE
//                                     (parks until the key's value
//                                     differs from <hexold>; "-" = absent,
//                                     so "appeared" fires too — the
//                                     change-wait the serving weight
//                                     watcher long-polls on)
//   KEEPALIVE <n1,n2,...>          -> OK <acked> <expired-csv|->
//                                     (coalesced heartbeat batch: one
//                                     request renews every member slot a
//                                     supervisor host owns; expired names
//                                     must re-JOIN individually)
//   METRICS                        -> OK <requests> <parked> <fired>
//                                     <repl_bytes> <repl_deltas>
//                                     <repl_ckpts> <snapshot_bytes>
//                                     <follower_reads>
//
// Scale-out additions (doc/coordinator_scale.md): mutating acks carry a
// trailing "v<stream_version>" token (the read-your-writes floor a
// client presents to follower reads; older clients ignore the extra
// token), requests may be TAGGED — "#<id> <verb...>" answers
// "#<id> <reply...>" and park verbs run off-thread, so one multiplexed
// connection carries interleaved requests for many member slots without
// a parked wait head-of-line-blocking the rest — and standbys serve
// version-gated reads:
//   READ <fence> <minver> <verb...> -> the inner read verb's reply, from
//                                     ANY role, once this node's applied
//                                     stream position >= <minver> (parks
//                                     briefly, then "ERR behind <pos>");
//                                     "ERR stale <fence>" when this node
//                                     has not seen the client's fencing
//                                     regime.  Inner verbs: KVGET, KEYS,
//                                     MEMBERS, STATS, WAITEPOCH, KVWAIT,
//                                     KVWAITNE, METRICS, CONFIG, PING.
//                                     Followers never TTL-sweep.
//
// HA control-plane verbs (doc/coordinator_ha.md).  A node that is not the
// fenced-in primary answers every OTHER verb — reads and long-polls
// included — with "ERR fenced <fence>", so a client can never observe
// stale epoch/KV state from a standby or a deposed primary:
//   ROLE                           -> OK <primary|standby|fenced> <fence> <ver>
//   SYNC <fence> <ver> <hexblob>   -> OK <ver> | ERR fenced <fence>
//                                     | ERR behind | ERR badblob
//                                     (primary→standby stream; the blob's
//                                     magic selects the kind: EDLCOORD1 =
//                                     compaction checkpoint (full state,
//                                     clear-then-restore), EDLDELTA1 =
//                                     framed op-log records covering
//                                     (from, ver] — "ERR behind" when the
//                                     standby's position is not the
//                                     delta's `from` (the primary falls
//                                     back to a checkpoint), "ERR
//                                     badblob" on a torn blob (position
//                                     never ratchets).  The standby
//                                     persists BEFORE acking either way)
//   REPLHB <fence>                 -> OK <fence> | ERR fenced <fence>
//                                     (replication lease heartbeat)
//   PROMOTE <fence>                -> OK <fence> <ver> | ERR stale <fence>
//                                     (standby→primary iff <fence> beats
//                                     every token this node has seen)
//   REPLICATE <host:port>          -> OK  (attach a standby to stream to)
//
// Thread-per-connection; the core is mutex-guarded so this scales to the
// O(100) workers a single job needs.  The WAIT verbs are what let that
// same thread-per-connection shape serve event-driven coordination: a
// parked wait blocks only its own connection thread on a condition
// variable that every handled command notifies, so reform-critical waits
// (discovery.wait_stable, the coordinator claim, wait_state) fire within
// microseconds of the triggering mutation instead of a poll interval —
// and the coordinator sees ~1 request per second per idle waiter instead
// of the 20 Hz sleep-poll loops the Python runtime used to run.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <poll.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <csignal>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <limits>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "coord.hpp"

namespace {

edlcoord::Service* g_service = nullptr;
int64_t g_task_timeout_ms = edlcoord::kDefaultTaskTimeoutMs;
int g_passes = 1;
int64_t g_member_ttl_ms = edlcoord::kDefaultMemberTtlMs;

// Write-through durability (role of the reference's etcd sidecar,
// pkg/jobparser.go:167-184): after ANY command, if the service's
// durable-state version moved, snapshot to --state-file.  The version
// counter is bumped by the actual mutation sites in the core — including
// the ones no mutating client command announces (pass rollover/finish
// inside LEASE, epoch bump from MEMBERS' expiry sweep) —
// so the persist gate is a single atomic compare per command, not an
// O(state) serialize-and-compare, and nothing durable can slip past it.
// Lease ownership and heartbeat deadlines are deliberately not durable
// (the snapshot id-sorts pending tasks, so a plain LEASE/RENEW/RELEASE
// does not bump the version), keeping the hot dispatch path write-free.
// A failed write degrades to in-memory mode LOUDLY: it cannot un-apply the
// op, but the operator sees every failure on stderr and the next
// successful write re-covers the backlog (the snapshot is always total).
std::string g_state_file;
std::atomic<int64_t> g_persisted_version{-1};
std::mutex g_persist_mu;
// Fault injection (tests only): on the Nth persist, die (SIGKILL
// semantics via _exit) at the flagged point — "tmp" = after writing the
// temp file, BEFORE the rename (the mid-persist power-loss window);
// "acked" = after the rename+dir-fsync, before the response is written
// (the op is durable but the client never hears OK); "repl" = the
// replication-stream window — on a primary, after the SYNC line is
// written to the standby's socket but before the client is acked; on a
// standby, after the streamed state is durably persisted but before the
// primary hears the ack.  Drives the power-loss + failover durability
// tests without filesystem fault injection.
int g_crash_on_persist = 0;       // 0 = disabled; N = trip on Nth persist
std::string g_crash_point;        // "tmp" | "acked" | "repl"
std::atomic<int> g_persist_count{0};
std::atomic<int> g_repl_count{0};  // Nth replication event (point "repl")

// ---------------------------------------------------------------------------
// HA: primary/standby replication with fenced failover.
//
// The primary streams its full versioned snapshot (SnapshotRepl) to every
// attached standby synchronously, AFTER the local persist and BEFORE the
// client ack — the same discipline MaybePersist already enforces for
// disk.  A standby applies the stream clear-then-restore, persists its
// own state file, and only then acks; promotion (client-driven, see
// CoordClient) therefore can never select a standby claiming a position
// it does not durably hold.  Fencing: every promotion bumps the fencing
// token; a deposed primary discovers the newer token on its next
// replication exchange (or lease heartbeat) and fences ITSELF — from
// that point every client verb, reads and parked long-polls included,
// answers "ERR fenced".  Liveness vs consistency: an UNREACHABLE standby
// does not block the primary (a dead standby must not take down the
// job); only a standby that answers with a higher fence does.
// ---------------------------------------------------------------------------

enum Role { kPrimary = 0, kStandby = 1, kFenced = 2 };
std::atomic<int> g_role{kPrimary};
const char* RoleName(int r) {
  return r == kPrimary ? "primary" : r == kStandby ? "standby" : "fenced";
}

struct Replica {
  std::string host;
  int port = 0;
  int fd = -1;
  int64_t next_dial_ms = 0;  // dial backoff while the standby is down
  // stream position THIS replica acked — per-replica, so one standby
  // missing a SYNC (while another acked) still gets its catch-up from
  // the keeper thread instead of silently falling behind forever
  int64_t acked_version = -1;
};
std::vector<Replica> g_replicas;   // guarded by g_repl_mu
std::mutex g_repl_mu;              // serializes the replication channel
std::mutex g_ha_mu;                // serializes SYNC/PROMOTE role moves
int64_t g_repl_lease_ms = 3000;
std::atomic<int64_t> g_last_repl_ok_ms{0};
//: lock-free fast-path flag for EnsureLease: the fencing gate runs on
//: EVERY client verb and must not contend on g_repl_mu (which the keeper
//: thread can hold across multi-second blocking replica I/O) while the
//: lease is fresh or replication is off
std::atomic<bool> g_has_replicas{false};
// Lease policy under partition (doc/coordinator_ha.md): default is
// AVAILABLE — a primary that cannot reach any standby keeps serving (a
// dead mirror must not halt the job; the cost is a split-brain write
// window while truly partitioned).  --repl-lease-strict flips to
// CONSISTENT: once the lease expires without a successful exchange the
// primary suspends (ERR fenced, recoverable — it resumes when a standby
// answers again) so a deposed-but-partitioned primary can never ack.
bool g_repl_lease_strict = false;
constexpr int64_t kReplDialBackoffMs = 1000;

std::atomic<int64_t> g_fencing_rejects{0};
std::atomic<int64_t> g_repl_syncs{0};    // streams acked (primary) /
                                         // applied (standby)
std::atomic<int64_t> g_repl_errors{0};
std::atomic<int64_t> g_promotions{0};

// ---------------------------------------------------------------------------
// Log-structured delta replication (doc/coordinator_scale.md).
//
// Mutating commands append framed op records to a bounded in-memory log
// keyed by stream position; StreamToReplicas ships a replica the records
// covering (its acked position, head] as one EDLDELTA1 blob — O(delta)
// wire bytes per mutation instead of the full O(store) snapshot — and
// falls back to a compaction CHECKPOINT (the full snapshot) whenever
// the log cannot prove contiguity: a mutation the capture missed (TTL
// expiry sweeps, pass rollovers landing outside a captured verb), a
// replica behind the log's trimmed tail, a fresh REPLICATE re-attach, or
// a replica that rejected a delta.  Correctness therefore never depends
// on the log: deltas are a pure wire-bytes optimization and every
// fallback path is the already-proven checkpoint stream.
// ---------------------------------------------------------------------------

constexpr size_t kOpLogCap = 8192;  // records retained; older = checkpoint
std::mutex g_log_mu;
std::deque<std::pair<int64_t, std::string>> g_oplog;  // (position, record)
int64_t g_log_to = 0;  // position of the last record (= head when contiguous)
// mutating verbs serialize here across HandleImpl + log append, so record
// positions can never interleave; reads, parks and heartbeats stay off it
std::mutex g_mut_mu;
// records captured by the current command's HandleImpl (same thread)
thread_local std::vector<std::string> g_records;

std::atomic<int64_t> g_repl_bytes{0};        // wire bytes streamed
std::atomic<int64_t> g_repl_delta_syncs{0};  // exchanges shipped as deltas
std::atomic<int64_t> g_repl_ckpt_syncs{0};   // exchanges shipped as ckpts
std::atomic<int64_t> g_follower_reads{0};    // READ verbs served

void OpLogReset(int64_t head) {
  // caller holds g_log_mu: the log can no longer prove contiguity up to
  // `head` — drop it; replicas behind `head` get a checkpoint
  g_oplog.clear();
  g_log_to = head;
}

// Append this command's captured records.  v0/v1 bracket the command's
// StreamVersion; an exact match between version movement and record count
// is the contiguity proof — anything else (an uncaptured concurrent bump,
// e.g. a TTL sweep inside a parked wait) resets the log.
void OpLogAppend(int64_t v0, int64_t v1,
                 const std::vector<std::string>& records) {
  std::lock_guard<std::mutex> lk(g_log_mu);
  if (v1 == v0) return;
  if (g_log_to == v0 &&
      records.size() == static_cast<size_t>(v1 - v0)) {
    for (size_t i = 0; i < records.size(); ++i)
      g_oplog.emplace_back(v0 + 1 + static_cast<int64_t>(i), records[i]);
    g_log_to = v1;
    while (g_oplog.size() > kOpLogCap) g_oplog.pop_front();
  } else {
    OpLogReset(v1);
  }
}

// Build the EDLDELTA1 blob covering (from, to], or "" when the log
// cannot (trimmed past `from`, or head != `to`).  Caller holds g_log_mu.
std::string OpLogDelta(int64_t from, int64_t to) {
  if (g_log_to != to || from >= to) return "";
  if (g_oplog.empty() || g_oplog.front().first > from + 1) return "";
  std::string out = "EDLDELTA1 " + std::to_string(from) + " " +
                    std::to_string(to) + "\n";
  for (const auto& rec : g_oplog)
    if (rec.first > from) out += rec.second + "\n";
  out += ".\n";
  return out;
}

// ---------------------------------------------------------------------------
// Per-verb latency histograms (edl_coord_verb_seconds{verb=...}): the
// bench's attribution signal for where control-plane time goes.  Fixed
// buckets, lock-free observation; rendered on /metrics only for verbs
// actually seen so an idle server's exposition stays lean.
// ---------------------------------------------------------------------------

constexpr double kVerbBucketsS[] = {0.0005, 0.001, 0.0025, 0.005, 0.01,
                                    0.025,  0.05,  0.1,    0.25,  0.5,
                                    1.0,    2.5};
constexpr size_t kNVerbBuckets = sizeof(kVerbBucketsS) / sizeof(double);
struct VerbHist {
  const char* name;
  std::atomic<int64_t> buckets[kNVerbBuckets];  // cumulative at render
  std::atomic<int64_t> count{0};
  std::atomic<int64_t> sum_us{0};
};
VerbHist g_verb_hists[] = {
    {"LEASE", {}, {}, {}},    {"ADD", {}, {}, {}},
    {"COMPLETE", {}, {}, {}}, {"FAIL", {}, {}, {}},
    {"RENEW", {}, {}, {}},    {"RELEASE", {}, {}, {}},
    {"STATS", {}, {}, {}},    {"JOIN", {}, {}, {}},
    {"HB", {}, {}, {}},       {"KEEPALIVE", {}, {}, {}},
    {"LEAVE", {}, {}, {}},    {"MEMBERS", {}, {}, {}},
    {"KVSET", {}, {}, {}},    {"KVGET", {}, {}, {}},
    {"KVDEL", {}, {}, {}},    {"KVCAS", {}, {}, {}},
    {"KEYS", {}, {}, {}},     {"WAITEPOCH", {}, {}, {}},
    {"KVWAIT", {}, {}, {}},   {"KVWAITNE", {}, {}, {}},
    {"METRICS", {}, {}, {}},  {"READ", {}, {}, {}},
    {"SYNC", {}, {}, {}},     {"REPLHB", {}, {}, {}},
    {"PROMOTE", {}, {}, {}},  {"REPLICATE", {}, {}, {}},
    {"ROLE", {}, {}, {}},     {"PING", {}, {}, {}},
    {"CONFIG", {}, {}, {}},   {"other", {}, {}, {}},
};
constexpr size_t kNVerbs = sizeof(g_verb_hists) / sizeof(VerbHist);

VerbHist& FindVerbHist(const std::string& cmd) {
  for (size_t i = 0; i + 1 < kNVerbs; ++i)
    if (cmd == g_verb_hists[i].name) return g_verb_hists[i];
  return g_verb_hists[kNVerbs - 1];  // "other"
}

void ObserveVerb(const std::string& cmd, double seconds) {
  VerbHist& h = FindVerbHist(cmd);
  for (size_t b = 0; b < kNVerbBuckets; ++b)
    if (seconds <= kVerbBucketsS[b]) {
      h.buckets[b].fetch_add(1);
      break;  // non-cumulative per-bucket; summed cumulative at render
    }
  h.count.fetch_add(1);
  h.sum_us.fetch_add(static_cast<int64_t>(seconds * 1e6));
}

void MaybePersist(bool force = false) {
  if (g_state_file.empty()) return;
  std::lock_guard<std::mutex> lock(g_persist_mu);
  // Read the version BEFORE snapshotting: a concurrent mutation landing
  // mid-snapshot then re-triggers persistence on its own command, never
  // the reverse (recording a version whose state was not yet written).
  // `force` persists even at an unmoved version — promotion changes the
  // fencing token, which lives outside the durable-version counter.
  int64_t version = g_service->DurableVersion();
  if (!force && version == g_persisted_version.load()) return;
  int n = g_persist_count.fetch_add(1) + 1;
  bool trip = g_crash_on_persist != 0 && n == g_crash_on_persist;
  // "tmp" = simulated power loss mid-persist, injected INSIDE SaveTo at
  // the real torn-write window (temp written, rename not yet done) so
  // the fault can never diverge from the production persist mechanics
  g_service->persist_hook =
      (trip && g_crash_point == "tmp")
          ? std::function<void(const char*)>([](const char* stage) {
              if (std::strcmp(stage, "tmp") == 0) _exit(137);
            })
          : nullptr;
  if (g_service->SaveTo(g_state_file)) {
    g_persisted_version.store(version);
    if (trip && g_crash_point == "acked") {
      // durable but unacked: the client must retry and the retry must
      // converge (at-least-once + claimant-unique CAS semantics)
      _exit(137);
    }
  } else {
    std::fprintf(stderr,
                 "edl-coord: PERSIST FAILED for %s — state is in-memory "
                 "only until a write succeeds\n",
                 g_state_file.c_str());
  }
}

int64_t NowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Long-poll machinery: every handled command bumps the generation and
// notifies, so a parked WAITEPOCH/KVWAIT wakes the instant any mutation
// could have satisfied it (spurious wakeups just re-check and re-park).
// The generation counter closes the check-then-wait race: a waiter
// snapshots it before inspecting state, and skips the wait if a command
// landed in between.  TTL expiry has no command to announce it, so parked
// waits also re-check on a coarse 100 ms cadence — that bounds only
// expiry-detection latency, never event latency.
std::mutex g_wait_mu;
std::condition_variable g_wait_cv;
int64_t g_wait_gen = 0;  // guarded by g_wait_mu

// Op counters (METRICS + /healthz): the recorded fact behind "long-poll
// cut the coordinator request load" — requests served, waits that parked,
// parked waits woken by an event (the rest timed out).
std::atomic<int64_t> g_requests{0};
std::atomic<int64_t> g_longpolls_parked{0};
std::atomic<int64_t> g_longpolls_fired{0};

constexpr int64_t kWaitTimeoutCapMs = 60'000;
constexpr int64_t kWaitRecheckMs = 100;

void NotifyWaiters() {
  {
    std::lock_guard<std::mutex> lk(g_wait_mu);
    ++g_wait_gen;
  }
  g_wait_cv.notify_all();
}

// Park until the generation moves past `gen` or `chunk_ms` elapses.
void WaitChunk(int64_t gen, int64_t chunk_ms) {
  std::unique_lock<std::mutex> lk(g_wait_mu);
  if (g_wait_gen != gen) return;  // a command landed since the check
  g_wait_cv.wait_for(lk, std::chrono::milliseconds(chunk_ms),
                     [gen] { return g_wait_gen != gen; });
}

int64_t CurrentWaitGen() {
  std::lock_guard<std::mutex> lk(g_wait_mu);
  return g_wait_gen;
}

std::string FencedReply() {
  g_fencing_rejects.fetch_add(1);
  return "ERR fenced " + std::to_string(g_service->fence.load());
}

void SelfFence(int64_t newer_fence) {
  int expect = kPrimary;
  if (!g_role.compare_exchange_strong(expect, kFenced)) return;
  std::fprintf(stderr,
               "edl-coord: FENCED — a peer holds fencing token %lld "
               "(ours %lld); this node no longer serves\n",
               static_cast<long long>(newer_fence),
               static_cast<long long>(g_service->fence.load()));
  // wake every parked long-poll so it returns ERR fenced NOW instead of
  // at its next re-check tick
  NotifyWaiters();
}

// One request/response exchange with a replica over its persistent
// connection (redialing under backoff).  Returns 1 on an OK ack, 0 when
// the replica is unreachable, -1 when it rejected us with a newer fence
// (the caller must self-fence), 2 on a non-fence protocol refusal (ERR
// behind / ERR badblob — the replica is reachable but cannot apply what
// we sent; the caller falls back to a compaction checkpoint).  Caller
// holds g_repl_mu.
int ReplicaExchange(Replica& r, const std::string& line, bool is_sync) {
  int64_t now = NowMs();
  if (r.fd < 0) {
    if (now < r.next_dial_ms) return 0;
    // getaddrinfo, not inet_pton: replica endpoints are k8s service DNS
    // names in real deployments — a name that silently never resolved
    // would leave an "HA pair" with zero replication behind green acks
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (getaddrinfo(r.host.c_str(), std::to_string(r.port).c_str(),
                    &hints, &res) != 0 || res == nullptr) {
      r.next_dial_ms = now + kReplDialBackoffMs;
      return 0;
    }
    int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    // non-blocking connect with a bounded poll: this runs with
    // g_repl_mu held on the client-ack path, and a black-holed standby
    // (no RST) would otherwise pin it for the kernel's SYN-retry
    // minutes — 'an UNREACHABLE standby does not block the primary'
    // must hold for the connect too, not just the 5 s I/O below
    bool connected = false;
    if (fd >= 0) {
      int flags = fcntl(fd, F_GETFL, 0);
      fcntl(fd, F_SETFL, flags | O_NONBLOCK);
      int rc = connect(fd, res->ai_addr, res->ai_addrlen);
      if (rc != 0 && errno == EINPROGRESS) {
        pollfd p{fd, POLLOUT, 0};
        if (poll(&p, 1, 1000) == 1 && (p.revents & POLLOUT)) {
          int err = 0;
          socklen_t len = sizeof(err);
          getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
          rc = err == 0 ? 0 : -1;
        } else {
          rc = -1;
        }
      }
      if (rc == 0) {
        fcntl(fd, F_SETFL, flags);  // timed blocking I/O from here on
        connected = true;
      }
    }
    if (!connected) {
      if (fd >= 0) close(fd);
      freeaddrinfo(res);
      r.next_dial_ms = NowMs() + kReplDialBackoffMs;
      return 0;
    }
    freeaddrinfo(res);
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    timeval tv{5, 0};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    r.fd = fd;
  }
  size_t off = 0;
  while (off < line.size()) {
    ssize_t w = write(r.fd, line.data() + off, line.size() - off);
    if (w <= 0) {
      close(r.fd);
      r.fd = -1;
      r.next_dial_ms = now + kReplDialBackoffMs;
      return 0;
    }
    off += static_cast<size_t>(w);
  }
  if (is_sync && g_crash_point == "repl" && !g_replicas.empty() &&
      g_crash_on_persist != 0 &&
      g_repl_count.fetch_add(1) + 1 == g_crash_on_persist) {
    // primary-side replication-window crash: the stream is on the wire
    // but the client will never hear OK — at-least-once retries against
    // the promoted standby must converge
    _exit(137);
  }
  std::string resp;
  char c;
  while (resp.find('\n') == std::string::npos && resp.size() < 256) {
    ssize_t n = read(r.fd, &c, 1);
    if (n <= 0) {
      close(r.fd);
      r.fd = -1;
      r.next_dial_ms = NowMs() + kReplDialBackoffMs;
      return 0;
    }
    resp.push_back(c);
  }
  if (resp.rfind("OK", 0) == 0) return 1;
  if (resp.rfind("ERR fenced", 0) == 0) {
    // self-fence ONLY on a genuinely newer token: a stale or
    // misconfigured rejector (e.g. a re-attached node that still thinks
    // it is primary at an older fence) must not depose the rightful
    // primary — that would turn a recoverable config error into a total
    // control-plane outage
    long long newer = -1;
    std::sscanf(resp.c_str(), "ERR fenced %lld", &newer);
    if (newer > g_service->fence.load()) {
      SelfFence(newer);
      return -1;
    }
    g_repl_errors.fetch_add(1);
    return 0;
  }
  // protocol-level refusal that is not a fence (ERR behind / ERR badblob
  // from a delta the replica cannot apply, or a replica that is itself a
  // primary mid-reconfiguration): reachable but unapplied — the caller
  // decides (delta path falls back to a checkpoint)
  g_repl_errors.fetch_add(1);
  return 2;
}

// Stream the current state to every attached standby — as the op-log
// DELTA covering (replica position, head] when the log proves
// contiguity, else as a full compaction CHECKPOINT (the full snapshot
// stream; also the path for re-attaches, trimmed tails and rejected
// deltas).  Returns false iff this node got fenced (the caller replaces
// its client reply).
bool StreamToReplicas() {
  if (g_role.load() != kPrimary) return false;
  std::lock_guard<std::mutex> lk(g_repl_mu);
  if (g_replicas.empty()) return true;
  int64_t sv = g_service->StreamVersion();
  int64_t now = NowMs();
  {
    // a mutation the capture missed (TTL sweep, rollover outside a
    // captured verb) leaves the log head behind the live position: the
    // log can no longer prove contiguity — reset, checkpoint everyone
    std::lock_guard<std::mutex> lg(g_log_mu);
    if (g_log_to != sv) OpLogReset(sv);
  }
  bool all_current = true;
  bool any_behind_ready = false;
  for (auto& r : g_replicas) {
    all_current &= r.acked_version >= sv;
    any_behind_ready |= r.acked_version < sv &&
                        (r.fd >= 0 || now >= r.next_dial_ms);
  }
  if (!any_behind_ready)
    // everyone current, or down-and-backing-off: current is fine either
    // way; down means STRICT mode must refuse to ack what no mirror
    // holds (AVAILABLE mode serves on — the documented tradeoff)
    return all_current || !g_repl_lease_strict;
  const std::string fence_s = std::to_string(g_service->fence.load());
  std::string ckpt_line;  // built lazily: most rounds ship only deltas
  bool any_ok = false;
  for (auto& r : g_replicas) {
    if (r.acked_version >= sv) {
      any_ok = true;  // this mirror already holds the position
      continue;
    }
    std::string line;
    bool is_delta = false;
    if (r.acked_version >= 0) {
      std::lock_guard<std::mutex> lg(g_log_mu);
      std::string delta = OpLogDelta(r.acked_version, sv);
      if (!delta.empty()) {
        line = "SYNC " + fence_s + " " + std::to_string(sv) + " " +
               edlcoord::HexEncode(delta) + "\n";
        is_delta = true;
      }
    }
    if (!is_delta) {
      if (ckpt_line.empty())
        ckpt_line = "SYNC " + fence_s + " " + std::to_string(sv) + " " +
                    edlcoord::HexEncode(g_service->SnapshotRepl(now)) +
                    "\n";
      line = ckpt_line;
    }
    int rc = ReplicaExchange(r, line, /*is_sync=*/true);
    if (rc == -1) return false;  // fenced (SelfFence already ran)
    if (rc == 2 && is_delta) {
      // reachable but couldn't apply the delta (ERR behind/badblob):
      // fall back to a checkpoint NOW — leaving it behind until the
      // next mutation would be a silent redundancy hole
      r.acked_version = -1;
      if (ckpt_line.empty())
        ckpt_line = "SYNC " + fence_s + " " + std::to_string(sv) + " " +
                    edlcoord::HexEncode(g_service->SnapshotRepl(NowMs())) +
                    "\n";
      rc = ReplicaExchange(r, ckpt_line, /*is_sync=*/true);
      if (rc == -1) return false;
      is_delta = false;
      line = ckpt_line;
    }
    if (rc == 1) {
      r.acked_version = sv;
      any_ok = true;
      g_repl_bytes.fetch_add(static_cast<int64_t>(line.size()));
      (is_delta ? g_repl_delta_syncs : g_repl_ckpt_syncs).fetch_add(1);
    } else if (rc == 0) {
      g_repl_errors.fetch_add(1);
    }
  }
  if (any_ok) {
    g_last_repl_ok_ms.store(NowMs());
    g_repl_syncs.fetch_add(1);
  }
  // strict mode: an op NO standby acked must not be acked to the client
  // — the promoted standby is then never missing an acked op, which is
  // what makes promoting around a suspended primary safe
  return any_ok || !g_repl_lease_strict;
}

// Replication lease: a primary that has not successfully exchanged with a
// standby within g_repl_lease_ms must re-verify its claim before serving
// — this is what makes a GC-paused-then-resumed primary discover its
// deposition BEFORE handing a client stale state, instead of at its next
// mutation.  An unreachable standby leaves the lease unrenewed but does
// not block serving (availability when the standby is simply dead).
// Returns false iff fenced.
bool EnsureLease() {
  if (g_role.load() != kPrimary) return false;
  // lock-free fast path: this gate runs on EVERY client verb (and every
  // parked-wait wakeup) — while replication is off or the lease is
  // fresh it must not contend on g_repl_mu, which the keeper thread can
  // hold across multi-second blocking replica I/O
  if (!g_has_replicas.load()) return true;
  if (NowMs() - g_last_repl_ok_ms.load() < g_repl_lease_ms) return true;
  std::lock_guard<std::mutex> lk(g_repl_mu);
  if (g_replicas.empty()) return true;
  if (NowMs() - g_last_repl_ok_ms.load() < g_repl_lease_ms) return true;
  std::string line =
      "REPLHB " + std::to_string(g_service->fence.load()) + "\n";
  bool any_ok = false;
  for (auto& r : g_replicas) {
    int rc = ReplicaExchange(r, line, /*is_sync=*/false);
    if (rc == -1) return false;
    if (rc == 1) any_ok = true;
  }
  if (any_ok) {
    g_last_repl_ok_ms.store(NowMs());
    return true;
  }
  // no standby reachable and the lease is expired: AVAILABLE mode keeps
  // serving (a dead mirror must not halt the job), STRICT mode suspends
  // — recoverable, unlike a self-fence: serving resumes the moment a
  // standby answers a later probe
  return !g_repl_lease_strict;
}

using edlcoord::HexDecode;
using edlcoord::HexEncode;

std::vector<std::string> Split(const std::string& line) {
  std::vector<std::string> out;
  std::istringstream ss(line);
  std::string tok;
  while (ss >> tok) out.push_back(tok);
  return out;
}

std::string HandleImpl(const std::string& line, bool follower = false);
int64_t ProbeSweepNow();

// Control-plane verbs that every role answers; everything else is gated
// on being the fenced-in primary.  READ carries its own fence+version
// gate (that is its whole point: a version-gated read is servable from
// ANY role — doc/coordinator_scale.md §follower reads).
bool IsControlVerb(const std::string& cmd) {
  return cmd == "PING" || cmd == "CONFIG" || cmd == "METRICS" ||
         cmd == "ROLE" || cmd == "SYNC" || cmd == "REPLHB" ||
         cmd == "PROMOTE" || cmd == "REPLICATE" || cmd == "READ";
}

// Verbs whose success can move the durable version: serialized under
// g_mut_mu so captured op-log records can never interleave positions.
bool IsMutatingVerb(const std::string& cmd) {
  return cmd == "LEASE" || cmd == "ADD" || cmd == "COMPLETE" ||
         cmd == "FAIL" || cmd == "JOIN" || cmd == "LEAVE" ||
         cmd == "KVSET" || cmd == "KVDEL" || cmd == "KVCAS";
}

// One bad line must never take down the coordinator for the whole job.
std::string HandleGated(const std::string& cmd, const std::string& line) {
  const bool control = IsControlVerb(cmd);
  if (!control) {
    // Fencing gate: reads, writes and long-polls alike — a standby or a
    // deposed primary must never hand a client stale epoch/KV state.
    if (g_role.load() != kPrimary) return FencedReply();
    if (!EnsureLease()) return FencedReply();
  }
  std::string resp;
  const bool mut = IsMutatingVerb(cmd);
  if (mut) {
    std::unique_lock<std::mutex> ml(g_mut_mu);
    g_records.clear();
    const int64_t v0 = g_service->StreamVersion();
    try {
      resp = HandleImpl(line);
    } catch (const std::exception& e) {
      return std::string("ERR bad-arg ") + e.what();
    }
    const int64_t v1 = g_service->StreamVersion();
    OpLogAppend(v0, v1, g_records);
    ml.unlock();
    // mutating acks carry the post-op stream position: the client's
    // read-your-writes floor for version-gated follower reads (older
    // clients ignore the trailing token).  LEASE stays token-free — its
    // reply ends in a variable hex payload and leases need no RYW floor.
    if (v1 != v0 && cmd != "LEASE" && resp.rfind("OK", 0) == 0)
      resp += " v" + std::to_string(v1);
  } else {
    try {
      resp = HandleImpl(line);
    } catch (const std::exception& e) {
      return std::string("ERR bad-arg ") + e.what();
    }
  }
  // Persist BEFORE acking: once a worker sees OK for a COMPLETE or KVSET
  // — or an OK LEASE whose side effect rolled the pass over — a
  // coordinator restart must not forget it.  Replicate on the same
  // boundary: an acked op is on the standby before the client hears OK,
  // so a failover forgets nothing the client could have acted on — and a
  // deposed primary learns its fate HERE and refuses the ack.
  if (g_service->DurableVersion() != g_persisted_version.load()) {
    MaybePersist();
    if (!control && !StreamToReplicas()) resp = FencedReply();
  }
  // Wake parked long-polls AFTER the persist boundary, so a waiter that
  // fires and immediately acts can never observe un-persisted state.
  NotifyWaiters();
  return resp;
}

std::string Handle(const std::string& line) {
  const auto t0 = std::chrono::steady_clock::now();
  g_requests.fetch_add(1);
  std::string cmd = line.substr(0, line.find(' '));
  std::string resp = HandleGated(cmd, line);
  ObserveVerb(cmd, std::chrono::duration<double>(
                       std::chrono::steady_clock::now() - t0)
                       .count());
  return resp;
}

// Read-only verbs a follower may serve under the READ gate.
bool IsReadVerb(const std::string& cmd) {
  return cmd == "KVGET" || cmd == "KEYS" || cmd == "MEMBERS" ||
         cmd == "STATS" || cmd == "WAITEPOCH" || cmd == "KVWAIT" ||
         cmd == "KVWAITNE" || cmd == "METRICS" || cmd == "CONFIG" ||
         cmd == "PING";
}

//: how long a stale follower parks a version-gated read waiting for its
//: applied position to catch up before redirecting the client
constexpr int64_t kFollowerParkCapMs = 2000;

std::string HandleImpl(const std::string& line, bool follower) {
  std::vector<std::string> args = Split(line);
  if (args.empty()) return "ERR empty";
  const std::string& cmd = args[0];
  edlcoord::Service& s = *g_service;

  if (cmd == "PING") return "PONG";

  // Lets workers derive their heartbeat cadence from the server's actual
  // TTL instead of assuming the default.
  if (cmd == "CONFIG")
    return "OK " + std::to_string(g_task_timeout_ms) + " " +
           std::to_string(g_passes) + " " + std::to_string(g_member_ttl_ms);

  // -- HA control plane ----------------------------------------------------

  if (cmd == "ROLE") {
    const char* role = RoleName(g_role.load());
    // a strict-mode primary whose lease lapsed unanswered is SUSPENDED:
    // it answers every verb ERR fenced but is not deposed — report the
    // distinction so a client's failover probe routes around it
    // (promoting a reachable mirror) instead of re-targeting it forever
    if (g_role.load() == kPrimary && g_repl_lease_strict &&
        g_has_replicas.load() &&
        NowMs() - g_last_repl_ok_ms.load() > g_repl_lease_ms)
      role = "suspended";
    return std::string("OK ") + role + " " +
           std::to_string(g_service->fence.load()) + " " +
           std::to_string(g_service->StreamVersion());
  }

  if (cmd == "SYNC" && args.size() == 4) {
    std::lock_guard<std::mutex> ha(g_ha_mu);
    const int64_t f = std::stoll(args[1]);
    if (g_role.load() == kPrimary) {
      // fence == ours from another primary is the dual-primary collision
      // (two clients raced PROMOTE onto different standbys): equal
      // tokens can never depose each other through the stale-rejector
      // check, so the RECEIVER yields — one deterministic survivor
      // instead of silent divergence
      if (f == g_service->fence.load()) SelfFence(f);
      return FencedReply();  // a deposed primary is streaming at us
    }
    if (f < g_service->fence.load()) return FencedReply();
    std::string blob;
    if (!HexDecode(args[3], &blob)) return "ERR hex";
    if (blob.rfind("EDLDELTA1 ", 0) == 0) {
      // log-structured delta: apply only when contiguous with the
      // position this mirror durably holds — "ERR behind" makes the
      // primary fall back to a compaction checkpoint; torn or
      // unreplayable blobs reject (the dirty-mirror zeroing rule lives
      // in ApplyDeltaChecked, shared with the C ABI)
      const int64_t rc = g_service->ApplyDeltaChecked(blob, NowMs());
      if (rc == -2) return "ERR behind";
      if (rc < 0) return "ERR badblob";
    } else {
      if (!g_service->RestoreRepl(blob, NowMs())) return "ERR badblob";
    }
    if (f > g_service->fence.load()) g_service->fence.store(f);
    // a self-fenced ex-primary accepting a stream is provably a mirror
    // again: demote to standby so the pair regains real redundancy (and
    // the client's failover probe sees a promotable node, not a corpse)
    if (g_role.load() == kFenced) g_role.store(kStandby);
    g_repl_syncs.fetch_add(1);
    // persist BEFORE acking: the ack is the primary's licence to ack its
    // client, and promotion trusts the position this node claims — an
    // unpersisted claim would be a lie a crash exposes
    MaybePersist();
    if (g_crash_point == "repl" && g_crash_on_persist != 0 &&
        g_repl_count.fetch_add(1) + 1 == g_crash_on_persist) {
      // standby-side replication-window crash: durably applied but the
      // primary never hears the ack — a restart must come back owning
      // exactly the position it persisted
      _exit(137);
    }
    return "OK " + std::to_string(g_service->StreamVersion());
  }

  if (cmd == "REPLHB" && args.size() == 2) {
    std::lock_guard<std::mutex> ha(g_ha_mu);
    const int64_t f = std::stoll(args[1]);
    if (g_role.load() == kPrimary) {
      if (f == g_service->fence.load()) SelfFence(f);  // see SYNC
      return FencedReply();
    }
    if (f < g_service->fence.load()) return FencedReply();
    if (f > g_service->fence.load()) g_service->fence.store(f);
    return "OK " + std::to_string(g_service->fence.load());
  }

  if (cmd == "PROMOTE" && args.size() == 2) {
    std::lock_guard<std::mutex> ha(g_ha_mu);
    const int64_t f = std::stoll(args[1]);
    const int64_t cur = g_service->fence.load();
    if (g_role.load() == kPrimary) {
      // idempotent for racing promoters: the token only ratchets up
      if (f < cur) return "ERR stale " + std::to_string(cur);
      g_service->fence.store(f);
      return "OK " + std::to_string(f) + " " +
             std::to_string(g_service->StreamVersion());
    }
    if (f <= cur) return "ERR stale " + std::to_string(cur);
    g_service->fence.store(f);
    g_role.store(kPrimary);
    g_promotions.fetch_add(1);
    // every mirrored member gets a full TTL to re-heartbeat HERE before
    // the first expiry sweep may prune it — pruning would bump the epoch
    // and reform the very worlds the failover exists to not touch
    g_service->membership.RefreshAll(NowMs());
    g_last_repl_ok_ms.store(NowMs());  // no standby yet; lease is ours
    MaybePersist(/*force=*/true);  // the new fence must survive a restart
    std::fprintf(stderr, "edl-coord: promoted to primary, fence=%lld\n",
                 static_cast<long long>(f));
    NotifyWaiters();
    return "OK " + std::to_string(f) + " " +
           std::to_string(g_service->StreamVersion());
  }

  if (cmd == "REPLICATE" && args.size() == 2) {
    if (g_role.load() != kPrimary) return FencedReply();
    const size_t colon = args[1].rfind(':');
    if (colon == std::string::npos) return "ERR bad-endpoint";
    const int64_t sv0 = g_service->StreamVersion();
    {
      std::lock_guard<std::mutex> lk(g_repl_mu);
      bool known = false;
      for (auto& r : g_replicas)
        if (args[1] == r.host + ":" + std::to_string(r.port)) {
          known = true;
          // re-attach of a (possibly restarted) mirror: force a fresh
          // catch-up — its in-memory state is unknown
          r.acked_version = -1;
          r.next_dial_ms = 0;
          if (r.fd >= 0) {
            close(r.fd);
            r.fd = -1;
          }
        }
      if (!known) {
        Replica r;
        r.host = args[1].substr(0, colon);
        r.port = std::atoi(args[1].substr(colon + 1).c_str());
        g_replicas.push_back(r);
      }
      g_has_replicas.store(true);
    }
    // catch the standby up NOW, synchronously: until its first SYNC a
    // mirror holds only its stale file, and promoting it would forget
    // every op acked since — OK here means "the standby is current",
    // so a failed catch-up must answer ERR behind, not a false OK the
    // operator loop reads as restored redundancy
    if (!StreamToReplicas()) return FencedReply();
    {
      std::lock_guard<std::mutex> lk(g_repl_mu);
      for (const auto& r : g_replicas)
        if (args[1] == r.host + ":" + std::to_string(r.port) &&
            r.acked_version < sv0)
          return "ERR behind";
    }
    return "OK";
  }

  if (cmd == "LEASE" && args.size() == 2) {
    // a LEASE can roll the pass over — the only mutation it makes that
    // is snapshot-visible, captured as an 'R' record for the delta log
    const int p0 = s.queue.CurrentPass();
    edlcoord::Lease lease;
    const edlcoord::LeaseResult lr = s.queue.LeaseTask(args[1], NowMs(),
                                                       &lease);
    if (s.queue.CurrentPass() != p0) g_records.push_back("R");
    switch (lr) {
      case edlcoord::LeaseResult::kOk:
        return "OK " + std::to_string(lease.task_id) + " " +
               HexEncode(lease.payload);
      case edlcoord::LeaseResult::kEmpty:
        return "EMPTY";
      case edlcoord::LeaseResult::kAllDone:
        return "DONE";
    }
  }
  if (cmd == "ADD" && args.size() == 2) {
    std::string payload;
    if (args[1] != "-" && !HexDecode(args[1], &payload)) return "ERR hex";
    const int64_t id = s.queue.AddTask(payload);
    g_records.push_back("A " + std::to_string(id) + " " + args[1]);
    return "OK " + std::to_string(id);
  }
  if (cmd == "COMPLETE" && (args.size() == 2 || args.size() == 3)) {
    const int p0 = s.queue.CurrentPass();
    const int64_t id = std::stoll(args[1]);
    if (!s.queue.Complete(id, args.size() == 3 ? args[2] : ""))
      return "ERR";
    g_records.push_back("C " + std::to_string(id));
    if (s.queue.CurrentPass() != p0) g_records.push_back("R");
    return "OK";
  }
  if (cmd == "FAIL" && (args.size() == 2 || args.size() == 3)) {
    const int p0 = s.queue.CurrentPass();
    const int64_t id = std::stoll(args[1]);
    if (!s.queue.Fail(id, args.size() == 3 ? args[2] : "")) return "ERR";
    g_records.push_back("F " + std::to_string(id));
    if (s.queue.CurrentPass() != p0) g_records.push_back("R");
    return "OK";
  }
  if (cmd == "RENEW" && (args.size() == 2 || args.size() == 3))
    return s.queue.Renew(std::stoll(args[1]),
                         args.size() == 3 ? args[2] : "", NowMs())
               ? "OK"
               : "ERR";
  if (cmd == "RELEASE" && args.size() == 2)
    return "OK " + std::to_string(s.queue.ReleaseWorker(args[1]));
  if (cmd == "STATS") {
    int64_t todo, leased, done, dropped;
    s.queue.Stats(&todo, &leased, &done, &dropped);
    return "OK " + std::to_string(todo) + " " + std::to_string(leased) + " " +
           std::to_string(done) + " " + std::to_string(dropped) + " " +
           std::to_string(s.queue.CurrentPass());
  }

  if (cmd == "JOIN" && args.size() == 3) {
    const int64_t e0 = s.membership.Epoch();
    const std::string addr = args[2] == "-" ? "" : args[2];
    const int64_t e1 = s.membership.Join(args[1], addr, NowMs());
    if (e1 != e0)  // a refresh-join moves nothing: no record
      g_records.push_back("J " + HexEncode(args[1]) + " " +
                          (addr.empty() ? "-" : HexEncode(addr)));
    return "OK " + std::to_string(e1);
  }
  if (cmd == "HB" && args.size() == 2)
    return s.membership.Heartbeat(args[1], NowMs()) ? "OK" : "ERR rejoin";
  if (cmd == "KEEPALIVE" && args.size() == 2) {
    // coalesced heartbeat batch: one request renews every member slot a
    // supervisor host owns; expired names are reported back so the
    // owner re-JOINs exactly those (ERR rejoin semantics, batched)
    const int64_t now = NowMs();
    int64_t acked = 0;
    std::string expired;
    size_t start = 0;
    while (start < args[1].size()) {
      size_t comma = args[1].find(',', start);
      if (comma == std::string::npos) comma = args[1].size();
      const std::string name = args[1].substr(start, comma - start);
      if (!name.empty()) {
        if (s.membership.Heartbeat(name, now)) {
          ++acked;
        } else {
          if (!expired.empty()) expired += ',';
          expired += name;
        }
      }
      start = comma + 1;
    }
    return "OK " + std::to_string(acked) + " " +
           (expired.empty() ? "-" : expired);
  }
  if (cmd == "LEAVE" && args.size() == 2) {
    if (!s.membership.Leave(args[1])) return "ERR";
    g_records.push_back("L " + HexEncode(args[1]));
    return "OK";
  }
  if (cmd == "MEMBERS") {
    std::string list;
    // a follower never TTL-sweeps: its mirror sees no heartbeats, and
    // expiring from it would fabricate epoch bumps (same rule as the
    // standby's /healthz probe — ProbeSweepNow)
    const int64_t sweep =
        follower ? std::numeric_limits<int64_t>::min() : NowMs();
    for (const auto& m : s.membership.Members(sweep)) {
      if (!list.empty()) list += ',';
      list += m.name + "=" + m.address;
    }
    return "OK " + std::to_string(s.membership.Epoch()) + " " + list;
  }

  if (cmd == "KVSET" && args.size() == 3) {
    std::string v;
    if (args[2] != "-" && !HexDecode(args[2], &v)) return "ERR hex";
    s.kv.Set(args[1], v);
    g_records.push_back("K " + HexEncode(args[1]) + " " + args[2]);
    return "OK";
  }
  if (cmd == "KVGET" && args.size() == 2) {
    std::string v;
    if (!s.kv.Get(args[1], &v)) return "NONE";
    return "OK " + HexEncode(v);
  }
  if (cmd == "KVDEL" && args.size() == 2) {
    if (!s.kv.Del(args[1])) return "NONE";
    g_records.push_back("k " + HexEncode(args[1]));
    return "OK";
  }
  if (cmd == "KVCAS" && args.size() == 4) {
    std::string expect, v;
    if (args[2] != "-" && !HexDecode(args[2], &expect)) return "ERR hex";
    if (args[3] != "-" && !HexDecode(args[3], &v)) return "ERR hex";
    if (!s.kv.Cas(args[1], expect, v)) return "FAIL";
    // a winning CAS replicates as a plain put: the mirror needs the
    // outcome, not the race
    g_records.push_back("K " + HexEncode(args[1]) + " " + args[3]);
    return "OK";
  }
  if (cmd == "KEYS") {
    std::string prefix = args.size() > 1 ? args[1] : "";
    std::string list;
    for (const auto& k : s.kv.Keys(prefix)) {
      if (!list.empty()) list += ',';
      list += k;
    }
    return "OK " + list;
  }

  // Long-poll verbs.  Blocking here is safe: thread-per-connection means a
  // parked wait holds nothing but its own connection thread, and the core
  // is only touched briefly per re-check.  The epoch checks sweep TTL
  // expiry exactly like MEMBERS does, so a parked waiter is also the one
  // that notices a dead peer (its own sweep bumps the epoch and fires it).
  if (cmd == "WAITEPOCH" && args.size() == 3) {
    const int64_t known = std::stoll(args[1]);
    const int64_t timeout_ms =
        std::min(std::max<int64_t>(std::stoll(args[2]), 0), kWaitTimeoutCapMs);
    const auto deadline = std::chrono::steady_clock::now() +
                          std::chrono::milliseconds(timeout_ms);
    bool parked = false;
    for (;;) {
      // a wait that outlives this node's primacy must not hand the
      // waiter a stale epoch — SelfFence notifies, so this fires fast.
      // The lease is re-verified too (cheap when fresh): a GC-paused
      // deposed primary resuming INSIDE this loop would otherwise run
      // the expiry sweep below, fabricate an epoch bump from its frozen
      // member table, and fire the waiter with phantom membership before
      // the keeper thread gets around to fencing it.  A follower read
      // skips both gates — its epoch moves only when a stream applies,
      // and it never sweeps.
      if (!follower) {
        if (g_role.load() != kPrimary || !EnsureLease())
          return FencedReply();
      }
      const int64_t gen = CurrentWaitGen();
      if (!follower)
        s.membership.Members(NowMs());  // expiry sweep (may bump epoch)
      const int64_t epoch = s.membership.Epoch();
      if (epoch != known) {
        if (parked) g_longpolls_fired.fetch_add(1);
        return "OK " + std::to_string(epoch);
      }
      const auto now = std::chrono::steady_clock::now();
      if (now >= deadline) return "OK " + std::to_string(epoch);
      if (!parked) {
        parked = true;
        g_longpolls_parked.fetch_add(1);
      }
      const int64_t left = std::chrono::duration_cast<
          std::chrono::milliseconds>(deadline - now).count();
      WaitChunk(gen, std::min(left + 1, kWaitRecheckMs));
    }
  }
  if (cmd == "KVWAIT" && args.size() == 4) {
    const std::string& key = args[1];
    const int64_t timeout_ms =
        std::min(std::max<int64_t>(std::stoll(args[2]), 0), kWaitTimeoutCapMs);
    const bool watch_epoch = args[3] != "-";
    const int64_t known = watch_epoch ? std::stoll(args[3]) : 0;
    const auto deadline = std::chrono::steady_clock::now() +
                          std::chrono::milliseconds(timeout_ms);
    bool parked = false;
    for (;;) {
      // same role + lease re-verification as WAITEPOCH
      if (!follower) {
        if (g_role.load() != kPrimary || !EnsureLease())
          return FencedReply();
      }
      const int64_t gen = CurrentWaitGen();
      std::string v;
      if (s.kv.Get(key, &v)) {
        if (parked) g_longpolls_fired.fetch_add(1);
        return "OK " + HexEncode(v);
      }
      if (watch_epoch) {
        if (!follower) s.membership.Members(NowMs());
        const int64_t epoch = s.membership.Epoch();
        if (epoch != known) {
          if (parked) g_longpolls_fired.fetch_add(1);
          return "EPOCH " + std::to_string(epoch);
        }
      }
      const auto now = std::chrono::steady_clock::now();
      if (now >= deadline) return "NONE";
      if (!parked) {
        parked = true;
        g_longpolls_parked.fetch_add(1);
      }
      const int64_t left = std::chrono::duration_cast<
          std::chrono::milliseconds>(deadline - now).count();
      WaitChunk(gen, std::min(left + 1, kWaitRecheckMs));
    }
  }
  if (cmd == "KVWAITNE" && args.size() == 4) {
    // change-wait: park while the key's value equals <hexold> ("-" =
    // absent, so appearance fires too; "=" = the EMPTY value — a
    // wire token cannot be zero bytes, and conflating empty with
    // absent would fire instantly forever on an empty-valued key).
    // The serving weight watcher's long-poll — replaces its
    // fixed-interval lineage polling.
    const std::string& key = args[1];
    const bool old_absent = args[2] == "-";
    std::string old_val;
    if (!old_absent && args[2] != "=" &&
        !HexDecode(args[2], &old_val))
      return "ERR hex";
    const int64_t timeout_ms =
        std::min(std::max<int64_t>(std::stoll(args[3]), 0), kWaitTimeoutCapMs);
    const auto deadline = std::chrono::steady_clock::now() +
                          std::chrono::milliseconds(timeout_ms);
    bool parked = false;
    for (;;) {
      if (!follower) {
        if (g_role.load() != kPrimary || !EnsureLease())
          return FencedReply();
      }
      const int64_t gen = CurrentWaitGen();
      std::string v;
      const bool exists = s.kv.Get(key, &v);
      if (exists && (old_absent || v != old_val)) {
        if (parked) g_longpolls_fired.fetch_add(1);
        return "OK " + HexEncode(v);
      }
      if (!exists && !old_absent) {
        if (parked) g_longpolls_fired.fetch_add(1);
        return "GONE";
      }
      const auto now = std::chrono::steady_clock::now();
      if (now >= deadline) return "NONE";
      if (!parked) {
        parked = true;
        g_longpolls_parked.fetch_add(1);
      }
      const int64_t left = std::chrono::duration_cast<
          std::chrono::milliseconds>(deadline - now).count();
      WaitChunk(gen, std::min(left + 1, kWaitRecheckMs));
    }
  }
  if (cmd == "READ" && args.size() >= 4) {
    // version-gated follower read (doc/coordinator_scale.md): servable
    // from ANY role once this node has seen the client's fencing regime
    // and applied at least the client's read floor.  A stale follower
    // parks briefly for its stream to catch up (SYNC applies notify the
    // wait cv), then redirects the client to the primary.
    const int64_t f = std::stoll(args[1]);
    const int64_t minver = std::stoll(args[2]);
    if (f > g_service->fence.load())
      return "ERR stale " + std::to_string(g_service->fence.load());
    if (!IsReadVerb(args[3])) return "ERR readonly";
    const auto deadline = std::chrono::steady_clock::now() +
                          std::chrono::milliseconds(kFollowerParkCapMs);
    while (g_service->StreamVersion() < minver) {
      const int64_t gen = CurrentWaitGen();
      if (g_service->StreamVersion() >= minver) break;
      if (std::chrono::steady_clock::now() >= deadline)
        return "ERR behind " + std::to_string(g_service->StreamVersion());
      WaitChunk(gen, kWaitRecheckMs);
    }
    std::string inner = args[3];
    for (size_t i = 4; i < args.size(); ++i) inner += " " + args[i];
    g_follower_reads.fetch_add(1);
    // the inner verb runs sweep-free unless this node IS the primary
    // (then sweeping remains its job and the read is trivially current)
    return HandleImpl(inner, /*follower=*/g_role.load() != kPrimary);
  }
  if (cmd == "METRICS") {
    // extended tail: replication wire accounting + the O(store)
    // replication-snapshot size — member lines included, because THAT is
    // the blob the pre-PR stream shipped per mutation (the baseline the
    // bench diffs delta bytes against; sweep-free like every probe path
    // so a standby's METRICS cannot corrupt its mirror) + follower
    // reads.  The size is an O(store) serialization, so it recomputes
    // at most once per 5 s — a scraper polling METRICS must not turn
    // every sweep into a full-store walk under the service locks.
    static std::atomic<int64_t> snap_bytes{-1};
    static std::atomic<int64_t> snap_at_ms{-1};
    const int64_t now = NowMs();
    if (snap_bytes.load() < 0 || now - snap_at_ms.load() > 5000) {
      snap_bytes.store(static_cast<int64_t>(
          g_service->SnapshotRepl(ProbeSweepNow()).size()));
      snap_at_ms.store(now);
    }
    return "OK " + std::to_string(g_requests.load()) + " " +
           std::to_string(g_longpolls_parked.load()) + " " +
           std::to_string(g_longpolls_fired.load()) + " " +
           std::to_string(g_repl_bytes.load()) + " " +
           std::to_string(g_repl_delta_syncs.load()) + " " +
           std::to_string(g_repl_ckpt_syncs.load()) + " " +
           std::to_string(snap_bytes.load()) + " " +
           std::to_string(g_follower_reads.load());
  }
  return "ERR unknown";
}

// HTTP health endpoint (role of the reference master's :8080, the port its
// liveness was judged by, docker/paddle_k8s:27-31): GET /healthz returns
// 200 with queue/membership/kv stats as JSON; GET /metrics returns the
// same truth in Prometheus text exposition format (version 0.0.4) under
// the edl_coord_* namespace, so one scrape config covers this native
// backend and every Python-served /metrics route; any other path is 404.
// HTTP/1.0 + Connection: close per request — exactly what kubelet probes
// and `curl` speak, nothing more.  Serving it from the coord process (not
// a sidecar) is the point: a wedge that stops command processing also
// stops this socket's accept loop, so the probe fails and k8s restarts us.
// On a non-primary the membership mirror must NOT be TTL-swept (the
// standby sees no heartbeats; sweeping would corrupt the epoch it is
// guarding for promotion) — probes there observe without expiring.
int64_t ProbeSweepNow() {
  return g_role.load() == kPrimary ? NowMs()
                                   : std::numeric_limits<int64_t>::min();
}

std::string HealthBody() {
  int64_t todo, leased, done, dropped;
  g_service->queue.Stats(&todo, &leased, &done, &dropped);
  // Members() sweeps expired members exactly like the MEMBERS command —
  // the probe must observe (and persist) the same truth workers would.
  size_t members = g_service->membership.Members(ProbeSweepNow()).size();
  std::ostringstream js;
  js << "{\"status\":\"ok\",\"pass\":" << g_service->queue.CurrentPass()
     << ",\"tasks\":{\"todo\":" << todo << ",\"leased\":" << leased
     << ",\"done\":" << done << ",\"dropped\":" << dropped << "}"
     << ",\"epoch\":" << g_service->membership.Epoch()
     << ",\"members\":" << members
     << ",\"requests_served\":" << g_requests.load()
     << ",\"longpolls_parked\":" << g_longpolls_parked.load()
     << ",\"longpolls_fired\":" << g_longpolls_fired.load()
     << ",\"persisted_version\":" << g_persisted_version.load()
     << ",\"role\":\"" << RoleName(g_role.load()) << "\""
     << ",\"fence\":" << g_service->fence.load()
     << ",\"stream_version\":" << g_service->StreamVersion()
     << ",\"repl_bytes\":" << g_repl_bytes.load()
     << ",\"repl_deltas\":" << g_repl_delta_syncs.load()
     << ",\"repl_checkpoints\":" << g_repl_ckpt_syncs.load()
     << ",\"follower_reads\":" << g_follower_reads.load() << "}";
  return js.str();
}

// Prometheus text exposition of the same counters/gauges /healthz reports
// as JSON — the exposition-format twin of observability/metrics.py's
// MetricsRegistry.render() (same edl_ prefix, counters suffixed _total),
// so the Python and native coordinator backends are scrape-compatible.
std::string MetricsBody() {
  int64_t todo, leased, done, dropped;
  g_service->queue.Stats(&todo, &leased, &done, &dropped);
  size_t members = g_service->membership.Members(ProbeSweepNow()).size();
  std::ostringstream out;
  auto counter = [&out](const char* name, const char* help, int64_t v) {
    out << "# HELP " << name << " " << help << "\n"
        << "# TYPE " << name << " counter\n"
        << name << " " << v << "\n";
  };
  auto gauge = [&out](const char* name, const char* help,
                      const char* labels, int64_t v) {
    out << "# HELP " << name << " " << help << "\n"
        << "# TYPE " << name << " gauge\n"
        << name << labels << " " << v << "\n";
  };
  counter("edl_coord_requests_total", "protocol requests served",
          g_requests.load());
  counter("edl_coord_longpolls_parked_total",
          "long-poll waits that actually parked", g_longpolls_parked.load());
  counter("edl_coord_longpolls_fired_total",
          "parked waits woken by an event (rest timed out)",
          g_longpolls_fired.load());
  // one labeled family for the queue, matching the Python service's shape
  out << "# HELP edl_coord_queue_tasks task queue depth by state\n"
      << "# TYPE edl_coord_queue_tasks gauge\n"
      << "edl_coord_queue_tasks{state=\"todo\"} " << todo << "\n"
      << "edl_coord_queue_tasks{state=\"leased\"} " << leased << "\n"
      << "edl_coord_queue_tasks{state=\"done\"} " << done << "\n"
      << "edl_coord_queue_tasks{state=\"dropped\"} " << dropped << "\n";
  gauge("edl_coord_pass", "current task-queue pass", "",
        g_service->queue.CurrentPass());
  gauge("edl_coord_membership_epoch", "membership epoch", "",
        g_service->membership.Epoch());
  gauge("edl_coord_members", "live members", "",
        static_cast<int64_t>(members));
  gauge("edl_coord_persisted_version", "last durably persisted version", "",
        g_persisted_version.load());
  // HA: role (0=primary 1=standby 2=fenced), fencing token, replication
  // stream position + the fencing/replication counters
  gauge("edl_coord_role", "0=primary 1=standby 2=fenced", "",
        g_role.load());
  gauge("edl_coord_fence", "fencing token (bumped by every promotion)", "",
        g_service->fence.load());
  gauge("edl_coord_stream_version", "replication stream position", "",
        g_service->StreamVersion());
  counter("edl_coord_fencing_rejects_total",
          "commands rejected because this node is not the fenced-in "
          "primary",
          g_fencing_rejects.load());
  counter("edl_coord_repl_syncs_total",
          "replication streams acked (primary) / applied (standby)",
          g_repl_syncs.load());
  counter("edl_coord_repl_errors_total",
          "replication exchanges that failed (standby unreachable)",
          g_repl_errors.load());
  counter("edl_coord_promotions_total",
          "standby-to-primary promotions served", g_promotions.load());
  // log-structured replication accounting (doc/coordinator_scale.md):
  // wire bytes must grow O(delta) per mutation, not O(store) — the bench
  // and the CI control-plane smoke assert on these
  counter("edl_coord_repl_bytes_total",
          "replication wire bytes streamed (deltas + checkpoints)",
          g_repl_bytes.load());
  counter("edl_coord_repl_deltas_total",
          "replication exchanges shipped as op-log deltas",
          g_repl_delta_syncs.load());
  counter("edl_coord_repl_checkpoints_total",
          "replication exchanges shipped as compaction checkpoints",
          g_repl_ckpt_syncs.load());
  counter("edl_coord_follower_reads_total",
          "version-gated READ verbs served", g_follower_reads.load());
  // per-verb latency histogram: the bench's control-plane attribution
  // signal.  Only verbs actually observed render, so an idle server's
  // exposition stays lean.
  out << "# HELP edl_coord_verb_seconds request latency by verb\n"
      << "# TYPE edl_coord_verb_seconds histogram\n";
  for (size_t i = 0; i < kNVerbs; ++i) {
    VerbHist& h = g_verb_hists[i];
    const int64_t count = h.count.load();
    if (count == 0) continue;
    int64_t cum = 0;
    for (size_t b = 0; b < kNVerbBuckets; ++b) {
      cum += h.buckets[b].load();
      std::ostringstream le;
      le << kVerbBucketsS[b];
      out << "edl_coord_verb_seconds_bucket{verb=\"" << h.name
          << "\",le=\"" << le.str() << "\"} " << cum << "\n";
    }
    out << "edl_coord_verb_seconds_bucket{verb=\"" << h.name
        << "\",le=\"+Inf\"} " << count << "\n";
    out << "edl_coord_verb_seconds_sum{verb=\"" << h.name << "\"} "
        << (static_cast<double>(h.sum_us.load()) / 1e6) << "\n";
    out << "edl_coord_verb_seconds_count{verb=\"" << h.name << "\"} "
        << count << "\n";
  }
  return out.str();
}

// probes in flight; new connections beyond the cap are shed (closed) so a
// flood cannot fan out into unbounded threads — the kubelet just retries
std::atomic<int> g_health_inflight{0};
std::atomic<int> g_health_shed_drains{0};

void ServeHealth(int fd) {
  std::string req;
  char chunk[1024];
  // total-request deadline: SO_RCVTIMEO is per-read, so a client trickling
  // one byte per read could otherwise hold a probe slot for hours
  const auto deadline =
      std::chrono::steady_clock::now() + std::chrono::seconds(5);
  while (req.find("\r\n\r\n") == std::string::npos && req.size() < 8192) {
    if (std::chrono::steady_clock::now() > deadline) {
      close(fd);
      return;
    }
    ssize_t n = read(fd, chunk, sizeof(chunk));
    if (n <= 0) break;
    req.append(chunk, static_cast<size_t>(n));
  }
  std::istringstream ss(req);
  std::string method, path;
  ss >> method >> path;
  std::string status = "200 OK", body;
  std::string content_type = "application/json";
  if (method == "GET" && (path == "/healthz" || path == "/")) {
    body = HealthBody();
    // the sweep inside HealthBody may have bumped the epoch; make it
    // durable AND mirrored on the same boundary every command uses — a
    // persisted-but-unstreamed epoch bump would survive locally yet
    // regress on the standby a failover promotes moments later
    MaybePersist();
    StreamToReplicas();
  } else if (method == "GET" && path == "/metrics") {
    body = MetricsBody();
    content_type = "text/plain; version=0.0.4; charset=utf-8";
    MaybePersist();  // same sweep-durability boundary as /healthz
    StreamToReplicas();
  } else {
    status = "404 Not Found";
    body = "{\"error\":\"not found\"}";
  }
  std::ostringstream resp;
  resp << "HTTP/1.0 " << status << "\r\nContent-Type: " << content_type
       << "\r\nContent-Length: "
       << body.size() << "\r\nConnection: close\r\n\r\n"
       << body;
  const std::string out = resp.str();
  size_t off = 0;
  while (off < out.size()) {
    ssize_t w = write(fd, out.data() + off, out.size() - off);
    if (w <= 0) break;
    off += static_cast<size_t>(w);
  }
  close(fd);
}

// Connection state shared between the reader thread and any off-thread
// tagged park verbs: responses serialize on write_mu, the fd closes only
// when the last holder drops (a detached park thread must never write to
// a recycled descriptor).
struct ConnState {
  explicit ConnState(int fd_in) : fd(fd_in) {}
  ~ConnState() { close(fd); }
  int fd;
  std::mutex write_mu;
  std::atomic<bool> closed{false};
  std::atomic<int> inflight{0};

  bool WriteLine(const std::string& resp) {
    std::lock_guard<std::mutex> lk(write_mu);
    if (closed.load()) return false;
    size_t off = 0;
    while (off < resp.size()) {
      ssize_t w = write(fd, resp.data() + off, resp.size() - off);
      if (w <= 0) {
        closed.store(true);
        return false;
      }
      off += static_cast<size_t>(w);
    }
    return true;
  }
};

//: off-thread tagged parks per connection; beyond this the request is
//: handled inline (backpressure), which a well-behaved mux client never
//: hits (its chunked parks are ~1 per member slot)
constexpr int kMaxConnParks = 1024;

// Park verbs block their handling thread; a TAGGED one runs off-thread
// so a multiplexed connection carrying interleaved requests for many
// member slots is never head-of-line-blocked behind a parked wait.
// READ counts too: its version gate can park, and so can its inner verb.
bool IsParkVerb(const std::string& cmd) {
  return cmd == "WAITEPOCH" || cmd == "KVWAIT" || cmd == "KVWAITNE" ||
         cmd == "READ";
}

void Serve(int fd) {
  auto st = std::make_shared<ConnState>(fd);
  std::string buf;
  char chunk[4096];
  for (;;) {
    ssize_t n = read(fd, chunk, sizeof(chunk));
    if (n <= 0) break;
    buf.append(chunk, static_cast<size_t>(n));
    size_t pos;
    while ((pos = buf.find('\n')) != std::string::npos) {
      std::string line = buf.substr(0, pos);
      buf.erase(0, pos + 1);
      if (!line.empty() && line.back() == '\r') line.pop_back();
      // multiplex framing: "#<id> <verb...>" answers "#<id> <reply...>";
      // tagged responses may interleave (that is the contract a mux
      // client opts into), plain pipelined lines stay strictly in-order
      std::string tag, cmdline = line;
      if (!line.empty() && line[0] == '#') {
        const size_t sp = line.find(' ');
        if (sp != std::string::npos && sp > 1) {
          tag = line.substr(0, sp);
          cmdline = line.substr(sp + 1);
        }
      }
      const std::string cmd = cmdline.substr(0, cmdline.find(' '));
      if (!tag.empty() && IsParkVerb(cmd) &&
          st->inflight.load() < kMaxConnParks) {
        st->inflight.fetch_add(1);
        std::thread([st, tag, cmdline]() {
          st->WriteLine(tag + " " + Handle(cmdline) + "\n");
          st->inflight.fetch_sub(1);
        }).detach();
        continue;
      }
      const std::string resp =
          (tag.empty() ? "" : tag + " ") + Handle(cmdline) + "\n";
      if (!st->WriteLine(resp)) {
        shutdown(fd, SHUT_RDWR);
        return;  // ~ConnState closes the fd once park threads finish
      }
    }
  }
  st->closed.store(true);
  shutdown(fd, SHUT_RDWR);
}

}  // namespace

int main(int argc, char** argv) {
  int port = 7164;
  int health_port = -1;  // -1 = disabled; 0 = OS-assigned (tests)
  int64_t task_timeout_ms = edlcoord::kDefaultTaskTimeoutMs;
  int passes = 1;
  int64_t member_ttl_ms = edlcoord::kDefaultMemberTtlMs;
  std::string state_file;
  bool standby = false;
  std::string replicate_to;  // "host:port[,host:port...]"
  for (int i = 1; i + 1 < argc; i += 2) {
    std::string flag = argv[i];
    if (flag == "--port") port = std::atoi(argv[i + 1]);
    if (flag == "--health-port") health_port = std::atoi(argv[i + 1]);
    if (flag == "--task-timeout-ms") task_timeout_ms = std::atoll(argv[i + 1]);
    if (flag == "--passes") passes = std::atoi(argv[i + 1]);
    if (flag == "--member-ttl-ms") member_ttl_ms = std::atoll(argv[i + 1]);
    if (flag == "--state-file") state_file = argv[i + 1];
    if (flag == "--standby") standby = std::atoi(argv[i + 1]) != 0;
    if (flag == "--replicate-to") replicate_to = argv[i + 1];
    if (flag == "--repl-lease-ms") g_repl_lease_ms = std::atoll(argv[i + 1]);
    if (flag == "--repl-lease-strict")
      g_repl_lease_strict = std::atoi(argv[i + 1]) != 0;
    if (flag == "--crash-on-persist") {
      // "<N>:<point>" e.g. "2:tmp" — test-only fault injection
      std::string v = argv[i + 1];
      size_t colon = v.find(':');
      if (colon != std::string::npos) {
        g_crash_on_persist = std::atoi(v.substr(0, colon).c_str());
        g_crash_point = v.substr(colon + 1);
      }
    }
  }
  signal(SIGPIPE, SIG_IGN);
  g_task_timeout_ms = task_timeout_ms;
  g_passes = passes;
  g_member_ttl_ms = member_ttl_ms;
  g_service = new edlcoord::Service(task_timeout_ms, passes, member_ttl_ms);
  g_state_file = state_file;
  bool restored = !state_file.empty() && g_service->LoadFrom(state_file);
  // Baseline the persist gate in every case: after a restore, what's on
  // disk IS the current state; on a fresh start (or a present-but-
  // unloadable file) only an actual mutation may write — a read-only
  // command like PING must never replace an unloadable file the operator
  // may still want to inspect with an empty snapshot.
  g_persisted_version.store(g_service->DurableVersion());
  // op-log head starts at the restored position: the first stream to any
  // replica is necessarily a checkpoint (nothing retained), deltas flow
  // from the first captured mutation after that
  g_log_to = g_service->StreamVersion();
  if (!state_file.empty() && !restored &&
      access(state_file.c_str(), F_OK) == 0) {
    // a present-but-unloadable file is a serious event — start fresh (a
    // crash-loop would be worse: no coordinator at all), but say so
    std::fprintf(stderr,
                 "edl-coord: state file %s exists but could not be "
                 "restored; starting with empty state\n",
                 state_file.c_str());
  }
  // HA wiring: role from flags (the state file carries fence + stream
  // position across restarts, never the role — a respawned pod is told
  // what it is by its manifest/harness, not by a file that predates the
  // failover it missed).
  if (standby) g_role.store(kStandby);
  if (!replicate_to.empty()) {
    size_t start = 0;
    while (start < replicate_to.size()) {
      size_t comma = replicate_to.find(',', start);
      if (comma == std::string::npos) comma = replicate_to.size();
      std::string ep = replicate_to.substr(start, comma - start);
      size_t colon = ep.rfind(':');
      if (colon != std::string::npos) {
        Replica r;
        r.host = ep.substr(0, colon);
        r.port = std::atoi(ep.substr(colon + 1).c_str());
        g_replicas.push_back(r);
      }
      start = comma + 1;
    }
    g_has_replicas.store(!g_replicas.empty());
  }

  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  if (listen(srv, 128) != 0) {
    perror("listen");
    return 1;
  }
  // Report the actually-bound port (supports --port 0 for tests).
  socklen_t alen = sizeof(addr);
  getsockname(srv, reinterpret_cast<sockaddr*>(&addr), &alen);
  // the listen banner must stay the FIRST line: spawn_server parses it
  std::printf("edl-coord listening on %d\n", ntohs(addr.sin_port));
  if (health_port >= 0) {
    int hs = socket(AF_INET, SOCK_STREAM, 0);
    setsockopt(hs, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in haddr{};
    haddr.sin_family = AF_INET;
    haddr.sin_addr.s_addr = htonl(INADDR_ANY);
    haddr.sin_port = htons(static_cast<uint16_t>(health_port));
    if (bind(hs, reinterpret_cast<sockaddr*>(&haddr), sizeof(haddr)) != 0 ||
        listen(hs, 16) != 0) {
      perror("health bind");
      return 1;
    }
    socklen_t hlen = sizeof(haddr);
    getsockname(hs, reinterpret_cast<sockaddr*>(&haddr), &hlen);
    // SECOND line when enabled: spawn_server(health_port=...) parses it
    std::printf("edl-coord health listening on %d\n", ntohs(haddr.sin_port));
    std::thread([hs]() {
      for (;;) {
        int fd = accept(hs, nullptr, nullptr);
        if (fd < 0) {
          // persistent failures (EMFILE under fd exhaustion) must not
          // hot-spin the core the kubelet's probes depend on
          usleep(100 * 1000);
          continue;
        }
        // a stalled probe client must not pin a thread forever
        timeval tv{2, 0};
        setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
        setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
        // bounded concurrency: each probe gets its own thread (one slow
        // client can't block the kubelet's next probe) but at most 8 are
        // in flight — beyond that, shed the connection instead of
        // spawning unbounded threads.  Shed WITH a minimal 503: a bare
        // close reads as connection-reset, which a kubelet probe counts
        // toward the liveness failureThreshold exactly like a wedged
        // coordinator — during a connection flood that restarts a
        // healthy server.  A 503 says "overloaded, not dead"
        // (a best-effort write: the socket already has SNDTIMEO).
        if (g_health_inflight.fetch_add(1) >= 8) {
          g_health_inflight.fetch_sub(1);
          static const char kShed[] =
              "HTTP/1.1 503 Service Unavailable\r\n"
              "Content-Type: application/json\r\nContent-Length: 22\r\n"
              "Connection: close\r\n\r\n{\"error\":\"overloaded\"}";
          (void)!write(fd, kShed, sizeof(kShed) - 1);
          // drain the probe's request before close(): closing with
          // unread received bytes sends RST, which can flush the
          // buffered 503 client-side and read as exactly the
          // connection-reset this reply exists to avoid.  The drain
          // must NOT run on the accept loop (a trickling client would
          // stall real probes behind it), so hand the fd to a
          // short-lived drain thread — itself capped; past the cap the
          // 503 is best-effort and the fd just closes.
          shutdown(fd, SHUT_WR);
          if (g_health_shed_drains.fetch_add(1) < 32) {
            std::thread([fd]() {
              timeval fast{0, 100 * 1000};
              setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &fast, sizeof(fast));
              char drain[512];
              for (int i = 0;
                   i < 4 && read(fd, drain, sizeof(drain)) > 0; ++i) {
              }
              close(fd);
              g_health_shed_drains.fetch_sub(1);
            }).detach();
          } else {
            g_health_shed_drains.fetch_sub(1);
            close(fd);
          }
          continue;
        }
        std::thread([fd]() {
          ServeHealth(fd);
          g_health_inflight.fetch_sub(1);
        }).detach();
      }
    }).detach();
  }
  if (restored) {
    int64_t todo, leased, done, dropped;
    g_service->queue.Stats(&todo, &leased, &done, &dropped);
    std::printf("edl-coord restored state: todo=%lld done=%lld epoch=%lld\n",
                static_cast<long long>(todo), static_cast<long long>(done),
                static_cast<long long>(g_service->membership.Epoch()));
  }
  if (standby || !g_replicas.empty())
    std::printf("edl-coord role=%s fence=%lld version=%lld\n",
                RoleName(g_role.load()),
                static_cast<long long>(g_service->fence.load()),
                static_cast<long long>(g_service->StreamVersion()));
  std::fflush(stdout);

  // Replication keeper (primary side): keeps the lease warm while idle —
  // so fencing is discovered within a lease period even with no client
  // traffic — and pushes catch-up streams to a standby that was down or
  // freshly attached (REPLICATE) without waiting for the next mutation.
  // started unconditionally: a promoted standby can grow replicas later
  // via REPLICATE, and must then keep ITS lease warm too
  std::thread([]() {
    for (;;) {
      usleep(static_cast<useconds_t>(
          std::max<int64_t>(g_repl_lease_ms / 3, 100) * 1000));
      if (g_role.load() != kPrimary) continue;
      // TTL-expiry sweep: liveness truth must not depend on client
      // traffic reaching the primary — with follower reads spreading
      // MEMBERS/WAITEPOCH onto the standbys (which never sweep), a
      // fully-offloaded read path would otherwise keep a dead member
      // alive forever and no parked wait would ever reform around it.
      const int64_t e0 = g_service->membership.Epoch();
      g_service->membership.Members(NowMs());
      MaybePersist();  // a swept bump is durable+mirrored like any other
      StreamToReplicas();
      EnsureLease();
      if (g_service->membership.Epoch() != e0) NotifyWaiters();
    }
  }).detach();

  for (;;) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) {
      usleep(10 * 1000);  // same anti-hot-spin guard as the health loop
      continue;
    }
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::thread(Serve, fd).detach();
  }
}
