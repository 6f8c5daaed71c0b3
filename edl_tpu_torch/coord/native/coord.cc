// Implementation of the edl_tpu_torch coordination core. See coord.hpp.

#include "coord.hpp"

#include <fcntl.h>
#include <unistd.h>

#include <cerrno>

#include <algorithm>
#include <cstdio>
#include <sstream>

namespace edlcoord {

std::string HexEncode(const std::string& in) {
  static const char* d = "0123456789abcdef";
  std::string out;
  out.reserve(in.size() * 2);
  for (unsigned char c : in) {
    out += d[c >> 4];
    out += d[c & 0xf];
  }
  return out;
}

namespace {

int HexVal(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

}  // namespace

bool HexDecode(const std::string& in, std::string* out) {
  if (in.size() % 2 != 0) return false;
  out->clear();
  out->reserve(in.size() / 2);
  for (size_t i = 0; i < in.size(); i += 2) {
    int hi = HexVal(in[i]), lo = HexVal(in[i + 1]);
    if (hi < 0 || lo < 0) return false;
    out->push_back(static_cast<char>((hi << 4) | lo));
  }
  return true;
}

// ---------------------------------------------------------------- TaskQueue

TaskQueue::TaskQueue(int64_t timeout_ms, int passes, int max_failures)
    : timeout_ms_(timeout_ms),
      total_passes_(passes < 1 ? 1 : passes),
      max_failures_(max_failures) {}

int64_t TaskQueue::AddTask(const std::string& payload) {
  std::lock_guard<std::mutex> lock(mu_);
  Task t;
  t.id = next_id_++;
  t.payload = payload;
  todo_.push_back(std::move(t));
  version_.fetch_add(1);
  return next_id_ - 1;
}

LeaseResult TaskQueue::LeaseTask(const std::string& worker, int64_t now_ms,
                                 Lease* out) {
  std::lock_guard<std::mutex> lock(mu_);
  // Reclaim expired leases first so a dead trainer's tasks flow to the
  // living (the master's 16 s re-dispatch semantics).
  for (auto it = leased_.begin(); it != leased_.end();) {
    if (it->second.deadline_ms <= now_ms) {
      todo_.push_back(std::move(it->second.task));
      it = leased_.erase(it);
    } else {
      ++it;
    }
  }
  MaybeAdvancePass();
  if (todo_.empty()) {
    bool finished = leased_.empty() && pass_ + 1 >= total_passes_;
    return finished ? LeaseResult::kAllDone : LeaseResult::kEmpty;
  }
  Task t = std::move(todo_.front());
  todo_.pop_front();
  Leased l;
  l.worker = worker;
  l.deadline_ms = now_ms + timeout_ms_;
  out->task_id = t.id;
  out->payload = t.payload;
  l.task = std::move(t);
  leased_[out->task_id] = std::move(l);
  return LeaseResult::kOk;
}

bool TaskQueue::Complete(int64_t task_id, const std::string& worker) {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = leased_.find(task_id);
  if (it == leased_.end()) return false;  // late completion after re-dispatch
  if (!worker.empty() && it->second.worker != worker) return false;
  done_.push_back(std::move(it->second.task));
  leased_.erase(it);
  version_.fetch_add(1);  // pending→done is a snapshot-visible move
  MaybeAdvancePass();
  return true;
}

bool TaskQueue::Fail(int64_t task_id, const std::string& worker) {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = leased_.find(task_id);
  if (it == leased_.end()) return false;
  if (!worker.empty() && it->second.worker != worker) return false;
  Task t = std::move(it->second.task);
  leased_.erase(it);
  t.failures += 1;
  if (t.failures >= max_failures_) {
    dropped_ += 1;  // poison pill: drop rather than wedge the pass
  } else {
    todo_.push_back(std::move(t));
  }
  version_.fetch_add(1);  // failure count / dropped counter changed
  MaybeAdvancePass();
  return true;
}

bool TaskQueue::Renew(int64_t task_id, const std::string& worker,
                      int64_t now_ms) {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = leased_.find(task_id);
  if (it == leased_.end()) return false;
  if (!worker.empty() && it->second.worker != worker) return false;
  it->second.deadline_ms = now_ms + timeout_ms_;
  return true;
}

bool TaskQueue::PeekLeased(int64_t task_id, std::string* payload) const {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = leased_.find(task_id);
  if (it == leased_.end()) return false;
  *payload = it->second.task.payload;
  return true;
}

int TaskQueue::Redispatch(int64_t now_ms) {
  std::lock_guard<std::mutex> lock(mu_);
  int n = 0;
  for (auto it = leased_.begin(); it != leased_.end();) {
    if (it->second.deadline_ms <= now_ms) {
      todo_.push_back(std::move(it->second.task));
      it = leased_.erase(it);
      ++n;
    } else {
      ++it;
    }
  }
  return n;
}

int TaskQueue::ReleaseWorker(const std::string& worker) {
  std::lock_guard<std::mutex> lock(mu_);
  int n = 0;
  for (auto it = leased_.begin(); it != leased_.end();) {
    if (it->second.worker == worker) {
      todo_.push_back(std::move(it->second.task));
      it = leased_.erase(it);
      ++n;
    } else {
      ++it;
    }
  }
  return n;
}

void TaskQueue::MaybeAdvancePass() {
  // Called with mu_ held. A pass ends when nothing is waiting or leased;
  // earlier passes recycle the done tasks (multi-pass training,
  // `passes` in the job spec — reference pkg/resource/training_job.go:125).
  if (!todo_.empty() || !leased_.empty()) return;
  if (pass_ + 1 < total_passes_) {
    if (!done_.empty()) {
      for (auto& t : done_) {
        t.failures = 0;
        todo_.push_back(std::move(t));
      }
      done_.clear();
      pass_ += 1;
    } else {
      // Nothing survives to recycle (zero tasks, or every task dropped as
      // a poison pill): later passes would be empty too — finish now
      // instead of livelocking every LeaseTask on kEmpty.
      pass_ = total_passes_ - 1;
    }
    // Reached from LeaseTask too (a lease can trigger rollover): bump so
    // the server persists even though LEASE itself is not a "mutating"
    // command — a crash after the rollover must not replay the old pass.
    version_.fetch_add(1);
  }
}

bool TaskQueue::ReplayAdd(int64_t id, const std::string& payload) {
  std::lock_guard<std::mutex> lock(mu_);
  Task t;
  t.id = id;
  t.payload = payload;
  todo_.push_back(std::move(t));
  if (id + 1 > next_id_) next_id_ = id + 1;
  version_.fetch_add(1);
  return true;
}

bool TaskQueue::ReplayComplete(int64_t id) {
  std::lock_guard<std::mutex> lock(mu_);
  // the mirror holds the task in todo (leases never replicate); find by
  // id, move to done — same end state the primary's Complete reached
  for (auto it = todo_.begin(); it != todo_.end(); ++it) {
    if (it->id == id) {
      done_.push_back(std::move(*it));
      todo_.erase(it);
      version_.fetch_add(1);
      return true;
    }
  }
  return false;  // diverged mirror: caller falls back to a checkpoint
}

bool TaskQueue::ReplayFail(int64_t id) {
  std::lock_guard<std::mutex> lock(mu_);
  for (auto it = todo_.begin(); it != todo_.end(); ++it) {
    if (it->id == id) {
      it->failures += 1;
      if (it->failures >= max_failures_) {
        dropped_ += 1;
        todo_.erase(it);
      }
      version_.fetch_add(1);
      return true;
    }
  }
  return false;
}

void TaskQueue::ForceAdvance() {
  std::lock_guard<std::mutex> lock(mu_);
  MaybeAdvancePass();
}

void TaskQueue::Clear() {
  std::lock_guard<std::mutex> lock(mu_);
  todo_.clear();
  leased_.clear();
  done_.clear();
  pass_ = 0;
  next_id_ = 0;
  dropped_ = 0;
  version_.fetch_add(1);
}

bool TaskQueue::AllDone() const {
  std::lock_guard<std::mutex> lock(mu_);
  return todo_.empty() && leased_.empty() && pass_ + 1 >= total_passes_;
}

int TaskQueue::CurrentPass() const {
  std::lock_guard<std::mutex> lock(mu_);
  return pass_;
}

void TaskQueue::Stats(int64_t* todo, int64_t* leased, int64_t* done,
                      int64_t* dropped) const {
  std::lock_guard<std::mutex> lock(mu_);
  *todo = static_cast<int64_t>(todo_.size());
  *leased = static_cast<int64_t>(leased_.size());
  *done = static_cast<int64_t>(done_.size());
  *dropped = dropped_;
}

void TaskQueue::SerializeTo(std::string* out) const {
  std::lock_guard<std::mutex> lock(mu_);
  *out += "Q " + std::to_string(pass_) + " " + std::to_string(next_id_) +
          " " + std::to_string(dropped_) + "\n";
  // todo + leased serialize as one id-sorted T section: a restarted
  // coordinator does not know which workers still live, so leased tasks
  // come back as todo and re-dispatch (at-least-once, the lease-timeout
  // contract).  Sorting by id makes the snapshot insensitive to HOW work
  // is currently split between todo and leases — a LEASE/RENEW/RELEASE
  // leaves the serialized form byte-identical, keeping the hot dispatch
  // path free of disk writes (the server persists on content change).
  std::vector<const Task*> pending;
  pending.reserve(todo_.size() + leased_.size());
  for (const auto& t : todo_) pending.push_back(&t);
  for (const auto& kv : leased_) pending.push_back(&kv.second.task);
  std::sort(pending.begin(), pending.end(),
            [](const Task* a, const Task* b) { return a->id < b->id; });
  // empty binary fields serialize as "-" (the wire protocol's framing):
  // a bare trailing space would fail the stream parser and silently drop
  // the entry from a restored/replicated snapshot
  for (const Task* t : pending)
    *out += "T " + std::to_string(t->id) + " " + std::to_string(t->failures) +
            " " + (t->payload.empty() ? "-" : HexEncode(t->payload)) + "\n";
  for (const auto& t : done_)
    *out += "D " + std::to_string(t.id) + " " + std::to_string(t.failures) +
            " " + (t.payload.empty() ? "-" : HexEncode(t.payload)) + "\n";
}

void TaskQueue::RestoreLine(const std::string& line) {
  std::istringstream ss(line);
  std::string tag;
  ss >> tag;
  std::lock_guard<std::mutex> lock(mu_);
  if (tag == "Q") {
    int pass;
    int64_t next_id, dropped;
    ss >> pass >> next_id >> dropped;
    if (!ss.fail()) {
      pass_ = pass;
      next_id_ = next_id;
      dropped_ = dropped;
    }
    return;
  }
  if (tag == "T" || tag == "D") {
    Task t;
    std::string hex;
    ss >> t.id >> t.failures >> hex;
    if (ss.fail()) return;
    if (hex != "-" && !HexDecode(hex, &t.payload)) return;
    if (tag == "T")
      todo_.push_back(std::move(t));
    else
      done_.push_back(std::move(t));
  }
}

// --------------------------------------------------------------- Membership

Membership::Membership(int64_t ttl_ms) : ttl_ms_(ttl_ms) {}

int64_t Membership::Join(const std::string& name, const std::string& address,
                         int64_t now_ms) {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = members_.find(name);
  bool change = it == members_.end() || it->second.address != address;
  MemberInfo& m = members_[name];
  m.name = name;
  m.address = address;
  m.deadline_ms = now_ms + ttl_ms_;
  if (change) {
    epoch_ += 1;
    version_.fetch_add(1);
  }
  return epoch_;
}

bool Membership::Heartbeat(const std::string& name, int64_t now_ms) {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = members_.find(name);
  if (it == members_.end()) return false;
  it->second.deadline_ms = now_ms + ttl_ms_;
  return true;
}

bool Membership::Leave(const std::string& name) {
  std::lock_guard<std::mutex> lock(mu_);
  if (members_.erase(name) == 0) return false;
  epoch_ += 1;
  version_.fetch_add(1);
  return true;
}

int Membership::Expire(int64_t now_ms) {
  std::lock_guard<std::mutex> lock(mu_);
  int n = 0;
  for (auto it = members_.begin(); it != members_.end();) {
    if (it->second.deadline_ms <= now_ms) {
      it = members_.erase(it);
      ++n;
    } else {
      ++it;
    }
  }
  if (n > 0) {
    epoch_ += 1;
    version_.fetch_add(1);
  }
  return n;
}

int64_t Membership::Epoch() const {
  std::lock_guard<std::mutex> lock(mu_);
  return epoch_;
}

void Membership::ForceEpoch(int64_t epoch) {
  std::lock_guard<std::mutex> lock(mu_);
  if (epoch > epoch_) {
    epoch_ = epoch;
    version_.fetch_add(1);
  }
}

void Membership::ResetMembers() {
  std::lock_guard<std::mutex> lock(mu_);
  members_.clear();
}

void Membership::RestoreMember(const std::string& name,
                               const std::string& address, int64_t now_ms) {
  std::lock_guard<std::mutex> lock(mu_);
  MemberInfo& m = members_[name];
  m.name = name;
  m.address = address;
  m.deadline_ms = now_ms + ttl_ms_;
}

void Membership::RemoveMirror(const std::string& name) {
  std::lock_guard<std::mutex> lock(mu_);
  members_.erase(name);
}

void Membership::RefreshAll(int64_t now_ms) {
  std::lock_guard<std::mutex> lock(mu_);
  for (auto& kv : members_) kv.second.deadline_ms = now_ms + ttl_ms_;
}

std::vector<MemberInfo> Membership::Members(int64_t now_ms) {
  Expire(now_ms);
  std::lock_guard<std::mutex> lock(mu_);
  std::vector<MemberInfo> out;
  out.reserve(members_.size());
  for (const auto& kv : members_) out.push_back(kv.second);
  // std::map is already name-sorted: deterministic rank order.
  return out;
}

// ------------------------------------------------------------------ KvStore

void KvStore::Set(const std::string& key, const std::string& value) {
  std::lock_guard<std::mutex> lock(mu_);
  kv_[key] = value;
  version_.fetch_add(1);
}

bool KvStore::Get(const std::string& key, std::string* value) const {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = kv_.find(key);
  if (it == kv_.end()) return false;
  *value = it->second;
  return true;
}

bool KvStore::Del(const std::string& key) {
  std::lock_guard<std::mutex> lock(mu_);
  if (kv_.erase(key) == 0) return false;
  version_.fetch_add(1);
  return true;
}

bool KvStore::Cas(const std::string& key, const std::string& expect,
                  const std::string& value) {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = kv_.find(key);
  if (expect.empty()) {
    if (it != kv_.end()) return false;
    kv_[key] = value;
    version_.fetch_add(1);
    return true;
  }
  if (it == kv_.end() || it->second != expect) return false;
  it->second = value;
  version_.fetch_add(1);
  return true;
}

std::vector<std::string> KvStore::Keys(const std::string& prefix) const {
  std::lock_guard<std::mutex> lock(mu_);
  std::vector<std::string> out;
  for (const auto& kv : kv_) {
    if (kv.first.compare(0, prefix.size(), prefix) == 0) out.push_back(kv.first);
  }
  std::sort(out.begin(), out.end());
  return out;
}

void KvStore::Clear() {
  std::lock_guard<std::mutex> lock(mu_);
  if (!kv_.empty()) version_.fetch_add(1);
  kv_.clear();
}

std::vector<std::pair<std::string, std::string>> KvStore::Items() const {
  std::lock_guard<std::mutex> lock(mu_);
  std::vector<std::pair<std::string, std::string>> out(kv_.begin(), kv_.end());
  std::sort(out.begin(), out.end());  // deterministic snapshots
  return out;
}

// ------------------------------------------------------------------ Service

std::string Service::Snapshot() const {
  std::string out = "EDLCOORD1\n";
  queue.SerializeTo(&out);
  out += "E " + std::to_string(membership.Epoch()) + "\n";
  for (const auto& kv : kv.Items())
    out += "K " + HexEncode(kv.first) + " " +
           (kv.second.empty() ? "-" : HexEncode(kv.second)) + "\n";
  // HA bookkeeping: fencing token + replication stream position, so a
  // restarted standby knows which position it durably holds (promotion
  // picks the standby with the highest persisted position) and a
  // restarted primary keeps its fence.  Old binaries skip the line.
  out += "F " + std::to_string(fence.load()) + " " +
         std::to_string(StreamVersion()) + "\n";
  out += ".\n";
  return out;
}

std::string Service::SnapshotRepl(int64_t now_ms) {
  std::string out = Snapshot();
  // splice M member lines before the terminator: the standby must mirror
  // the member SET (a failover that forgot the members would bounce
  // every heartbeat into a rejoin, bumping the epoch and reforming every
  // world).  Deadlines are process-local and deliberately not shipped.
  out.erase(out.size() - 2);  // ".\n"
  for (const auto& m : membership.Members(now_ms))
    out += "M " + HexEncode(m.name) + " " +
           (m.address.empty() ? "-" : HexEncode(m.address)) + "\n";
  out += ".\n";
  return out;
}

namespace {

bool RestoreImpl(Service* svc, const std::string& blob,
                 int64_t member_now_ms) {
  // Validate framing BEFORE applying anything: a truncated blob (crash
  // mid-write would need to defeat the atomic rename, but be defensive)
  // must not leave a half-restored service, and a malformed line must
  // never throw out of here (LoadFrom runs before the server listens — an
  // exception would crash-loop the coordinator pod on one bad file).
  if (blob.rfind("EDLCOORD1\n", 0) != 0) return false;
  if (blob.size() < 13 ||
      blob.compare(blob.size() - 3, 3, "\n.\n") != 0)
    return false;  // no terminator: incomplete snapshot
  std::istringstream ss(blob);
  std::string line;
  std::getline(ss, line);  // magic, checked above
  bool have_f = false;
  int64_t f_fence = 0, f_version = 0;
  while (std::getline(ss, line)) {
    if (line.empty() || line == ".") continue;
    switch (line[0]) {
      case 'Q':
      case 'T':
      case 'D':
        svc->queue.RestoreLine(line);
        break;
      case 'E': {
        std::istringstream ls(line);
        std::string tag;
        int64_t epoch = 0;
        ls >> tag >> epoch;
        if (!ls.fail()) svc->membership.ForceEpoch(epoch);
        break;
      }
      case 'K': {
        std::istringstream ls(line);
        std::string tag, hk, hv, k, v;
        ls >> tag >> hk >> hv;
        if (hv == "-") hv.clear();
        if (HexDecode(hk, &k) && HexDecode(hv, &v)) svc->kv.Set(k, v);
        break;
      }
      case 'F': {
        std::istringstream ls(line);
        std::string tag;
        ls >> tag >> f_fence >> f_version;
        if (!ls.fail()) have_f = true;
        break;
      }
      case 'M': {
        if (member_now_ms < 0) break;  // disk restore: members re-Join
        std::istringstream ls(line);
        std::string tag, hn, ha, name, addr;
        ls >> tag >> hn >> ha;
        if (ha == "-") ha.clear();
        if (HexDecode(hn, &name) && HexDecode(ha, &addr))
          svc->membership.RestoreMember(name, addr, member_now_ms);
        break;
      }
      default:
        break;  // forward compatibility: skip unknown sections
    }
  }
  if (have_f) {
    if (f_fence > svc->fence.load()) svc->fence.store(f_fence);
    // re-anchor the exported stream position at the recorded one: the
    // restore's own mutation counting is process-local noise
    svc->version_base.store(f_version - svc->DurableVersion());
  }
  return true;
}

}  // namespace

bool Service::Restore(const std::string& blob) {
  return RestoreImpl(this, blob, /*member_now_ms=*/-1);
}

bool Service::RestoreRepl(const std::string& blob, int64_t now_ms) {
  // framing check BEFORE the clear: a torn stream must not wipe the
  // standby's last good mirror
  if (blob.rfind("EDLCOORD1\n", 0) != 0 || blob.size() < 13 ||
      blob.compare(blob.size() - 3, 3, "\n.\n") != 0)
    return false;
  queue.Clear();
  kv.Clear();
  membership.ResetMembers();
  return RestoreImpl(this, blob, now_ms);
}

bool Service::ParseDeltaHeader(const std::string& blob, int64_t* from,
                               int64_t* to) {
  if (blob.rfind("EDLDELTA1 ", 0) != 0) return false;
  // terminator check BEFORE anything else: a torn trailing record must
  // reject the whole blob, never apply a prefix (same rule as snapshots)
  if (blob.size() < 13 || blob.compare(blob.size() - 3, 3, "\n.\n") != 0)
    return false;
  std::istringstream ss(blob.substr(0, blob.find('\n')));
  std::string magic;
  ss >> magic >> *from >> *to;
  return !ss.fail() && *from >= 0 && *to > *from;
}

bool Service::ApplyDelta(const std::string& blob, int64_t now_ms) {
  int64_t from = 0, to = 0;
  if (!ParseDeltaHeader(blob, &from, &to)) return false;
  std::istringstream ss(blob);
  std::string line;
  std::getline(ss, line);  // header, parsed above
  while (std::getline(ss, line)) {
    if (line.empty() || line == ".") continue;
    std::istringstream ls(line.substr(1));
    switch (line[0]) {
      case 'K': {
        std::string hk, hv, k, v;
        ls >> hk >> hv;
        if (hv == "-") hv.clear();
        if (!HexDecode(hk, &k) || !HexDecode(hv, &v)) return false;
        kv.Set(k, v);
        break;
      }
      case 'k': {
        std::string hk, key;
        ls >> hk;
        if (!HexDecode(hk, &key)) return false;
        kv.Del(key);  // idempotent: a re-streamed delete is harmless
        break;
      }
      case 'J': {
        std::string hn, ha, name, addr;
        ls >> hn >> ha;
        if (ha == "-") ha.clear();
        if (!HexDecode(hn, &name) || !HexDecode(ha, &addr)) return false;
        membership.Join(name, addr, now_ms);
        break;
      }
      case 'L': {
        std::string hn, name;
        ls >> hn;
        if (!HexDecode(hn, &name)) return false;
        membership.Leave(name);
        break;
      }
      case 'X': {  // expiry batch: N removals under ONE epoch bump
        std::string csv;
        ls >> csv;
        size_t start = 0;
        while (start < csv.size()) {
          size_t comma = csv.find(',', start);
          if (comma == std::string::npos) comma = csv.size();
          std::string name;
          if (!HexDecode(csv.substr(start, comma - start), &name))
            return false;
          membership.RemoveMirror(name);
          start = comma + 1;
        }
        membership.ForceEpoch(membership.Epoch() + 1);
        break;
      }
      case 'A': {
        int64_t id;
        std::string hp, payload;
        ls >> id >> hp;
        if (ls.fail()) return false;
        if (hp != "-" && !HexDecode(hp, &payload)) return false;
        queue.ReplayAdd(id, payload);
        break;
      }
      case 'C': {
        int64_t id;
        ls >> id;
        if (ls.fail() || !queue.ReplayComplete(id)) return false;
        break;
      }
      case 'F': {
        int64_t id;
        ls >> id;
        if (ls.fail() || !queue.ReplayFail(id)) return false;
        break;
      }
      case 'R':
        queue.ForceAdvance();
        break;
      default:
        break;  // forward compatibility: unknown record tags skip
    }
  }
  return true;
}

int64_t Service::ApplyDeltaChecked(const std::string& blob,
                                   int64_t now_ms) {
  int64_t from = 0, to = 0;
  if (!ParseDeltaHeader(blob, &from, &to)) return -1;  // torn: untouched
  if (StreamVersion() != from) return -2;
  if (!ApplyDelta(blob, now_ms)) {
    // an unreplayable record may have applied a prefix: this mirror is
    // dirty — stop claiming the old position (a promotion in the window
    // before the checkpoint lands must prefer its peers)
    version_base.store(-DurableVersion());
    return -1;
  }
  version_base.store(to - DurableVersion());
  return StreamVersion();
}

bool Service::SaveTo(const std::string& path) const {
  const std::string tmp = path + ".tmp";
  std::string blob = Snapshot();
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (f == nullptr) return false;
  bool ok = std::fwrite(blob.data(), 1, blob.size(), f) == blob.size();
  ok = std::fflush(f) == 0 && ok;
  ok = (fsync(fileno(f)) == 0) && ok;
  std::fclose(f);
  if (!ok) return false;
  if (persist_hook) persist_hook("tmp");
  if (std::rename(tmp.c_str(), path.c_str()) != 0) return false;
  // The rename itself must survive a host power loss: fsync the parent
  // directory so the new directory entry is on disk before the caller
  // acks (etcd's WAL discipline — the role the reference's etcd sidecar
  // played, pkg/jobparser.go:167-184).  Policy: a real fsync error means
  // the entry may not be durable → do not ack (return false; the caller
  // retries on the next mutation).  EINVAL/ENOTSUP (filesystems that do
  // not support directory fsync) and an unopenable directory degrade to
  // best-effort: the content is fsynced and the rename applied, the only
  // exposure is the OLD complete snapshot reappearing after a power loss
  // — refusing to ack forever on such filesystems would be worse.
  std::string dir = ".";
  size_t slash = path.find_last_of('/');
  if (slash != std::string::npos) dir = path.substr(0, slash);
  int dfd = open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dfd < 0) return true;
  bool synced = fsync(dfd) == 0 || errno == EINVAL || errno == ENOTSUP;
  close(dfd);
  return synced;
}

bool Service::LoadFrom(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (f == nullptr) return false;
  std::string blob;
  char buf[4096];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) blob.append(buf, n);
  std::fclose(f);
  return Restore(blob);
}

}  // namespace edlcoord
