// Native flight recorder — ring buffer of recent collectives.
//
// TPU-native counterpart of torch's C++ FlightRecorder
// (FlightRecorder.hpp:24-70, SURVEY.md §2.2 N15): fixed-capacity ring of
// (seq, op, group, shape, dtype, numel, state, timestamps), mutex-guarded,
// dumped as JSON on watchdog trip. The Python layer
// (utils/flight_recorder.py) fronts this when the library is loadable and
// falls back to its pure-Python ring otherwise.

#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <sstream>
#include <string>

namespace {

struct Entry {
  int64_t seq;
  std::string op;
  std::string group;
  std::string shape;
  std::string dtype;
  int64_t numel;
  int state;  // 0 enqueued, 1 completed, 2 failed
  double t_created;
  double t_completed;  // <0 = not completed
};

struct Recorder {
  int64_t capacity;
  std::deque<Entry> ring;
  std::mutex mu;

  explicit Recorder(int64_t cap) : capacity(cap) {}
};

void json_escape(std::ostringstream& os, const std::string& s) {
  for (unsigned char c : s) {
    if (c == '"' || c == '\\') {
      os << '\\' << c;
    } else if (c == '\n') {
      os << "\\n";
    } else if (c < 0x20) {  // all control chars must be escaped in JSON
      char buf[8];
      std::snprintf(buf, sizeof(buf), "\\u%04x", c);
      os << buf;
    } else {
      os << c;
    }
  }
}

}  // namespace

extern "C" {

void* tdx_fr_create(int64_t capacity) { return new Recorder(capacity); }

void tdx_fr_destroy(void* h) { delete static_cast<Recorder*>(h); }

void tdx_fr_record(void* h, int64_t seq, const char* op, const char* group,
                   const char* shape, const char* dtype, int64_t numel,
                   double ts) {
  auto* r = static_cast<Recorder*>(h);
  if (r->capacity <= 0) return;  // capacity 0 = recording disabled
  std::lock_guard<std::mutex> g(r->mu);
  while (static_cast<int64_t>(r->ring.size()) >= r->capacity) {
    r->ring.pop_front();
  }
  r->ring.push_back(Entry{seq, op, group, shape, dtype, numel, 0, ts, -1.0});
}

void tdx_fr_complete(void* h, int64_t seq, const char* group, int failed,
                     double ts) {
  auto* r = static_cast<Recorder*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  // linear scan from the back: completions target recent entries
  for (auto it = r->ring.rbegin(); it != r->ring.rend(); ++it) {
    if (it->seq == seq && it->group == group) {
      it->state = failed ? 2 : 1;
      it->t_completed = ts;
      return;
    }
  }
}

int64_t tdx_fr_size(void* h) {
  auto* r = static_cast<Recorder*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  return static_cast<int64_t>(r->ring.size());
}

// JSON array of entries. Returns a heap copy the caller must release with
// tdx_fr_dump_free — a shared member buffer would be invalidated by a
// concurrent dump after the lock drops (watchdog thread vs main thread).
char* tdx_fr_dump_json(void* h) {
  auto* r = static_cast<Recorder*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  static const char* kState[] = {"enqueued", "completed", "failed"};
  std::ostringstream os;
  os.precision(17);  // keep full epoch-second resolution for timestamps
  os << "[";
  bool first = true;
  for (const auto& e : r->ring) {
    if (!first) os << ",";
    first = false;
    os << "{\"seq\":" << e.seq << ",\"op\":\"";
    json_escape(os, e.op);
    os << "\",\"group\":\"";
    json_escape(os, e.group);
    os << "\",\"shape\":\"";
    json_escape(os, e.shape);
    os << "\",\"dtype\":\"";
    json_escape(os, e.dtype);
    os << "\",\"numel\":" << e.numel << ",\"state\":\"" << kState[e.state]
       << "\",\"time_created\":" << e.t_created;
    if (e.t_completed >= 0) os << ",\"time_completed\":" << e.t_completed;
    os << "}";
  }
  os << "]";
  const std::string s = os.str();
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

void tdx_fr_dump_free(char* p) { std::free(p); }

}  // extern "C"
