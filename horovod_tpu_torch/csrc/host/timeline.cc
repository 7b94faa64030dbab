// Timeline writer: Chrome-tracing JSON with a dedicated writer thread fed
// by a bounded queue, keeping serialization off the training hot path —
// the design of the reference timeline (writer thread + boost SPSC queue,
// horovod/common/timeline.h:46-74), re-implemented with std primitives.

#include "hvd_core.h"

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

namespace {

struct Event {
  std::string tensor;
  std::string activity;
  int phase;  // 0=B 1=E 2=instant 3=shutdown
  int64_t ts_us;
};

struct Timeline {
  // base_ns: the shared clock's base in nanoseconds of CLOCK_MONOTONIC
  // (the clock steady_clock reads on Linux, as Python's
  // time.monotonic_ns does); epoch_us_at_ts0: the wall-clock epoch
  // sampled with it. Both come from the process-wide clock of
  // utils/metrics.py, so timeline ts values, metric events and spans
  // share one base.
  Timeline(const char* path, int mark_cycles, int64_t base_ns,
           int64_t epoch_us_at_ts0)
      : mark_cycles(mark_cycles != 0),
        base_ns(base_ns),
        epoch_us_at_start(epoch_us_at_ts0) {
    file = std::fopen(path, "w");
    healthy = file != nullptr;
    if (healthy) {
      std::fputs("[\n", file);
      std::fprintf(file,
                   "{\"name\":\"clock_sync\",\"ph\":\"M\",\"pid\":0,"
                   "\"args\":{\"epoch_us_at_ts0\":%lld}},\n",
                   static_cast<long long>(epoch_us_at_start));
      // flush now: a live-file merge may read before any event does
      std::fflush(file);
      writer = std::thread([this] { WriterLoop(); });
    }
  }

  ~Timeline() {
    if (healthy) {
      {
        // The shutdown sentinel must never be dropped, or join() hangs —
        // bypass the bounded Push and enqueue it unconditionally.
        std::lock_guard<std::mutex> lock(mutex);
        queue.push_back(Event{"", "", 3, 0});
      }
      cv.notify_one();
      writer.join();
      std::fputs("{}]\n", file);
      std::fclose(file);
    }
  }

  // Escape a string for embedding inside a JSON string literal.
  static std::string JsonEscape(const std::string& s) {
    std::string out;
    out.reserve(s.size());
    for (unsigned char c : s) {
      switch (c) {
        case '"': out += "\\\""; break;
        case '\\': out += "\\\\"; break;
        case '\n': out += "\\n"; break;
        case '\r': out += "\\r"; break;
        case '\t': out += "\\t"; break;
        default:
          if (c < 0x20) {
            char buf[8];
            std::snprintf(buf, sizeof(buf), "\\u%04x", c);
            out += buf;
          } else {
            out += static_cast<char>(c);
          }
      }
    }
    return out;
  }

  int64_t NowUs() const {
    const int64_t now_ns =
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now().time_since_epoch())
            .count();
    return (now_ns - base_ns) / 1000;
  }

  void Push(Event e) {
    {
      std::lock_guard<std::mutex> lock(mutex);
      // Bounded: drop (never block) if the writer can't keep up — tracing
      // must not stall training. The reference sizes its lock-free queue
      // at 2^20 entries for the same reason.
      if (queue.size() < (1u << 20)) queue.push_back(std::move(e));
    }
    cv.notify_one();
  }

  int PidFor(const std::string& tensor) {
    std::lock_guard<std::mutex> lock(pid_mutex);
    auto it = pids.find(tensor);
    if (it != pids.end()) return it->second;
    int pid = next_pid++;
    pids[tensor] = pid;
    std::fprintf(file,
                 "{\"name\":\"process_name\",\"ph\":\"M\",\"pid\":%d,"
                 "\"args\":{\"name\":\"%s\"}},\n",
                 pid, JsonEscape(tensor).c_str());
    return pid;
  }

  void WriterLoop() {
    for (;;) {
      Event e;
      {
        std::unique_lock<std::mutex> lock(mutex);
        cv.wait(lock, [this] { return !queue.empty(); });
        e = std::move(queue.front());
        queue.pop_front();
      }
      if (e.phase == 3) return;
      int pid = e.tensor.empty() ? 0 : PidFor(e.tensor);
      switch (e.phase) {
        case 0:
          std::fprintf(file,
                       "{\"name\":\"%s\",\"ph\":\"B\",\"pid\":%d,"
                       "\"ts\":%lld},\n",
                       JsonEscape(e.activity).c_str(), pid,
                       static_cast<long long>(e.ts_us));
          break;
        case 1:
          std::fprintf(file, "{\"ph\":\"E\",\"pid\":%d,\"ts\":%lld},\n", pid,
                       static_cast<long long>(e.ts_us));
          break;
        default:
          std::fprintf(file,
                       "{\"name\":\"%s\",\"ph\":\"i\",\"pid\":%d,\"s\":\"g\","
                       "\"ts\":%lld},\n",
                       JsonEscape(e.activity).c_str(), pid,
                       static_cast<long long>(e.ts_us));
      }
      std::fflush(file);
    }
  }

  int64_t Pending() {
    std::lock_guard<std::mutex> lock(mutex);
    return static_cast<int64_t>(queue.size());
  }

  bool mark_cycles;
  bool healthy = false;
  std::FILE* file = nullptr;
  int64_t base_ns = 0;
  int64_t epoch_us_at_start = 0;
  std::mutex mutex;
  std::condition_variable cv;
  std::deque<Event> queue;
  std::thread writer;
  std::mutex pid_mutex;
  std::unordered_map<std::string, int> pids;
  int next_pid = 1;
};

}  // namespace

void* hvd_timeline_create(const char* path, int mark_cycles,
                          int64_t base_ns, int64_t epoch_us_at_ts0) {
  auto* t = new Timeline(path, mark_cycles, base_ns, epoch_us_at_ts0);
  if (!t->healthy) {
    delete t;
    return nullptr;
  }
  return t;
}

void hvd_timeline_destroy(void* timeline) {
  delete static_cast<Timeline*>(timeline);
}

void hvd_timeline_event(void* timeline, const char* tensor,
                        const char* activity, int phase) {
  auto* t = static_cast<Timeline*>(timeline);
  t->Push(Event{tensor ? tensor : "", activity ? activity : "", phase,
                t->NowUs()});
}

void hvd_timeline_cycle(void* timeline) {
  auto* t = static_cast<Timeline*>(timeline);
  if (t->mark_cycles) {
    t->Push(Event{"", "CYCLE_START", 2, t->NowUs()});
  }
}

int64_t hvd_timeline_pending(void* timeline) {
  return static_cast<Timeline*>(timeline)->Pending();
}
