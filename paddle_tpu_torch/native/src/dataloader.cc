// Native data-loading runtime for paddle_tpu_torch.
//
// Reference analog: paddle/fluid/framework/data_feed.cc (MultiSlotDataFeed
// pipe-command text parsing), framework/blocking_queue.h, and
// operators/reader/buffered_reader.cc (background prefetch threads).
//
// Exposes a C API consumed from Python via ctypes: a bounded MPMC blocking
// queue of serialized samples + a multi-threaded file reader/parser for the
// MultiSlot text format ("<len> v1 v2 ... per slot, space separated").
//
// Sample wire format pushed to the queue (little endian):
//   uint32 num_slots
//   per slot: uint8 dtype (0=f32, 1=i64), uint32 len, payload bytes
//
// Build: paddle_tpu_torch/native/__init__.py runs g++ -O2 -fPIC -shared
// -pthread at first use, into paddle_tpu_torch/_build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Buffer {
  std::vector<uint8_t> data;
};

class BlockingQueue {
 public:
  explicit BlockingQueue(size_t capacity) : capacity_(capacity) {}

  bool Push(Buffer&& item) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < capacity_ || closed_; });
    if (closed_) return false;
    q_.push_back(std::move(item));
    not_empty_.notify_one();
    return true;
  }

  // Returns false when queue is closed AND drained.
  bool Pop(Buffer* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  size_t capacity_;
  bool closed_ = false;
  std::deque<Buffer> q_;
  std::mutex mu_;
  std::condition_variable not_full_, not_empty_;
};

struct Loader {
  BlockingQueue queue;
  std::vector<std::string> files;
  std::string slot_types;  // per-slot: 'f' float32 | 'i' int64
  std::atomic<size_t> next_file{0};
  std::atomic<int> live_workers{0};
  std::vector<std::thread> workers;

  Loader(size_t cap) : queue(cap) {}
};

void AppendU32(std::vector<uint8_t>* v, uint32_t x) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&x);
  v->insert(v->end(), p, p + 4);
}

// Parse one MultiSlot-format line into the wire format. Returns false on
// malformed input (silently skipped, matching the reference's tolerant
// parser).
bool ParseLine(const std::string& line, const std::string& slot_types,
               std::vector<uint8_t>* out) {
  std::istringstream is(line);
  out->clear();
  AppendU32(out, static_cast<uint32_t>(slot_types.size()));
  for (char t : slot_types) {
    long long len;
    if (!(is >> len) || len < 0) return false;
    out->push_back(t == 'f' ? 0 : 1);
    AppendU32(out, static_cast<uint32_t>(len));
    if (t == 'f') {
      for (long long i = 0; i < len; ++i) {
        float v;
        if (!(is >> v)) return false;
        const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
        out->insert(out->end(), p, p + 4);
      }
    } else {
      for (long long i = 0; i < len; ++i) {
        int64_t v;
        if (!(is >> v)) return false;
        const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
        out->insert(out->end(), p, p + 8);
      }
    }
  }
  return true;
}

void WorkerLoop(Loader* ld) {
  while (true) {
    size_t idx = ld->next_file.fetch_add(1);
    if (idx >= ld->files.size()) break;
    std::ifstream f(ld->files[idx]);
    if (!f.is_open()) continue;
    std::string line;
    std::vector<uint8_t> wire;
    while (std::getline(f, line)) {
      if (line.empty()) continue;
      if (!ParseLine(line, ld->slot_types, &wire)) continue;
      Buffer b;
      b.data = wire;
      if (!ld->queue.Push(std::move(b))) return;  // closed
    }
  }
  if (ld->live_workers.fetch_sub(1) == 1) {
    ld->queue.Close();  // last worker out: signal end of data
  }
}

}  // namespace

extern "C" {

void* ptdl_create(const char** files, int nfiles, const char* slot_types,
                  int num_threads, int capacity) {
  Loader* ld = new Loader(static_cast<size_t>(capacity));
  for (int i = 0; i < nfiles; ++i) ld->files.emplace_back(files[i]);
  ld->slot_types = slot_types;
  int n = num_threads > 0 ? num_threads : 1;
  ld->live_workers = n;
  for (int i = 0; i < n; ++i) ld->workers.emplace_back(WorkerLoop, ld);
  return ld;
}

// Pops one sample; copies up to buf_cap bytes into buf. Returns the sample
// size in bytes, 0 on end-of-data, -1 if buf too small (sample is dropped).
long long ptdl_next(void* handle, uint8_t* buf, long long buf_cap) {
  Loader* ld = static_cast<Loader*>(handle);
  Buffer b;
  if (!ld->queue.Pop(&b)) return 0;
  long long n = static_cast<long long>(b.data.size());
  if (n > buf_cap) return -1;
  std::memcpy(buf, b.data.data(), b.data.size());
  return n;
}

long long ptdl_queue_size(void* handle) {
  return static_cast<long long>(static_cast<Loader*>(handle)->queue.Size());
}

void ptdl_destroy(void* handle) {
  Loader* ld = static_cast<Loader*>(handle);
  ld->queue.Close();
  for (auto& t : ld->workers) {
    if (t.joinable()) t.join();
  }
  delete ld;
}

// -- standalone blocking queue (LoDTensorBlockingQueue analog) --------------

void* ptq_create(int capacity) { return new BlockingQueue(capacity); }

int ptq_push(void* h, const uint8_t* data, long long len) {
  Buffer b;
  b.data.assign(data, data + len);
  return static_cast<BlockingQueue*>(h)->Push(std::move(b)) ? 1 : 0;
}

long long ptq_pop(void* h, uint8_t* buf, long long buf_cap) {
  Buffer b;
  if (!static_cast<BlockingQueue*>(h)->Pop(&b)) return 0;
  long long n = static_cast<long long>(b.data.size());
  if (n > buf_cap) return -1;
  std::memcpy(buf, b.data.data(), b.data.size());
  return n;
}

void ptq_close(void* h) { static_cast<BlockingQueue*>(h)->Close(); }

void ptq_destroy(void* h) { delete static_cast<BlockingQueue*>(h); }

}  // extern "C"
