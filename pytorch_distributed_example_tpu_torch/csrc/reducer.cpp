// Native reducer core — host-side bucket pack/unpack + NaN audit.
//
// TPU-native counterpart of torch's C++ Reducer internals
// (torch reducer.hpp:356-424 flat Bucket buffers; NanCheck.hpp) for the
// eager/DLPack interop path where gradients live in host buffers: the
// device path flattens inside the compiled step, so the native work is
// the host memcpy fan-in/fan-out, parallelized across threads for large
// buckets, and the NaN scan used by the debug wrapper backend.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kParallelThreshold = 1 << 20;  // 1M floats

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

template <typename Fn>
void parallel_chunks(int64_t total, Fn fn) {
  if (total < kParallelThreshold) {
    fn(0, total);
    return;
  }
  int nt = hw_threads();
  int64_t chunk = (total + nt - 1) / nt;
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk > total ? total : lo + chunk;
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Pack n leaves (srcs[i], lengths[i] floats) into dst at running offsets.
void tdx_pack_f32(const float** srcs, const int64_t* lengths, int64_t n,
                  float* dst) {
  std::vector<int64_t> offs(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) offs[i + 1] = offs[i] + lengths[i];
  // parallelize across leaves; large single leaves split internally
  for (int64_t i = 0; i < n; ++i) {
    const float* s = srcs[i];
    float* d = dst + offs[i];
    parallel_chunks(lengths[i], [=](int64_t lo, int64_t hi) {
      std::memcpy(d + lo, s + lo, (hi - lo) * sizeof(float));
    });
  }
}

// Scatter dst-packed data back out to n leaves.
void tdx_unpack_f32(const float* src, const int64_t* lengths, int64_t n,
                    float** dsts) {
  std::vector<int64_t> offs(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) offs[i + 1] = offs[i] + lengths[i];
  for (int64_t i = 0; i < n; ++i) {
    const float* s = src + offs[i];
    float* d = dsts[i];
    parallel_chunks(lengths[i], [=](int64_t lo, int64_t hi) {
      std::memcpy(d + lo, s + lo, (hi - lo) * sizeof(float));
    });
  }
}

// Count NaNs/Infs in a float buffer (torch NanCheck.hpp / NCCL NaN-check
// parity for the debug wrapper backend). Returns the non-finite count.
int64_t tdx_count_nonfinite_f32(const float* x, int64_t n) {
  std::atomic<int64_t> bad{0};
  parallel_chunks(n, [&](int64_t lo, int64_t hi) {
    int64_t local = 0;
    for (int64_t i = lo; i < hi; ++i) {
      if (!std::isfinite(x[i])) ++local;
    }
    if (local) bad.fetch_add(local, std::memory_order_relaxed);
  });
  return bad.load();
}

}  // extern "C"
