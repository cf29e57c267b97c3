// Per-frame latency histogram with percentile queries — upgrades the
// reference's steady_clock DEBUG log (perception_node.cpp:684-688) to a
// real p50/p90/p99 tracker; p99 is the north-star serving metric.
#pragma once

#include <algorithm>
#include <cstddef>
#include <vector>

namespace unina {

class LatencyHistogram {
 public:
  explicit LatencyHistogram(size_t capacity = 4096)
      : buf_(capacity, 0.0), cap_(capacity) {}

  void record(double ms) { buf_[n_++ % cap_] = ms; }
  size_t count() const { return n_; }

  double percentile(double p) const {
    size_t n = std::min(n_, cap_);
    if (n == 0) return 0.0;
    std::vector<double> tmp(buf_.begin(), buf_.begin() + n);
    std::sort(tmp.begin(), tmp.end());
    double idx = p / 100.0 * (n - 1);
    size_t lo = static_cast<size_t>(idx);
    size_t hi = std::min(lo + 1, n - 1);
    double frac = idx - lo;
    return tmp[lo] * (1 - frac) + tmp[hi] * frac;
  }

  double p50() const { return percentile(50); }
  double p90() const { return percentile(90); }
  double p99() const { return percentile(99); }

 private:
  std::vector<double> buf_;
  size_t cap_;
  size_t n_ = 0;
};

}  // namespace unina
