#pragma once

#include <cstdint>
#include <deque>
#include <vector>

#include "frame_ring.hpp"

namespace unina {

// Outcome of a single-frame inference call. kGeometryError is the
// shape-mismatch sentinel — distinct from a legitimate zero-detection
// frame so the host can count it as a drop instead of publishing an
// empty result.
enum class InferStatus { kOk, kGeometryError };

// Engine abstraction the host drives (the TensorRTEngine-wrapper role,
// reference perception_node.cpp:223-351). Implementations:
//  - PyExecutor   (executor_py.cpp):   embedded CPython over
//                                      runtime/embed.py make_executor
//  - CudaExecutor (executor_cuda.cpp): the artifact's captured CUDA graph
//                                      replayed through the driver API —
//                                      no Python in the loop
class Executor {
 public:
  virtual ~Executor() = default;

  // Frame bytes (from the shm ring) -> compacted detections.
  // channels: 3 = RGB, 4 = BGRA, 0 = NV12 planar (w*h*3/2 bytes).
  virtual InferStatus infer(const uint8_t* frame, int width, int height,
                            int channels, std::vector<Detection>* out) = 0;

  // ---- pipelined API (the reference hides latency the same way:
  // everything enqueued async on one stream, exactly one sync per frame,
  // perception_node.cpp:598-645) ----
  //
  // submit() enqueues a frame (the executor consumes/copies the bytes
  // before returning, so the caller may reuse its buffer immediately);
  // collect() blocks for the OLDEST in-flight frame's detections. The
  // host keeps up to pipeline_depth() frames in flight, so frame N+1's
  // host->device upload overlaps frame N's execute + device->host.
  //
  // Default implementation (depth 1, e.g. the embedded-Python executor):
  // submit runs infer() synchronously and stages the result for collect.
  virtual int pipeline_depth() const { return 1; }

  virtual InferStatus submit(const uint8_t* frame, int width, int height,
                             int channels) {
    staged_.emplace_back();
    InferStatus st = infer(frame, width, height, channels, &staged_.back());
    if (st != InferStatus::kOk) {
      staged_.pop_back();  // only successful submissions are collectable
    }
    return st;
  }

  virtual InferStatus collect(std::vector<Detection>* out) {
    if (staged_.empty()) return InferStatus::kGeometryError;  // API misuse
    *out = std::move(staged_.front());
    staged_.pop_front();
    return InferStatus::kOk;
  }

 private:
  std::deque<std::vector<Detection>> staged_;
};

}  // namespace unina
