#pragma once

#include <cstdint>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "executor.h"

namespace unina {

// A CUDA driver call that failed, named with its CUresult. The host stops
// on it (non-zero exit) instead of counting a dropped frame.
class DriverError : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};

// The no-Python executor: replays the serving artifact's captured CUDA
// graph through the driver API (libcuda.so.1, loaded with dlopen; no
// toolkit runtime is linked).
//
// Configure (once, through the embedded interpreter):
// runtime/embed.py make_graph_executor loads the artifact on the card and
// hands over plain integers: the graph's executable, its static input and
// packed (K, 7) output, the stream it was captured on, and how a frame is
// staged. The Python object is kept for the executor's life (the graph's
// weights and memory pool are its).
//
// Per frame: submit() stages the frame on the host (host_staging.h) into
// one of two pinned slots and enqueues on the capture stream the copy into
// the graph's static input, the graph launch, the copy of `packed` into
// the slot's pinned result and an event; collect() waits on the oldest
// event (the one host wait of a frame) and compacts the valid rows. No
// Python runs and the interpreter's lock is not held. At depth 2, frame
// N+1 is staged on the host while frame N's graph runs; its copy into the
// single static input waits for that graph on the stream.
class CudaExecutor : public Executor {
 public:
  // Throws std::runtime_error on any configure-time failure: no card,
  // UNINA_FORCE_CPU, a CPU or batch artifact, a failed driver call.
  CudaExecutor(const std::string& artifact_dir, int input_size,
               int num_classes);
  ~CudaExecutor() override;
  CudaExecutor(const CudaExecutor&) = delete;
  CudaExecutor& operator=(const CudaExecutor&) = delete;

  InferStatus infer(const uint8_t* frame, int width, int height,
                    int channels, std::vector<Detection>* out) override;
  int pipeline_depth() const override { return 2; }
  // More frames than slots in flight: the oldest is waited for and kept
  // for its collect() before its slot is reused.
  InferStatus submit(const uint8_t* frame, int width, int height,
                     int channels) override;
  InferStatus collect(std::vector<Detection>* out) override;

 private:
  struct Impl;
  std::unique_ptr<Impl> impl_;
};

}  // namespace unina
