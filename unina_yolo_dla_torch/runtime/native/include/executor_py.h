#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "executor.h"

namespace unina {

// Start the embedded interpreter once, where the process has none (the
// host binary), and release its lock; every later use of Python takes the
// lock with PyGILState_Ensure. In a Python process (the C ABI loaded by
// ctypes) the running interpreter is used as it is.
void ensure_interpreter();

// The pending Python exception as "Type: message", its traceback printed
// to stderr and the error cleared. Call with the lock held.
std::string python_error();

// Inference executor over runtime/embed.py make_executor (embedded
// CPython): a per-frame Python call on a zero-copy memoryview of the
// frame, depth 1. Serves the card's captured graph, or the plain path on
// the CPU under UNINA_FORCE_CPU. The no-Python path is CudaExecutor
// (executor_cuda.h).
class PyExecutor : public Executor {
 public:
  PyExecutor(const std::string& artifact_dir, int input_size,
             int num_classes);
  ~PyExecutor() override;
  PyExecutor(const PyExecutor&) = delete;
  PyExecutor& operator=(const PyExecutor&) = delete;

  // Frame bytes (from the shm ring) -> compacted detections.
  // channels: 3 = RGB, 4 = BGRA, 0 = NV12 planar (w*h*3/2 bytes).
  InferStatus infer(const uint8_t* frame, int width, int height,
                    int channels, std::vector<Detection>* out) override;

 private:
  struct Impl;
  Impl* impl_;
};

}  // namespace unina
