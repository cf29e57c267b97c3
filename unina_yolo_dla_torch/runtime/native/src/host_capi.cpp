// A small C ABI over the host's staging, compaction and executors,
// built as libunina_host.so and loaded with ctypes by the tests and
// chip_smoke.py (runtime/native/capi.py), so that real scenes can be held
// record for record against the Python entry points. The library leaves
// Python's symbols to the process that loads it (a Python process).
//
// Every function returns an error code: 0 ok, 1 the geometry sentinel,
// -1 a failure whose message unina_last_error() gives (this thread).
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "executor_cuda.h"
#include "executor_py.h"
#include "host_staging.h"

namespace {

thread_local std::string g_error;

int fail(const std::exception& e) {
  g_error = e.what();
  return -1;
}

unina::Executor* as_exec(void* h) { return static_cast<unina::Executor*>(h); }

}  // namespace

extern "C" {

const char* unina_last_error() { return g_error.c_str(); }

// Stage a square frame into `layout` (0 rgb, 1 blocked, 2 merged); `out`
// holds size*size*3 bytes.
int unina_stage(int layout, int size, const uint8_t* frame, int width,
                int height, int channels, uint8_t* out) {
  std::vector<uint8_t> scratch(static_cast<size_t>(size) * size * 3);
  return unina::stage_frame(static_cast<unina::Layout>(layout), size, frame,
                            width, height, channels, scratch.data(), out)
             ? 0
             : 1;
}

// (k, 7) float32 packed -> records into `out` (k * 24 bytes); -> count.
int unina_compact(const float* packed, int k, uint8_t* out) {
  std::vector<unina::Detection> dets;
  unina::compact_detections(packed, static_cast<size_t>(k), &dets);
  std::memcpy(out, dets.data(), dets.size() * sizeof(unina::Detection));
  return static_cast<int>(dets.size());
}

// kind "python" or "cuda"; *out gets the executor.
int unina_executor_create(const char* kind, const char* artifact,
                          int input_size, int num_classes, void** out) {
  try {
    std::string k = kind;
    if (k == "cuda") {
      *out = new unina::CudaExecutor(artifact, input_size, num_classes);
    } else if (k == "python") {
      *out = new unina::PyExecutor(artifact, input_size, num_classes);
    } else {
      g_error = "unknown executor kind " + k;
      return -1;
    }
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int unina_executor_depth(void* h) { return as_exec(h)->pipeline_depth(); }

int unina_executor_submit(void* h, const uint8_t* frame, int width,
                          int height, int channels) {
  try {
    return as_exec(h)->submit(frame, width, height, channels) ==
                   unina::InferStatus::kOk
               ? 0
               : 1;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

// The oldest submitted frame's records into `out` (room for `cap`
// records); *count gets their number.
int unina_executor_collect(void* h, uint8_t* out, int cap, int* count) {
  try {
    std::vector<unina::Detection> dets;
    if (as_exec(h)->collect(&dets) != unina::InferStatus::kOk) {
      g_error = "collect() with no frame in flight";
      return -1;
    }
    if (static_cast<int>(dets.size()) > cap) {
      g_error = "more records than the buffer holds";
      return -1;
    }
    std::memcpy(out, dets.data(), dets.size() * sizeof(unina::Detection));
    *count = static_cast<int>(dets.size());
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

int unina_executor_infer(void* h, const uint8_t* frame, int width,
                         int height, int channels, uint8_t* out, int cap,
                         int* count) {
  try {
    std::vector<unina::Detection> dets;
    if (as_exec(h)->infer(frame, width, height, channels, &dets) !=
        unina::InferStatus::kOk)
      return 1;
    if (static_cast<int>(dets.size()) > cap) {
      g_error = "more records than the buffer holds";
      return -1;
    }
    std::memcpy(out, dets.data(), dets.size() * sizeof(unina::Detection));
    *count = static_cast<int>(dets.size());
    return 0;
  } catch (const std::exception& e) {
    return fail(e);
  }
}

void unina_executor_destroy(void* h) { delete as_exec(h); }

}  // extern "C"
