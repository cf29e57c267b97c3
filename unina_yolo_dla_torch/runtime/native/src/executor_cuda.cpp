// CUDA-graph executor (executor_cuda.h): the captured frame replayed from
// C++ through the CUDA driver API, two frames in flight.
#include "executor_cuda.h"

#include <Python.h>
#include <dlfcn.h>

#include <cstdio>
#include <cstring>
#include <deque>
#include <string>

#include "executor_py.h"
#include "host_staging.h"

namespace unina {
namespace {

// The few driver types and entry points the executor needs (cuda.h's
// declarations; the `_v2` symbols where the driver has them).
using CUresult = int;
using CUdevice = int;
using CUcontext = struct CUctx_st*;
using CUstream = struct CUstream_st*;
using CUevent = struct CUevent_st*;
using CUgraphExec = struct CUgraphExec_st*;
using CUdeviceptr = unsigned long long;
constexpr unsigned kEventDisableTiming = 0x2;  // CU_EVENT_DISABLE_TIMING

struct Driver {
  CUresult (*cuInit)(unsigned);
  CUresult (*cuDeviceGet)(CUdevice*, int);
  CUresult (*cuDevicePrimaryCtxRetain)(CUcontext*, CUdevice);
  CUresult (*cuDevicePrimaryCtxRelease)(CUdevice);
  CUresult (*cuCtxSetCurrent)(CUcontext);
  CUresult (*cuMemHostAlloc)(void**, size_t, unsigned);
  CUresult (*cuMemFreeHost)(void*);
  CUresult (*cuMemcpyHtoDAsync)(CUdeviceptr, const void*, size_t, CUstream);
  CUresult (*cuMemcpyDtoHAsync)(void*, CUdeviceptr, size_t, CUstream);
  CUresult (*cuGraphLaunch)(CUgraphExec, CUstream);
  CUresult (*cuEventCreate)(CUevent*, unsigned);
  CUresult (*cuEventRecord)(CUevent, CUstream);
  CUresult (*cuEventSynchronize)(CUevent);
  CUresult (*cuEventDestroy)(CUevent);
  CUresult (*cuStreamSynchronize)(CUstream);
  CUresult (*cuGetErrorName)(CUresult, const char**);

  void load() {
    void* dl = ::dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (!dl) {
      throw std::runtime_error(std::string("cannot load libcuda.so.1: ") +
                               ::dlerror());
    }
    auto sym = [dl](const char* name) {
      void* p = ::dlsym(dl, name);
      if (!p) throw std::runtime_error(std::string("libcuda has no ") + name);
      return p;
    };
#define UNINA_SYM(field, name) \
  field = reinterpret_cast<decltype(field)>(sym(name))
    UNINA_SYM(cuInit, "cuInit");
    UNINA_SYM(cuDeviceGet, "cuDeviceGet");
    UNINA_SYM(cuDevicePrimaryCtxRetain, "cuDevicePrimaryCtxRetain");
    UNINA_SYM(cuDevicePrimaryCtxRelease, "cuDevicePrimaryCtxRelease_v2");
    UNINA_SYM(cuCtxSetCurrent, "cuCtxSetCurrent");
    UNINA_SYM(cuMemHostAlloc, "cuMemHostAlloc");
    UNINA_SYM(cuMemFreeHost, "cuMemFreeHost");
    UNINA_SYM(cuMemcpyHtoDAsync, "cuMemcpyHtoDAsync_v2");
    UNINA_SYM(cuMemcpyDtoHAsync, "cuMemcpyDtoHAsync_v2");
    UNINA_SYM(cuGraphLaunch, "cuGraphLaunch");
    UNINA_SYM(cuEventCreate, "cuEventCreate");
    UNINA_SYM(cuEventRecord, "cuEventRecord");
    UNINA_SYM(cuEventSynchronize, "cuEventSynchronize");
    UNINA_SYM(cuEventDestroy, "cuEventDestroy_v2");
    UNINA_SYM(cuStreamSynchronize, "cuStreamSynchronize");
    UNINA_SYM(cuGetErrorName, "cuGetErrorName");
#undef UNINA_SYM
    // the library stays loaded for the life of the process
  }

  void check(CUresult r, const char* what) const {
    if (r == 0) return;
    const char* name = nullptr;
    if (cuGetErrorName(r, &name) != 0 || !name) name = "CUDA_ERROR_UNKNOWN";
    throw DriverError(std::string(what) + " failed: " + name + " (" +
                      std::to_string(r) + ")");
  }
};

// An integer attribute of the configure-time handle (lock held).
unsigned long long int_attr(PyObject* obj, const char* name) {
  PyObject* v = PyObject_GetAttrString(obj, name);
  if (!v) throw std::runtime_error("handle has no " + std::string(name));
  unsigned long long x = PyLong_AsUnsignedLongLong(v);
  Py_DECREF(v);
  if (PyErr_Occurred()) {
    throw std::runtime_error("handle." + std::string(name) + ": " +
                             python_error());
  }
  return x;
}

std::string str_attr(PyObject* obj, const char* name) {
  PyObject* v = PyObject_GetAttrString(obj, name);
  const char* s = v ? PyUnicode_AsUTF8(v) : nullptr;
  std::string out = s ? s : "";
  Py_XDECREF(v);
  if (!s) {
    throw std::runtime_error("handle." + std::string(name) + ": " +
                             python_error());
  }
  return out;
}

}  // namespace

struct CudaExecutor::Impl {
  Driver cu{};
  PyObject* handle = nullptr;  // make_graph_executor's object
  CUdevice device = 0;
  CUcontext ctx = nullptr;
  bool ctx_retained = false;
  CUstream stream = nullptr;
  CUgraphExec graph = nullptr;
  CUdeviceptr input = 0, packed = 0;
  size_t input_bytes = 0, k = 0;
  Layout layout = Layout::kRgb;
  int size = 0;                       // model input (square layouts)
  int cam_w = 0, cam_h = 0, cam_ch = 0;
  std::vector<uint8_t> scratch;       // a converted frame before blocking

  struct Slot {
    uint8_t* staging = nullptr;       // pinned: the staged frame
    float* result = nullptr;          // pinned: (K, 7) packed
    CUevent done = nullptr;           // after the copy into `result`
    bool busy = false;
  };
  Slot slots[2];
  struct Entry {
    int slot;
    bool ready;                       // waited for; dets hold its result
    std::vector<Detection> dets;
  };
  std::deque<Entry> queue;            // submitted frames, oldest first

  void finish(Entry* e) {
    Slot& s = slots[e->slot];
    cu.check(cu.cuEventSynchronize(s.done), "cuEventSynchronize");
    compact_detections(s.result, k, &e->dets);
    s.busy = false;
    e->ready = true;
  }

  int free_slot() {
    for (int i = 0; i < 2; ++i)
      if (!slots[i].busy) return i;
    for (Entry& e : queue) {
      if (!e.ready) {
        int i = e.slot;
        finish(&e);
        return i;
      }
    }
    throw std::logic_error("no free slot and nothing in flight");
  }

  void release() {
    if (stream && cu.cuStreamSynchronize) cu.cuStreamSynchronize(stream);
    for (Slot& s : slots) {
      if (s.done) cu.cuEventDestroy(s.done);
      if (s.staging) cu.cuMemFreeHost(s.staging);
      if (s.result) cu.cuMemFreeHost(s.result);
      s = Slot{};
    }
    if (ctx_retained) cu.cuDevicePrimaryCtxRelease(device);
    ctx_retained = false;
    if (handle) {
      PyGILState_STATE gil = PyGILState_Ensure();
      Py_DECREF(handle);
      PyGILState_Release(gil);
      handle = nullptr;
    }
  }
};

CudaExecutor::CudaExecutor(const std::string& artifact_dir, int input_size,
                           int num_classes)
    : impl_(new Impl) {
  Impl& m = *impl_;
  ensure_interpreter();
  {
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* mod =
        PyImport_ImportModule("unina_yolo_dla_torch.runtime.embed");
    PyObject* make =
        mod ? PyObject_GetAttrString(mod, "make_graph_executor") : nullptr;
    Py_XDECREF(mod);
    if (make) {
      m.handle = PyObject_CallFunction(make, "sii", artifact_dir.c_str(),
                                       input_size, num_classes);
      Py_DECREF(make);
    }
    if (!m.handle) {
      std::string err = python_error();
      PyGILState_Release(gil);
      throw std::runtime_error("make_graph_executor() failed: " + err);
    }
    try {
      m.graph = reinterpret_cast<CUgraphExec>(int_attr(m.handle,
                                                       "graph_exec"));
      m.input = int_attr(m.handle, "input_ptr");
      m.input_bytes = int_attr(m.handle, "input_bytes");
      m.packed = int_attr(m.handle, "packed_ptr");
      m.k = int_attr(m.handle, "max_detections");
      m.stream = reinterpret_cast<CUstream>(int_attr(m.handle, "stream"));
      m.device = static_cast<int>(int_attr(m.handle, "device_index"));
      m.size = static_cast<int>(int_attr(m.handle, "input_size"));
      std::string layout = str_attr(m.handle, "layout");
      if (layout == "rgb") {
        m.layout = Layout::kRgb;
      } else if (layout == "blocked") {
        m.layout = Layout::kBlocked;
      } else if (layout == "merged") {
        m.layout = Layout::kMerged;
      } else if (layout == "camera") {
        m.layout = Layout::kCamera;
        m.cam_w = static_cast<int>(int_attr(m.handle, "frame_width"));
        m.cam_h = static_cast<int>(int_attr(m.handle, "frame_height"));
        m.cam_ch = static_cast<int>(int_attr(m.handle, "frame_channels"));
      } else {
        throw std::runtime_error("unknown staging layout " + layout);
      }
    } catch (...) {
      Py_DECREF(m.handle);
      m.handle = nullptr;
      PyGILState_Release(gil);
      throw;
    }
    PyGILState_Release(gil);
  }
  if (!m.graph) {
    m.release();
    throw std::runtime_error("the artifact's graph has no executable");
  }
  const size_t want =
      m.layout == Layout::kCamera
          ? (m.cam_ch == 0 ? size_t(m.cam_w) * m.cam_h * 3 / 2
                           : size_t(m.cam_w) * m.cam_h * m.cam_ch)
          : size_t(m.size) * m.size * 3;
  if (m.input_bytes != want) {
    m.release();
    throw std::runtime_error("the graph's input holds " +
                             std::to_string(m.input_bytes) + " bytes, a "
                             "staged frame " + std::to_string(want));
  }
  try {
    m.cu.load();
    // the driver API does not make a context current on a new thread
    m.cu.check(m.cu.cuInit(0), "cuInit");
    m.cu.check(m.cu.cuDeviceGet(&m.device, m.device), "cuDeviceGet");
    m.cu.check(m.cu.cuDevicePrimaryCtxRetain(&m.ctx, m.device),
               "cuDevicePrimaryCtxRetain");
    m.ctx_retained = true;
    m.cu.check(m.cu.cuCtxSetCurrent(m.ctx), "cuCtxSetCurrent");
    for (auto& s : m.slots) {
      void* p = nullptr;
      m.cu.check(m.cu.cuMemHostAlloc(&p, m.input_bytes, 0), "cuMemHostAlloc");
      s.staging = static_cast<uint8_t*>(p);
      m.cu.check(m.cu.cuMemHostAlloc(&p, m.k * 7 * sizeof(float), 0),
                 "cuMemHostAlloc");
      s.result = static_cast<float*>(p);
      m.cu.check(m.cu.cuEventCreate(&s.done, kEventDisableTiming),
                 "cuEventCreate");
    }
    if (m.layout != Layout::kCamera) {
      m.scratch.resize(size_t(m.size) * m.size * 3);
    }
    // one warm frame through this path (driver entry points, pinned pages)
    std::vector<uint8_t> zeros(m.input_bytes, 0);
    std::vector<Detection> sink;
    int w = m.layout == Layout::kCamera ? m.cam_w : m.size;
    int h = m.layout == Layout::kCamera ? m.cam_h : m.size;
    int ch = m.layout == Layout::kCamera ? m.cam_ch : 3;
    if (infer(zeros.data(), w, h, ch, &sink) != InferStatus::kOk) {
      throw std::runtime_error("the warm frame was refused");
    }
  } catch (...) {
    m.release();
    throw;
  }
  std::fprintf(stderr,
               "[executor_cuda] configured: layout=%s input=%zuB K=%zu "
               "depth=2 (warm)\n",
               m.layout == Layout::kRgb       ? "rgb"
               : m.layout == Layout::kBlocked ? "blocked"
               : m.layout == Layout::kMerged  ? "merged"
                                              : "camera",
               m.input_bytes, m.k);
}

CudaExecutor::~CudaExecutor() { impl_->release(); }

InferStatus CudaExecutor::submit(const uint8_t* frame, int width, int height,
                                 int channels) {
  Impl& m = *impl_;
  if (m.layout == Layout::kCamera) {
    if (width != m.cam_w || height != m.cam_h || channels != m.cam_ch)
      return InferStatus::kGeometryError;
  } else if (width != m.size || height != m.size ||
             (channels != 3 && channels != 4 && channels != 0)) {
    return InferStatus::kGeometryError;
  }
  const int i = m.free_slot();
  Impl::Slot& s = m.slots[i];
  if (m.layout == Layout::kCamera) {
    std::memcpy(s.staging, frame, m.input_bytes);
  } else {
    stage_frame(m.layout, m.size, frame, width, height, channels,
                m.scratch.data(), s.staging);
  }
  s.busy = true;
  m.queue.push_back({i, false, {}});
  m.cu.check(m.cu.cuMemcpyHtoDAsync(m.input, s.staging, m.input_bytes,
                                    m.stream),
             "cuMemcpyHtoDAsync");
  m.cu.check(m.cu.cuGraphLaunch(m.graph, m.stream), "cuGraphLaunch");
  m.cu.check(m.cu.cuMemcpyDtoHAsync(s.result, m.packed,
                                    m.k * 7 * sizeof(float), m.stream),
             "cuMemcpyDtoHAsync");
  m.cu.check(m.cu.cuEventRecord(s.done, m.stream), "cuEventRecord");
  return InferStatus::kOk;
}

InferStatus CudaExecutor::collect(std::vector<Detection>* out) {
  Impl& m = *impl_;
  out->clear();
  if (m.queue.empty()) return InferStatus::kGeometryError;  // API misuse
  Impl::Entry& e = m.queue.front();
  if (!e.ready) m.finish(&e);
  *out = std::move(e.dets);
  m.queue.pop_front();
  return InferStatus::kOk;
}

InferStatus CudaExecutor::infer(const uint8_t* frame, int width, int height,
                                int channels, std::vector<Detection>* out) {
  // submit + collect; earlier frames still in flight are finished first so
  // that this frame's result is the one returned
  out->clear();
  std::vector<Detection> sink;
  while (!impl_->queue.empty()) collect(&sink);
  InferStatus st = submit(frame, width, height, channels);
  if (st != InferStatus::kOk) return st;
  return collect(out);
}

}  // namespace unina
