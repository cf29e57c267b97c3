// Embedded-CPython executor: drives runtime/embed.py make_executor from
// C++. The hot path hands the interpreter a zero-copy memoryview of the
// frame; only the packed detection blob (u32 count + 24-byte records, or
// the 0xFFFFFFFF geometry sentinel) comes back.
#include "executor_py.h"

#include <Python.h>

#include <cstring>
#include <mutex>
#include <stdexcept>
#include <string>

namespace unina {

void ensure_interpreter() {
  static std::once_flag once;
  std::call_once(once, [] {
    if (Py_IsInitialized()) return;
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;  // the host handles SIGINT/SIGTERM
#ifdef UNINA_PYTHON_EXE
    // the interpreter the host was built for: its prefix, and a virtual
    // environment's site-packages, follow from the executable's path
    PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                          UNINA_PYTHON_EXE);
    if (PyStatus_Exception(st)) {
      PyConfig_Clear(&config);
      throw std::runtime_error("cannot set the interpreter's program name");
    }
#endif
    PyStatus st2 = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(st2)) {
      throw std::runtime_error(std::string("Python initialisation failed: ") +
                               (st2.err_msg ? st2.err_msg : "?"));
    }
    PyEval_SaveThread();  // the frame loop runs without the lock
  });
}

std::string python_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  if (!type) return "unknown Python error";
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = reinterpret_cast<PyTypeObject*>(type)->tp_name;
  if (value) {
    PyObject* s = PyObject_Str(value);
    const char* text = s ? PyUnicode_AsUTF8(s) : nullptr;
    if (text) msg += std::string(": ") + text;
    Py_XDECREF(s);
    PyErr_Clear();
  }
  PyErr_Restore(type, value, tb);
  PyErr_Print();  // the traceback, to stderr; clears the error
  return msg;
}

struct PyExecutor::Impl {
  PyObject* execute_fn = nullptr;
};

PyExecutor::PyExecutor(const std::string& artifact_dir, int input_size,
                       int num_classes)
    : impl_(new Impl) {
  ensure_interpreter();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* mod = PyImport_ImportModule("unina_yolo_dla_torch.runtime.embed");
  PyObject* make =
      mod ? PyObject_GetAttrString(mod, "make_executor") : nullptr;
  Py_XDECREF(mod);
  if (make) {
    impl_->execute_fn = PyObject_CallFunction(
        make, "sii", artifact_dir.c_str(), input_size, num_classes);
    Py_DECREF(make);
  }
  if (!impl_->execute_fn) {
    std::string err = python_error();
    PyGILState_Release(gil);
    delete impl_;
    throw std::runtime_error("make_executor() failed: " + err);
  }
  PyGILState_Release(gil);
}

PyExecutor::~PyExecutor() {
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_DECREF(impl_->execute_fn);
  PyGILState_Release(gil);
  delete impl_;
}

InferStatus PyExecutor::infer(const uint8_t* frame, int width, int height,
                              int channels, std::vector<Detection>* out) {
  out->clear();
  PyGILState_STATE gil = PyGILState_Ensure();
  // channels == 0 is the NV12-planar sentinel (frame_ring.hpp): the
  // payload is w*h luma + w*h/2 interleaved chroma, not w*h*channels.
  Py_ssize_t nbytes =
      channels == 0
          ? static_cast<Py_ssize_t>(width) * height * 3 / 2
          : static_cast<Py_ssize_t>(width) * height * channels;
  PyObject* view = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<uint8_t*>(frame)), nbytes,
      PyBUF_READ);
  PyObject* result =
      view ? PyObject_CallFunction(impl_->execute_fn, "Oiii", view, width,
                                   height, channels)
           : nullptr;
  Py_XDECREF(view);
  if (!result) {
    std::string err = python_error();
    PyGILState_Release(gil);
    throw std::runtime_error("executor call failed: " + err);
  }
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(result, &buf, &len) != 0 ||
      len < static_cast<Py_ssize_t>(sizeof(uint32_t))) {
    Py_DECREF(result);
    PyErr_Clear();
    PyGILState_Release(gil);
    throw std::runtime_error("executor returned no detection blob");
  }
  uint32_t count;
  std::memcpy(&count, buf, sizeof(count));
  InferStatus status = InferStatus::kOk;
  if (count == 0xFFFFFFFFu) {
    status = InferStatus::kGeometryError;
  } else {
    size_t need = sizeof(uint32_t) + size_t(count) * sizeof(Detection);
    if (static_cast<size_t>(len) != need) {
      Py_DECREF(result);
      PyGILState_Release(gil);
      throw std::runtime_error("executor blob size does not match its count");
    }
    out->resize(count);
    std::memcpy(out->data(), buf + sizeof(uint32_t),
                count * sizeof(Detection));
  }
  Py_DECREF(result);
  PyGILState_Release(gil);
  return status;
}

}  // namespace unina
