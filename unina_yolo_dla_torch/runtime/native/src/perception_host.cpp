// perception_host — native streaming-inference daemon.
//
// The ``perception_node.cpp`` equivalent (reference: ROS 2 lifecycle node,
// 815 LoC) for the PyTorch/CUDA port:
//
//   frames arrive in a zero-copy /dev/shm ring (GpuBufferPtr analogue) ->
//   lifecycle configure (load the serving artifact, validate dims, warm
//   its captured graph) -> activate -> poll loop: newest-frame drop
//   policy, per-frame guards, inference via the executor, ~1 KB packed
//   detections to the output shm block -> p50/p99 latency histogram on
//   shutdown.
//
// Usage:
//   perception_host --artifact DIR --ring /dev/shm/unina_frames
//                   --out /dev/shm/unina_dets [--input 640] [--classes 4]
//                   [--max-frames N] [--executor python|cuda]
//                   [--pipeline N] [--frame-width W --frame-height H]
//
// --executor cuda replays the artifact's captured CUDA graph through the
// driver API with no Python in the per-frame loop (executor_cuda.cpp);
// python (default) embeds CPython over runtime/embed.py make_executor —
// the only executor that serves the plain path on the CPU
// (UNINA_FORCE_CPU=1). Neither falls back to the other.
//
// --pipeline N: frames kept in flight (default: the executor's
// pipeline_depth(), 2 for cuda — frame N+1 is staged on the host while
// frame N's graph runs, the reference's async-enqueue overlap,
// perception_node.cpp:598-645; 1 forces the serial loop for A/B
// measurement).
#include <fcntl.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

#include "executor_cuda.h"
#include "executor_py.h"
#include "frame_ring.hpp"
#include "latency.hpp"
#include "lifecycle.hpp"

namespace {

volatile sig_atomic_t g_stop = 0;
void handle_sigint(int) { g_stop = 1; }

void* map_file(const char* path, size_t* out_len, bool create, size_t len) {
  int flags = create ? (O_RDWR | O_CREAT) : O_RDWR;
  int fd = ::open(path, flags, 0666);
  if (fd < 0) {
    std::fprintf(stderr, "FATAL: cannot open %s\n", path);
    return nullptr;
  }
  if (create && ::ftruncate(fd, static_cast<off_t>(len)) != 0) {
    ::close(fd);
    return nullptr;
  }
  struct stat st {};
  ::fstat(fd, &st);
  *out_len = static_cast<size_t>(st.st_size);
  void* mem = ::mmap(nullptr, *out_len, PROT_READ | PROT_WRITE, MAP_SHARED,
                     fd, 0);
  ::close(fd);
  return mem == MAP_FAILED ? nullptr : mem;
}

}  // namespace

int main(int argc, char** argv) {
  std::string artifact, ring_path, out_path, executor_kind = "python";
  int input_size = 640, num_classes = 4, frame_w = 0, frame_h = 0;
  int pipeline = 0;  // 0 = executor default
  long max_frames = -1;

  for (int i = 1; i < argc - 1; ++i) {
    std::string a = argv[i];
    if (a == "--artifact") artifact = argv[++i];
    else if (a == "--ring") ring_path = argv[++i];
    else if (a == "--out") out_path = argv[++i];
    else if (a == "--input") input_size = std::atoi(argv[++i]);
    else if (a == "--classes") num_classes = std::atoi(argv[++i]);
    else if (a == "--max-frames") max_frames = std::atol(argv[++i]);
    else if (a == "--executor") executor_kind = argv[++i];
    else if (a == "--frame-width") frame_w = std::atoi(argv[++i]);
    else if (a == "--frame-height") frame_h = std::atoi(argv[++i]);
    else if (a == "--pipeline") pipeline = std::atoi(argv[++i]);
  }
  // camera-path artifacts accept raw camera-resolution frames; the
  // pre-guard geometry defaults to the model input for square artifacts
  if (frame_w == 0) frame_w = input_size;
  if (frame_h == 0) frame_h = input_size;
  if (executor_kind != "python" && executor_kind != "cuda") {
    std::fprintf(stderr, "FATAL: --executor must be python or cuda\n");
    return 2;
  }
  if (artifact.empty() || ring_path.empty() || out_path.empty()) {
    std::fprintf(stderr,
                 "usage: perception_host --artifact DIR --ring SHM --out SHM"
                 " [--input N] [--classes N] [--max-frames N]\n");
    return 2;
  }

  ::signal(SIGINT, handle_sigint);
  ::signal(SIGTERM, handle_sigint);

  // --- map the frame ring (producer creates it; wait for magic) ---
  size_t ring_len = 0;
  unina::RingHeader* ring = nullptr;
  for (int tries = 0; tries < 600 && !g_stop; ++tries) {
    ring = static_cast<unina::RingHeader*>(
        map_file(ring_path.c_str(), &ring_len, false, 0));
    if (ring && ring_len >= sizeof(unina::RingHeader) &&
        ring->magic == unina::kRingMagic)
      break;
    if (ring) ::munmap(ring, ring_len);
    ring = nullptr;
    ::usleep(100000);
  }
  if (!ring) {
    std::fprintf(stderr, "FATAL: frame ring %s not ready\n",
                 ring_path.c_str());
    return 1;
  }

  size_t out_len = 0;
  auto* out = static_cast<unina::DetOutHeader*>(map_file(
      out_path.c_str(), &out_len, true, unina::detout_total_bytes()));
  if (!out) {
    std::fprintf(stderr, "FATAL: cannot map %s\n", out_path.c_str());
    return 1;
  }
  out->magic = unina::kRingMagic;
  out->result_seq.store(0, std::memory_order_relaxed);
  out->count = 0;
  out->latency_ms = 0.0;
  auto* out_dets = reinterpret_cast<unina::Detection*>(
      reinterpret_cast<uint8_t*>(out) + sizeof(unina::DetOutHeader));

  // --- lifecycle ---
  unina::Lifecycle lc;
  unina::Executor* exec = nullptr;
  lc.on_configure([&] {
    // engine-vs-config validation happens inside (aot.validate_artifact_
    // shapes parity with perception_node.cpp:440-457) + a warm frame
    if (executor_kind == "cuda") {
      exec = new unina::CudaExecutor(artifact, input_size, num_classes);
    } else {
      exec = new unina::PyExecutor(artifact, input_size, num_classes);
    }
    std::fprintf(stderr,
                 "[perception_host] configured (artifact=%s executor=%s)\n",
                 artifact.c_str(), executor_kind.c_str());
  });
  lc.on_cleanup([&] {
    delete exec;
    exec = nullptr;
  });

  try {
    lc.configure();
  } catch (const std::exception& e) {
    std::fprintf(stderr, "FATAL: configure failed: %s\n", e.what());
    return 1;
  }
  lc.activate();
  std::fprintf(stderr, "[perception_host] active\n");

  unina::LatencyHistogram hist;
  uint64_t last_seq = 0, total_dropped = 0, processed = 0;
  uint64_t torn_drops = 0, geom_drops = 0;
  const uint32_t w = ring->width, h = ring->height, ch = ring->channels;

  const int depth = pipeline > 0 ? pipeline : exec->pipeline_depth();
  std::fprintf(stderr, "[perception_host] pipeline depth=%d\n", depth);

  // Copy-then-validate staging buffer: a fast producer lapping the small
  // ring mid-read would otherwise hand us a silently torn frame. (The
  // executor copies/converts out of it at submit, so one buffer serves
  // any pipeline depth.)
  std::vector<uint8_t> staging(ring->frame_bytes);
  std::vector<unina::Detection> dets;

  // in-flight bookkeeping for the pipelined loop: sequence + submit time
  // of every frame the executor holds, oldest first
  struct Pending {
    uint64_t seq;
    std::chrono::steady_clock::time_point t0;
  };
  std::deque<Pending> pending;
  auto t_first = std::chrono::steady_clock::time_point{};
  auto t_last = t_first;

  // collect the oldest in-flight frame, publish its detections
  auto collect_one = [&]() -> bool {
    Pending p = pending.front();
    try {
      exec->collect(&dets);
    } catch (const unina::DriverError&) {
      throw;  // the card failed: stop the host
    } catch (const std::exception& e) {
      pending.pop_front();
      std::fprintf(stderr, "WARNING: inference failed: %s\n", e.what());
      return false;
    }
    pending.pop_front();
    auto now = std::chrono::steady_clock::now();
    double ms =
        std::chrono::duration<double, std::milli>(now - p.t0).count();
    hist.record(ms);
    ++processed;
    t_last = now;

    uint32_t n = dets.size() > unina::kMaxDetections
                     ? unina::kMaxDetections
                     : static_cast<uint32_t>(dets.size());
    std::memcpy(out_dets, dets.data(), n * sizeof(unina::Detection));
    out->count = n;
    out->latency_ms = ms;
    out->result_seq.store(p.seq, std::memory_order_release);
    return true;
  };

  // a failed driver call (DriverError) ends the loop and the host
  auto serve = [&] {
    while (!g_stop) {
      uint64_t seq = 0, ts = 0, dropped = 0;
      int got = unina::ring_read_latest(ring, last_seq, staging.data(), &seq,
                                        &ts, &dropped);
      if (got == 0) {
        // no new frame: finish in-flight work instead of idling, then
        // drain-then-exit once the producer marked end-of-stream
        if (!pending.empty()) {
          collect_one();
          continue;
        }
        if (ring->shutdown.load(std::memory_order_acquire)) break;
        ::usleep(200);
        continue;
      }
      last_seq = seq;
      total_dropped += dropped;
      if (got < 0) {  // torn by a lapping producer: drop, advance
        ++torn_drops;
        ++total_dropped;
        continue;
      }

      // per-frame guard: geometry must match the configured artifact for
      // EVERY pixel format (perception_node.cpp:588-596 policy) — wrong-
      // geometry BGRA/NV12 must not reach the executor either
      if (static_cast<int>(w) != frame_w || static_cast<int>(h) != frame_h) {
        if (++geom_drops == 1 || geom_drops % 64 == 0) {
          std::fprintf(stderr,
                       "WARNING: dropping %llu frame(s) with geometry %ux%u "
                       "!= configured %dx%d\n",
                       (unsigned long long)geom_drops, w, h, frame_w,
                       frame_h);
        }
        continue;
      }

      auto t0 = std::chrono::steady_clock::now();
      if (t_first == std::chrono::steady_clock::time_point{}) t_first = t0;
      unina::InferStatus st;
      try {
        st = exec->submit(staging.data(), w, h, ch);
      } catch (const unina::DriverError&) {
        throw;  // the card failed: stop the host
      } catch (const std::exception& e) {
        std::fprintf(stderr, "WARNING: inference failed: %s\n", e.what());
        continue;
      }
      if (st == unina::InferStatus::kGeometryError) {
        // executor-side shape sentinel: count as a drop, never publish
        ++geom_drops;
        std::fprintf(stderr,
                     "WARNING: executor rejected frame seq=%llu (geometry)\n",
                     (unsigned long long)seq);
        continue;
      }
      pending.push_back({seq, t0});
      // keep at most `depth` frames in flight: collect the oldest once the
      // window is full (depth 1: the serial loop)
      if (static_cast<int>(pending.size()) >= depth) collect_one();

      if (max_frames > 0 &&
          processed + pending.size() >= static_cast<uint64_t>(max_frames)) {
        while (!pending.empty()) collect_one();
        break;
      }
    }
    while (!pending.empty()) collect_one();  // drain in-flight on stop
  };
  try {
    serve();
  } catch (const unina::DriverError& e) {
    std::fprintf(stderr, "FATAL: %s\n", e.what());
    return 1;
  }

  lc.deactivate();
  lc.cleanup();
  double fps = 0.0;
  if (processed > 0 && t_last > t_first) {
    fps = 1e3 * static_cast<double>(processed) /
          std::chrono::duration<double, std::milli>(t_last - t_first)
              .count();
  }
  std::fprintf(stderr,
               "[perception_host] shutdown: frames=%llu dropped=%llu "
               "(torn=%llu geom=%llu) p50=%.3fms p90=%.3fms p99=%.3fms "
               "fps=%.1f pipeline=%d\n",
               (unsigned long long)processed,
               (unsigned long long)total_dropped,
               (unsigned long long)torn_drops,
               (unsigned long long)geom_drops, hist.p50(), hist.p90(),
               hist.p99(), fps, depth);
  ::munmap(ring, ring_len);
  ::munmap(out, out_len);
  return 0;
}
