// ring_tool — frame-ring producer/inspector for testing and benchmarks.
//
// The camera-driver stand-in: creates the shm ring, publishes N synthetic
// frames at a target FPS (producer role of the zero-copy contract), or
// dumps the detection output block.
//
//   ring_tool produce --ring SHM --width 640 --height 640 --frames 100
//                     [--fps 60] [--slots 4]
//   ring_tool read-dets --out SHM
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include "frame_ring.hpp"

namespace {

void* map_create(const char* path, size_t len) {
  int fd = ::open(path, O_RDWR | O_CREAT, 0666);
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, static_cast<off_t>(len)) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem =
      ::mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  return mem == MAP_FAILED ? nullptr : mem;
}

uint64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

int produce(int argc, char** argv) {
  std::string ring_path, format = "rgb";
  uint32_t width = 640, height = 640, slots = 4;
  long frames = 100;
  double fps = 0.0;  // 0 = as fast as possible
  for (int i = 2; i < argc - 1; ++i) {
    std::string a = argv[i];
    if (a == "--ring") ring_path = argv[++i];
    else if (a == "--width") width = std::atoi(argv[++i]);
    else if (a == "--height") height = std::atoi(argv[++i]);
    else if (a == "--frames") frames = std::atol(argv[++i]);
    else if (a == "--fps") fps = std::atof(argv[++i]);
    else if (a == "--slots") slots = std::atoi(argv[++i]);
    else if (a == "--format") format = argv[++i];
  }
  if (ring_path.empty()) return 2;

  // channels doubles as the format sentinel: 0 == NV12 planar
  uint32_t channels;
  unina::PixelFormat fmt;
  if (format == "rgb") {
    channels = 3;
    fmt = unina::PixelFormat::RGB8;
  } else if (format == "bgra") {
    channels = 4;
    fmt = unina::PixelFormat::BGRA8;
  } else if (format == "nv12") {
    channels = 0;
    fmt = unina::PixelFormat::NV12;
  } else {
    std::fprintf(stderr, "unknown --format %s (rgb|bgra|nv12)\n",
                 format.c_str());
    return 2;
  }
  uint32_t frame_bytes = channels == 0 ? width * height * 3 / 2
                                       : width * height * channels;

  size_t total = unina::ring_total_bytes(slots, frame_bytes);
  auto* ring = static_cast<unina::RingHeader*>(
      map_create(ring_path.c_str(), total));
  if (!ring) {
    std::fprintf(stderr, "cannot create ring %s\n", ring_path.c_str());
    return 1;
  }
  unina::ring_init(ring, slots, width, height, channels, fmt);

  const uint64_t period_ns =
      fps > 0 ? static_cast<uint64_t>(1e9 / fps) : 0;
  uint64_t next = now_ns();
  for (long f = 0; f < frames; ++f) {
    uint64_t seq;
    uint8_t* dst = unina::ring_begin_write(ring, &seq);
    // cheap deterministic pattern varying per frame
    if (channels == 0) {
      // NV12: luma pattern + neutral chroma (grey frame)
      std::memset(dst, static_cast<int>((f * 37) & 0xFF),
                  size_t(width) * height);
      std::memset(dst + size_t(width) * height, 128,
                  size_t(width) * height / 2);
    } else {
      std::memset(dst, static_cast<int>((f * 37) & 0xFF), frame_bytes);
      if (channels == 4) {  // opaque alpha so BGRA->RGB is well-defined
        for (size_t px = 3; px < frame_bytes; px += 4) dst[px] = 255;
      }
    }
    unina::ring_commit_write(ring, seq, now_ns());
    if (period_ns) {
      next += period_ns;
      uint64_t t = now_ns();
      if (next > t) ::usleep((next - t) / 1000);
    }
  }
  ring->shutdown.store(1, std::memory_order_release);
  std::fprintf(stderr, "[ring_tool] produced %ld frames\n", frames);
  return 0;
}

int read_dets(int argc, char** argv) {
  std::string out_path;
  for (int i = 2; i < argc - 1; ++i) {
    if (std::string(argv[i]) == "--out") out_path = argv[++i];
  }
  if (out_path.empty()) return 2;
  int fd = ::open(out_path.c_str(), O_RDONLY);
  if (fd < 0) return 1;
  struct stat st {};
  ::fstat(fd, &st);
  void* mem = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return 1;
  auto* hdr = static_cast<const unina::DetOutHeader*>(mem);
  auto* dets = reinterpret_cast<const unina::Detection*>(
      static_cast<const uint8_t*>(mem) + sizeof(unina::DetOutHeader));
  std::printf("seq=%llu count=%u latency_ms=%.3f\n",
              (unsigned long long)hdr->result_seq.load(), hdr->count,
              hdr->latency_ms);
  for (uint32_t i = 0; i < hdr->count; ++i) {
    std::printf("  [%u] cls=%d score=%.3f box=(%.1f,%.1f,%.1f,%.1f)\n", i,
                dets[i].class_id, dets[i].score, dets[i].x1, dets[i].y1,
                dets[i].x2, dets[i].y2);
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: ring_tool {produce|read-dets} ...\n");
    return 2;
  }
  std::string cmd = argv[1];
  if (cmd == "produce") return produce(argc, argv);
  if (cmd == "read-dets") return read_dets(argc, argv);
  std::fprintf(stderr, "unknown command %s\n", cmd.c_str());
  return 2;
}
