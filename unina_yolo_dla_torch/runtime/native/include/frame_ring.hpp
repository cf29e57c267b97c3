// Shared-memory SPSC frame ring — the zero-copy ingestion path.
//
// The host-side equivalent of the reference's GpuBufferPtr contract
// (msg/GpuBufferPtr.msg: raw device pointer + geometry, intra-process
// only): a camera/driver process writes frames into a /dev/shm ring and
// publishes only indices; the perception host maps the same ring and
// reads frames in place — no per-frame copies on the producer/consumer
// hot path, no serialization.
//
// Single-producer single-consumer, lock-free: the producer bumps
// write_seq after filling a slot; the consumer polls and always jumps to
// the NEWEST unread frame (stale frames are dropped, keeping latency
// bounded like the reference node's frame dropping).
#pragma once

#include <atomic>
#include <cstdint>
#include <cstring>

namespace unina {

constexpr uint64_t kRingMagic = 0x554e494e41524e47ull;  // "UNINARNG"

enum class PixelFormat : uint32_t { RGB8 = 0, BGRA8 = 1, NV12 = 2 };

struct RingHeader {
  uint64_t magic;
  uint32_t version;
  uint32_t n_slots;
  uint32_t width;
  uint32_t height;
  uint32_t channels;      // bytes/px for packed formats; 0 == NV12 planar
                          // (frame_bytes must then be w*h*3/2)
  uint32_t format;        // PixelFormat
  uint32_t frame_bytes;   // payload bytes per slot
  uint32_t _pad;
  std::atomic<uint64_t> write_seq;  // frames published so far
  std::atomic<uint64_t> shutdown;   // producer sets 1 on exit
};

struct SlotHeader {
  uint64_t seq;           // 1-based publish sequence
  uint64_t timestamp_ns;  // producer capture time
};

inline size_t slot_stride(const RingHeader* h) {
  // 64-byte aligned slots: header + payload
  size_t raw = sizeof(SlotHeader) + h->frame_bytes;
  return (raw + 63) & ~size_t(63);
}

inline size_t ring_total_bytes(uint32_t n_slots, uint32_t frame_bytes) {
  size_t slot = (sizeof(SlotHeader) + frame_bytes + 63) & ~size_t(63);
  return sizeof(RingHeader) + n_slots * slot;
}

inline uint8_t* slot_ptr(RingHeader* h, uint64_t seq) {
  uint8_t* base = reinterpret_cast<uint8_t*>(h) + sizeof(RingHeader);
  return base + (seq % h->n_slots) * slot_stride(h);
}

// --- producer side ---

inline void ring_init(RingHeader* h, uint32_t n_slots, uint32_t width,
                      uint32_t height, uint32_t channels,
                      PixelFormat fmt) {
  h->magic = 0;
  h->_pad = 0;
  h->version = 1;
  h->n_slots = n_slots;
  h->width = width;
  h->height = height;
  h->channels = channels;
  h->format = static_cast<uint32_t>(fmt);
  h->frame_bytes = channels == 0 ? width * height * 3 / 2  // NV12 planar
                                 : width * height * channels;
  h->write_seq.store(0, std::memory_order_relaxed);
  h->shutdown.store(0, std::memory_order_relaxed);
  h->magic = kRingMagic;  // last: readers treat magic as "ready"
}

inline uint8_t* ring_begin_write(RingHeader* h, uint64_t* out_seq) {
  uint64_t next = h->write_seq.load(std::memory_order_relaxed) + 1;
  uint8_t* slot = slot_ptr(h, next);
  auto* sh = reinterpret_cast<SlotHeader*>(slot);
  sh->seq = 0;  // mark in-progress
  *out_seq = next;
  return slot + sizeof(SlotHeader);
}

inline void ring_commit_write(RingHeader* h, uint64_t seq,
                              uint64_t timestamp_ns) {
  uint8_t* slot = slot_ptr(h, seq);
  auto* sh = reinterpret_cast<SlotHeader*>(slot);
  sh->timestamp_ns = timestamp_ns;
  sh->seq = seq;
  h->write_seq.store(seq, std::memory_order_release);
}

// --- consumer side ---

// Returns payload pointer for the newest unread frame (> last_seq), or
// nullptr. Stale frames between last_seq and the newest are skipped.
//
// CONTRACT: the returned pointer is only stable while the producer stays
// at least n_slots-1 frames behind a full lap; a producer writing as fast
// as possible into a small ring can overwrite the slot mid-read. Consumers
// that process frames slower than the producer publishes MUST use
// ring_read_latest (copy-then-validate) instead.
inline const uint8_t* ring_poll_latest(RingHeader* h, uint64_t last_seq,
                                       uint64_t* out_seq,
                                       uint64_t* out_timestamp_ns,
                                       uint64_t* out_dropped) {
  uint64_t newest = h->write_seq.load(std::memory_order_acquire);
  if (newest <= last_seq) return nullptr;
  uint8_t* slot = slot_ptr(h, newest);
  auto* sh = reinterpret_cast<SlotHeader*>(slot);
  if (sh->seq != newest) return nullptr;  // producer mid-write; retry later
  *out_seq = newest;
  *out_timestamp_ns = sh->timestamp_ns;
  *out_dropped = newest - last_seq - 1;
  return slot + sizeof(SlotHeader);
}

// Copy-then-validate read of the newest unread frame. Copies the payload
// into ``dst`` (capacity >= h->frame_bytes), then re-validates that the
// producer did not lap the ring and start rewriting the slot during the
// copy — the torn-frame hazard ring_poll_latest leaves open.
//
// Returns: 1 = valid frame copied; 0 = nothing new; -1 = frame was torn
// by a lapping producer (out_seq is still set — the caller should advance
// its cursor and count a drop rather than spin on the same slot).
inline int ring_read_latest(RingHeader* h, uint64_t last_seq, uint8_t* dst,
                            uint64_t* out_seq, uint64_t* out_timestamp_ns,
                            uint64_t* out_dropped) {
  uint64_t newest = h->write_seq.load(std::memory_order_acquire);
  if (newest <= last_seq) return 0;
  uint8_t* slot = slot_ptr(h, newest);
  auto* sh = reinterpret_cast<SlotHeader*>(slot);
  if (sh->seq != newest) return 0;  // producer mid-write; retry later
  *out_seq = newest;
  *out_timestamp_ns = sh->timestamp_ns;
  *out_dropped = newest - last_seq - 1;
  std::memcpy(dst, slot + sizeof(SlotHeader), h->frame_bytes);
  std::atomic_thread_fence(std::memory_order_acquire);
  // A writer begins rewriting this slot when it starts frame
  // newest + n_slots, which requires write_seq == newest + n_slots - 1;
  // seeing write_seq at or past that mark means the copy may be torn.
  uint64_t newest2 = h->write_seq.load(std::memory_order_acquire);
  if (sh->seq != newest || newest2 >= newest + h->n_slots - 1) return -1;
  return 1;
}

// --- detection output queue (device->host ~1 KB contract) ---

struct Detection {
  float x1, y1, x2, y2;
  float score;
  int32_t class_id;
};  // 24 B

constexpr uint32_t kMaxDetections = 1024;  // gpu_postprocess.cu:25 parity

struct DetOutHeader {
  uint64_t magic;
  std::atomic<uint64_t> result_seq;  // frame seq this result belongs to
  uint32_t count;
  uint32_t _pad;
  double latency_ms;                 // host-measured frame latency
};

inline size_t detout_total_bytes() {
  return sizeof(DetOutHeader) + kMaxDetections * sizeof(Detection);
}

}  // namespace unina
