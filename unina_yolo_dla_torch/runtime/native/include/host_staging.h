// Host staging of a ring frame into the bytes a serving graph takes, and
// the compaction of its packed result into Detection records.
//
// The C++ counterpart of the Python staging (ops/preprocess.py
// space_to_depth_np and merged_frame_np, runtime/embed.py's BGRA slice)
// and of runtime/embed.py pack_records; the NV12 conversion rounds, as the
// reference's PJRT executor does (the Python executor truncates). Compiled
// with -ffp-contract=off: each product and sum rounds to float32 on its
// own, as numpy's float32 arithmetic does.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

#include "frame_ring.hpp"

namespace unina {

// What the graph's static input holds.
//  kRgb:     the (S, S, 3) RGB frame as it is
//  kBlocked: space-to-depth blocked (S/2, S/2, 12), channels (di, dj, c)
//  kMerged:  the same bytes viewed (S/2, S/4, 24)
//  kCamera:  the camera's raw frame as it is (its geometry and format)
enum class Layout { kRgb = 0, kBlocked = 1, kMerged = 2, kCamera = 3 };

// BGRA -> RGB over n pixels.
void bgra_to_rgb(const uint8_t* src, size_t n_pixels, uint8_t* dst);

// BT.601 limited-range NV12 (planar Y, then interleaved UV at half
// resolution) -> RGB, each channel clamped to [0, 255] and rounded.
void nv12_to_rgb_rounded(const uint8_t* src, int width, int height,
                         uint8_t* dst);

// (S, S, 3) RGB -> (S/2, S/2, 12) blocked; S even.
void space_to_depth(const uint8_t* rgb, int size, uint8_t* dst);

// Stage a square ring frame (channels 3 = RGB, 4 = BGRA, 0 = NV12) of
// side `size` into `dst` in `layout` (not kCamera); `scratch` holds
// size*size*3 bytes for a frame that is converted before blocking.
// -> false for any other geometry or channel count.
bool stage_frame(Layout layout, int size, const uint8_t* frame, int width,
                 int height, int channels, uint8_t* scratch, uint8_t* dst);

// (k, 7) float32 rows [x1, y1, x2, y2, score, cls, valid] -> the rows
// whose valid column is > 0.5, in order, as Detection records.
void compact_detections(const float* packed, size_t k,
                        std::vector<Detection>* out);

}  // namespace unina
