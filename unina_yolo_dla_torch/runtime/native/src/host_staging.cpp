// Host staging and compaction (host_staging.h). Build with
// -ffp-contract=off: the NV12 formula must not fuse its products and sums.
#include "host_staging.h"

#include <cstring>

namespace unina {

void bgra_to_rgb(const uint8_t* src, size_t n_pixels, uint8_t* dst) {
  for (size_t i = 0; i < n_pixels; ++i) {
    dst[i * 3 + 0] = src[i * 4 + 2];
    dst[i * 3 + 1] = src[i * 4 + 1];
    dst[i * 3 + 2] = src[i * 4 + 0];
  }
}

// The reference PJRT executor's formula (its nv12_to_rgb), term for term.
void nv12_to_rgb_rounded(const uint8_t* src, int width, int height,
                         uint8_t* dst) {
  const uint8_t* yp = src;
  const uint8_t* uv = src + static_cast<size_t>(width) * height;
  auto clamp = [](float x) {
    return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x + 0.5f));
  };
  for (int r = 0; r < height; ++r) {
    for (int col = 0; col < width; ++col) {
      float y = 1.164f *
                (static_cast<float>(yp[static_cast<size_t>(r) * width + col]) -
                 16.0f);
      const uint8_t* c = uv + static_cast<size_t>(r / 2) * width +
                         (col / 2) * 2;
      float u = static_cast<float>(c[0]) - 128.0f;
      float v = static_cast<float>(c[1]) - 128.0f;
      uint8_t* o = dst + (static_cast<size_t>(r) * width + col) * 3;
      o[0] = clamp(y + 1.596f * v);
      o[1] = clamp(y - 0.392f * u - 0.813f * v);
      o[2] = clamp(y + 2.017f * u);
    }
  }
}

void space_to_depth(const uint8_t* rgb, int size, uint8_t* dst) {
  const int half = size / 2;
  const size_t row = static_cast<size_t>(size) * 3;
  for (int p = 0; p < half; ++p) {
    const uint8_t* r0 = rgb + static_cast<size_t>(2 * p) * row;
    const uint8_t* r1 = r0 + row;
    uint8_t* out = dst + static_cast<size_t>(p) * half * 12;
    for (int q = 0; q < half; ++q) {
      std::memcpy(out + q * 12 + 0, r0 + q * 6, 6);  // (0, 0), (0, 1)
      std::memcpy(out + q * 12 + 6, r1 + q * 6, 6);  // (1, 0), (1, 1)
    }
  }
}

bool stage_frame(Layout layout, int size, const uint8_t* frame, int width,
                 int height, int channels, uint8_t* scratch, uint8_t* dst) {
  if (width != size || height != size || layout == Layout::kCamera)
    return false;
  const size_t n = static_cast<size_t>(size) * size;
  // an RGB frame is blocked straight from the ring; a converted one from
  // scratch (or converted straight into dst when nothing is blocked)
  uint8_t* rgb_out = layout == Layout::kRgb ? dst : scratch;
  const uint8_t* rgb = rgb_out;
  if (channels == 3) {
    rgb = frame;
  } else if (channels == 4) {
    bgra_to_rgb(frame, n, rgb_out);
  } else if (channels == 0) {
    nv12_to_rgb_rounded(frame, size, size, rgb_out);
  } else {
    return false;
  }
  if (layout == Layout::kRgb) {
    if (rgb != dst) std::memcpy(dst, rgb, n * 3);
  } else {
    // the merged view holds the blocked bytes: one pass serves both
    space_to_depth(rgb, size, dst);
  }
  return true;
}

void compact_detections(const float* packed, size_t k,
                        std::vector<Detection>* out) {
  out->clear();
  for (size_t i = 0; i < k; ++i) {
    const float* row = packed + i * 7;
    if (!(row[6] > 0.5f)) continue;  // pack_records keeps valid > 0.5
    Detection d;
    d.x1 = row[0];
    d.y1 = row[1];
    d.x2 = row[2];
    d.y2 = row[3];
    d.score = row[4];
    d.class_id = static_cast<int32_t>(row[5]);
    out->push_back(d);
  }
}

}  // namespace unina
