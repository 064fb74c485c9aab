// PNG scanline unfiltering for colvo_torch/data/png.py.
//
// zlib inflates a PNG's image data at C speed, but the Sub, Average and
// Paeth filters run left to right within a row and read the row above, so
// undoing them is a byte-serial loop: about a second a 1080x1350 frame in
// Python. Encoders (libpng, cv2, ffmpeg) choose a filter per row, so all
// five types occur in one file.
//
// Build: colvo_torch/native/__init__.py compiles this with voxel.cpp into
// one library on first use.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// Undo the per-row filters of `rows` scanlines. `data` holds each row as
// its filter-type byte followed by `stride` filtered bytes; `out` receives
// rows x stride raw bytes. `bpp` is the bytes a pixel takes (at least 1),
// the distance to the left neighbour. Returns 0, or 1 + the index of the
// first row whose filter type is not 0-4 (nothing after it is written).
int64_t png_unfilter(const uint8_t* data, int64_t rows, int64_t stride, int64_t bpp,
                     uint8_t* out) {
  const uint8_t* prev = nullptr;  // the row above, raw; none for row 0
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t type = data[r * (stride + 1)];
    const uint8_t* in = data + r * (stride + 1) + 1;
    uint8_t* cur = out + r * stride;
    switch (type) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) cur[i] = in[i];
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return r + 1;
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
