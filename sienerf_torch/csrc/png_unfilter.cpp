// PNG scanline unfiltering (ISO/IEC 15948 section 9): the five filter types
// None, Sub, Up, Average and Paeth.  Average and Paeth depend on the pixel
// just reconstructed to the left, so a row is a sequential loop; this file
// is that loop, called through ctypes by sienerf_torch/io/png.py, which
// builds it with g++ at first use into sienerf_torch/csrc/build/.
#include <cstdint>
#include <cstdlib>

// in: `height` filtered rows of 1 + stride bytes (filter type, then the
// row); out: height x stride reconstructed bytes; bpp: bytes a pixel,
// at least 1.  Returns 0, or the 1-based row of an unknown filter type.
extern "C" int64_t png_unfilter(const uint8_t* in, uint8_t* out, int64_t height,
                                int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = in + y * (stride + 1) + 1;
    const int f = in[y * (stride + 1)];
    uint8_t* row = out + y * stride;
    const uint8_t* up = y ? row - stride : nullptr;
    if (f > 4) return y + 1;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? row[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int p = 0;
      if (f == 1) {
        p = a;
      } else if (f == 2) {
        p = b;
      } else if (f == 3) {
        p = (a + b) >> 1;
      } else if (f == 4) {
        const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
        p = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      }
      row[x] = (uint8_t)(src[x] + p);
    }
  }
  return 0;
}
