// PNG scanline unfiltering (PNG spec section 9) for 8-bit samples: the
// host side of gga_tpu_torch/data/kitti/png.py, which inflates the image
// data with zlib and calls this on the result. Average and Paeth depend
// on the byte just reconstructed to their left, so a row is a sequential
// loop; numpy's version (png.unfilter_numpy) is its oracle in the tests.
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// src: height rows of (1 filter byte + stride bytes); dst: height * stride
// bytes, stride = width * bpp. Returns 0, or 1 + the first row whose filter
// byte is not one of the five types (dst is then incomplete).
extern "C" int png_unfilter(const uint8_t* src, uint8_t* dst, int height,
                            int stride, int bpp) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = src + static_cast<int64_t>(y) * (stride + 1);
    uint8_t* out = dst + static_cast<int64_t>(y) * stride;
    const uint8_t* up = y ? out - stride : nullptr;
    const int type = in[0];
    ++in;
    switch (type) {
      case 0:
        for (int i = 0; i < stride; ++i) out[i] = in[i];
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:
        for (int i = 0; i < stride; ++i) out[i] = in[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          out[i] = in[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (i >= bpp && up) ? up[i - bpp] : 0;
          out[i] = in[i] + paeth(a, b, c);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
