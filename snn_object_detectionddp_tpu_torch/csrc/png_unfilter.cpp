// Undo the PNG row filters of an 8-bit, non-interlaced image in place.
//
// Host code, not a kernel: the port's replacement for the row
// reconstruction that libpng does inside cv2.imread (JAX package:
// data/pipeline.py::_decode_frame) and inside native/loader.cpp. Python
// inflates the IDAT stream with zlib and hands the result here; the pixel
// conversion to RGB stays in numpy (data/png.py).
//
// Layout: `buf` holds `h` rows of 1 + `row_bytes` bytes, each a filter type
// (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth; PNG spec section 9) followed by
// the filtered bytes. Every row is rewritten with its reconstructed bytes;
// the type bytes are left as they are. `bpp` is the bytes per complete
// pixel (1 to 4 at 8 bits a sample). All arithmetic is modulo 256, so the
// result is bit-equal to the numpy plain version
// (data/png.py::unfilter_reference).
//
// Average and Paeth depend on the byte just reconstructed to their left,
// so a row is one sequential pass; rows depend on the row above. What
// bounds it is that dependency chain (a few operations a byte), not memory:
// a 480x640 RGB frame is 0.9 MB. The entry point is called through ctypes,
// which releases the interpreter lock, so the loader's threads decode
// frames side by side.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

}  // namespace

// Returns 0, -1 on a bad argument, or y + 1 for row y with an unknown
// filter type (rows above it are reconstructed, it and those below not).
extern "C" int snn_png_unfilter(uint8_t* buf, int h, int row_bytes, int bpp) {
    if (buf == nullptr || h < 0 || row_bytes < 0 || bpp < 1 || bpp > 8) return -1;
    const long stride = static_cast<long>(row_bytes) + 1;
    const uint8_t* prev = nullptr;  // reconstructed row above, none for row 0
    for (int y = 0; y < h; ++y) {
        uint8_t* cur = buf + y * stride + 1;
        const int type = cur[-1];
        switch (type) {
            case 0:
                break;
            case 1:
                for (int i = bpp; i < row_bytes; ++i) cur[i] = static_cast<uint8_t>(cur[i] + cur[i - bpp]);
                break;
            case 2:
                if (prev != nullptr)
                    for (int i = 0; i < row_bytes; ++i) cur[i] = static_cast<uint8_t>(cur[i] + prev[i]);
                break;
            case 3:
                for (int i = 0; i < row_bytes; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = prev != nullptr ? prev[i] : 0;
                    cur[i] = static_cast<uint8_t>(cur[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int i = 0; i < row_bytes; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = prev != nullptr ? prev[i] : 0;
                    const int c = (i >= bpp && prev != nullptr) ? prev[i - bpp] : 0;
                    cur[i] = static_cast<uint8_t>(cur[i] + paeth(a, b, c));
                }
                break;
            default:
                return y + 1;
        }
        prev = cur;
    }
    return 0;
}
