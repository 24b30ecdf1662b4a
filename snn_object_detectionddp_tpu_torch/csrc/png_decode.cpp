// Decode 8-bit, non-interlaced PNG files into RGB: the port's one PNG
// decoder.
//
// Host code, not a kernel: the port's replacement for the JAX package's
// cv2.imread (data/pipeline.py::_decode_frame) and its optional libpng
// whole-batch loader (data/native.py). No libpng: the chunks, the five row
// filters and the colour conversion are spelled out here, zlib inflates.
// The semantics are those of the port's plain version
// (data/png.py::decode_png_reference), which the tests hold this to byte for
// byte, errors included:
// - the signature is checked; every chunk's CRC is checked in file order,
//   up to and including IEND;
// - IHDR: 8-bit only, non-interlaced, colour type 0/2/3/4/6, compression
//   and filter method 0, neither side 0 (checked where the chunk is met);
// - PLTE goes into a zero-filled table of 256 entries, so an index past
//   the palette reads black, as libpng's table gives it;
// - the IDAT chunks are inflated as one zlib stream (bytes after its end
//   are ignored, as Python's zlib.decompress ignores them) and must give
//   exactly h * (1 + row_bytes) bytes;
// - the row filters are undone (PNG spec section 9; arithmetic modulo 256);
// - RGB as cv2.IMREAD_COLOR gives it, in RGB order: gray is replicated,
//   alpha dropped, a palette looked up.
//
// Entry points (plain C, called through ctypes, which releases the
// interpreter lock for the call):
// - snn_png_decode: one PNG in memory into the caller's (h, w, 3) array;
// - snn_png_unfilter: the row filters alone, in place;
// - snn_decode_batch: n files into the caller's contiguous (n, h, w, 3)
//   array on a pool of std::threads that take frame indices from an atomic
//   counter; a failure reports the lowest failing index.
// A failure fills SnnPngStatus: a code (OS error with its errno, or one of
// the ValueError kinds below) and the numbers its message needs; the
// Python side (data/native.py) words it and names the file.
//
// What bounds a frame is zlib's inflate (one core, ~0.9 MB out for a
// 480x640 RGB frame) and the filters' byte-to-byte dependency chain, not
// memory. A frame is inflated into a per-thread buffer and, for RGB,
// unfiltered straight into the output (no separate copy).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

extern "C" {

// Kept in step with data/native.py::_Status and its messages.
enum SnnPngCode {
    SNN_PNG_OK = 0,
    SNN_PNG_OS_ERROR = 1,   // os_errno: the file could not be read
    SNN_PNG_NOT_PNG,        // "not a PNG file"
    SNN_PNG_TRUNCATED,      // chunk: "truncated {chunk} chunk"
    SNN_PNG_CRC,            // chunk: "CRC mismatch in {chunk} chunk"
    SNN_PNG_NO_IEND,        // "no IEND chunk"
    SNN_PNG_BAD_IHDR,       // "bad IHDR"
    SNN_PNG_DEPTH,          // args[0]: bit depth
    SNN_PNG_INTERLACED,     //
    SNN_PNG_UNSUPPORTED,    // args: colour type, width, height
    SNN_PNG_NO_DATA,        // "no IHDR or no IDAT chunk"
    SNN_PNG_NO_PLTE,        // "palette image without a PLTE chunk"
    SNN_PNG_BAD_PLTE,       // args[0]: PLTE length, not a multiple of 3
    SNN_PNG_CORRUPT,        // args[0]: zlib's code, detail: zlib's message
    SNN_PNG_LENGTH,         // args: inflated, expected, width, height, samples
    SNN_PNG_FILTER,         // args: row, filter type
    SNN_PNG_SIZE,           // args: width, height of the frame
    SNN_PNG_INTERNAL,       // detail: what failed (out of memory)
};

struct SnnPngStatus {
    int32_t code;
    int32_t index;     // snn_decode_batch: the lowest failing frame
    int32_t os_errno;
    uint8_t chunk[4];  // the chunk type of TRUNCATED and CRC
    int64_t args[5];
    char detail[128];
};

}  // extern "C"

namespace {

const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool fail(SnnPngStatus* st, int code, int64_t a0 = 0, int64_t a1 = 0, int64_t a2 = 0,
          int64_t a3 = 0, int64_t a4 = 0) {
    st->code = code;
    st->args[0] = a0, st->args[1] = a1, st->args[2] = a2, st->args[3] = a3, st->args[4] = a4;
    return false;
}

int channels(int colour_type) {
    switch (colour_type) {
        case 0: return 1;  // gray
        case 2: return 3;  // RGB
        case 3: return 1;  // palette
        case 4: return 2;  // gray + alpha
        case 6: return 4;  // RGBA
        default: return 0;
    }
}

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

// Reconstruct one row of `n` bytes: src filtered with `type`, prev the
// reconstructed row above (nullptr for the first row). dst may be src
// (byte i reads src[i] before it writes dst[i], and dst[i - bpp] after).
// Returns false on an unknown filter type, leaving dst as it was.
bool unfilter_row(uint8_t* dst, const uint8_t* src, const uint8_t* prev, long n, int bpp, int type) {
    switch (type) {
        case 0:
            if (dst != src) std::memcpy(dst, src, n);
            return true;
        case 1:
            for (long i = 0; i < n && i < bpp; ++i) dst[i] = src[i];
            for (long i = bpp; i < n; ++i) dst[i] = static_cast<uint8_t>(src[i] + dst[i - bpp]);
            return true;
        case 2:
            if (prev == nullptr) {
                if (dst != src) std::memcpy(dst, src, n);
            } else {
                for (long i = 0; i < n; ++i) dst[i] = static_cast<uint8_t>(src[i] + prev[i]);
            }
            return true;
        case 3:
            for (long i = 0; i < n; ++i) {
                const int a = i >= bpp ? dst[i - bpp] : 0;
                const int b = prev != nullptr ? prev[i] : 0;
                dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
            }
            return true;
        case 4:
            for (long i = 0; i < n; ++i) {
                const int a = i >= bpp ? dst[i - bpp] : 0;
                const int b = prev != nullptr ? prev[i] : 0;
                const int c = (i >= bpp && prev != nullptr) ? prev[i - bpp] : 0;
                dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
            }
            return true;
        default:
            return false;
    }
}

// What the chunk walk finds.
struct Header {
    int64_t width = 0, height = 0;
    int colour_type = -1;
    bool have_plte = false;
    uint8_t palette[256 * 3];
    std::vector<std::pair<const uint8_t*, uint32_t>> idat;
};

// Walk the chunks in file order, as decode_png_reference's _chunks does:
// every chunk up to IEND has its length and CRC checked; IHDR is checked
// where it is met; the last IHDR and PLTE count.
bool walk(const uint8_t* d, size_t n, Header& hd, SnnPngStatus* st) {
    if (n < 8 || std::memcmp(d, kSignature, 8) != 0) return fail(st, SNN_PNG_NOT_PNG);
    size_t pos = 8;
    while (pos + 12 <= n) {
        const uint32_t len = be32(d + pos);
        const uint8_t* type = d + pos + 4;
        const size_t end = pos + 12 + size_t(len);
        if (end > n) {
            std::memcpy(st->chunk, type, 4);
            return fail(st, SNN_PNG_TRUNCATED);
        }
        const uint8_t* payload = d + pos + 8;
        const uLong crc = crc32(crc32(0L, type, 4), payload, len);
        if (crc != be32(d + pos + 8 + len)) {
            std::memcpy(st->chunk, type, 4);
            return fail(st, SNN_PNG_CRC);
        }
        if (std::memcmp(type, "IHDR", 4) == 0) {
            if (len != 13) return fail(st, SNN_PNG_BAD_IHDR);
            const int64_t w = be32(payload), h = be32(payload + 4);
            const int depth = payload[8], ctype = payload[9];
            if (depth != 8) return fail(st, SNN_PNG_DEPTH, depth);
            if (payload[12] != 0) return fail(st, SNN_PNG_INTERLACED);
            if (channels(ctype) == 0 || payload[10] != 0 || payload[11] != 0 || w == 0 || h == 0)
                return fail(st, SNN_PNG_UNSUPPORTED, ctype, w, h);
            hd.width = w, hd.height = h, hd.colour_type = ctype;
        } else if (std::memcmp(type, "PLTE", 4) == 0) {
            if (len % 3 != 0) return fail(st, SNN_PNG_BAD_PLTE, len);
            std::memset(hd.palette, 0, sizeof(hd.palette));
            std::memcpy(hd.palette, payload, std::min<size_t>(len, sizeof(hd.palette)));
            hd.have_plte = true;
        } else if (std::memcmp(type, "IDAT", 4) == 0) {
            hd.idat.emplace_back(payload, len);
        } else if (std::memcmp(type, "IEND", 4) == 0) {
            if (hd.colour_type < 0 || hd.idat.empty()) return fail(st, SNN_PNG_NO_DATA);
            if (hd.colour_type == 3 && !hd.have_plte) return fail(st, SNN_PNG_NO_PLTE);
            return true;
        }
        pos = end;
    }
    return fail(st, SNN_PNG_NO_IEND);
}

// Per-thread buffers, grown as needed and kept across frames.
struct Scratch {
    std::vector<uint8_t> file;
    std::unique_ptr<uint8_t[]> raw;  // the inflated rows (not zero-filled)
    size_t raw_cap = 0;
    uint8_t overflow[1 << 16];       // inflated bytes past the expected length
};

// The CORRUPT failure for zlib's return code, with Python's zlib words.
bool corrupt(SnnPngStatus* st, int rc, const char* msg) {
    if (msg == nullptr)
        msg = rc == Z_BUF_ERROR ? "incomplete or truncated stream"
              : rc == Z_STREAM_ERROR ? "inconsistent stream state"
              : rc == Z_DATA_ERROR ? "invalid input data" : "";
    std::snprintf(st->detail, sizeof(st->detail), "%s", msg);
    return fail(st, SNN_PNG_CORRUPT, rc);
}

// Inflate the IDAT chunks, one zlib stream, into s.raw: exactly `expected`
// bytes, or a CORRUPT or LENGTH failure. Past `expected` the stream is
// inflated into a small buffer only to count it, as the message says.
bool inflate_idat(const Header& hd, size_t expected, int ch, Scratch& s, SnnPngStatus* st) {
    if (s.raw_cap < expected) {
        s.raw.reset(new uint8_t[expected]);
        s.raw_cap = expected;
    }
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return corrupt(st, Z_STREAM_ERROR, zs.msg);
    size_t produced = 0, part = 0;
    int rc;
    while (true) {
        while (zs.avail_in == 0 && part < hd.idat.size()) {
            zs.next_in = const_cast<Bytef*>(hd.idat[part].first);
            zs.avail_in = hd.idat[part].second;
            ++part;
        }
        if (produced < expected) {
            zs.next_out = s.raw.get() + produced;
            zs.avail_out = uInt(std::min<size_t>(expected - produced, 1u << 30));
        } else {
            zs.next_out = s.overflow;
            zs.avail_out = sizeof(s.overflow);
        }
        const uInt room = zs.avail_out;
        rc = inflate(&zs, Z_NO_FLUSH);
        produced += room - zs.avail_out;
        if (rc == Z_STREAM_END) break;
        if (rc == Z_OK || (rc == Z_BUF_ERROR && zs.avail_in == 0 && part < hd.idat.size())) continue;
        // Z_BUF_ERROR with all input given: the stream ends early.
        const bool ok = corrupt(st, rc, rc == Z_BUF_ERROR ? nullptr : zs.msg);
        inflateEnd(&zs);
        return ok;
    }
    inflateEnd(&zs);
    if (produced != expected)
        return fail(st, SNN_PNG_LENGTH, int64_t(produced), int64_t(expected), hd.width, hd.height, ch);
    return true;
}

// Decode one PNG in memory into out (h, w, 3). The file's IHDR must give
// (h, w), else a SIZE failure with its own size.
bool decode(const uint8_t* data, size_t n, uint8_t* out, int64_t h, int64_t w, Scratch& s,
            SnnPngStatus* st) {
    Header hd;
    if (!walk(data, n, hd, st)) return false;
    if (hd.height != h || hd.width != w) return fail(st, SNN_PNG_SIZE, hd.width, hd.height);
    const int ch = channels(hd.colour_type);
    const long row_bytes = long(w) * ch;
    const size_t stride = size_t(row_bytes) + 1;
    if (!inflate_idat(hd, size_t(h) * stride, ch, s, st)) return false;
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; ++y) {
        uint8_t* src = s.raw.get() + y * stride + 1;
        uint8_t* dst_rgb = out + y * w * 3;
        // RGB rows are reconstructed straight into the output; the rest in
        // place, then converted.
        uint8_t* dst = ch == 3 ? dst_rgb : src;
        if (!unfilter_row(dst, src, prev, row_bytes, ch, src[-1]))
            return fail(st, SNN_PNG_FILTER, y, src[-1]);
        prev = dst;
        if (ch == 3) continue;
        for (int64_t x = 0; x < w; ++x) {
            uint8_t* o = dst_rgb + 3 * x;
            if (hd.colour_type == 3) {
                const uint8_t* p = hd.palette + 3 * src[x];
                o[0] = p[0], o[1] = p[1], o[2] = p[2];
            } else if (ch == 4) {
                o[0] = src[4 * x], o[1] = src[4 * x + 1], o[2] = src[4 * x + 2];
            } else {  // gray, gray + alpha
                o[0] = o[1] = o[2] = src[ch * x];
            }
        }
    }
    return true;
}

// The whole file into buf; 0 or the errno of the failing call.
int read_file(const char* path, std::vector<uint8_t>& buf) {
    const int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return errno;
    struct stat sb;
    if (fstat(fd, &sb) != 0) {
        const int e = errno;
        close(fd);
        return e;
    }
    buf.resize(size_t(sb.st_size));
    size_t got = 0;
    while (true) {
        if (got == buf.size()) buf.resize(buf.size() + 4096);  // the file grew, or st_size is 0
        const ssize_t r = read(fd, buf.data() + got, buf.size() - got);
        if (r < 0) {
            if (errno == EINTR) continue;
            const int e = errno;
            close(fd);
            return e;
        }
        if (r == 0) break;
        got += size_t(r);
    }
    buf.resize(got);
    close(fd);
    return 0;
}

bool decode_file(const char* path, uint8_t* out, int64_t h, int64_t w, Scratch& s,
                 SnnPngStatus* st) {
    const int e = read_file(path, s.file);
    if (e != 0) {
        st->os_errno = e;
        return fail(st, SNN_PNG_OS_ERROR);
    }
    return decode(s.file.data(), s.file.size(), out, h, w, s, st);
}

// Runs fn, turning an escaping exception (out of memory) into a status.
template <class F>
bool guarded(SnnPngStatus* st, F fn) {
    try {
        return fn();
    } catch (const std::exception& e) {
        std::snprintf(st->detail, sizeof(st->detail), "%s", e.what());
        return fail(st, SNN_PNG_INTERNAL);
    }
}

}  // namespace

extern "C" {

// Decode `n` bytes of PNG into out (h, w, 3) uint8. Returns 0, or 1 with
// `st` filled (a SIZE failure carries the file's own width and height).
int snn_png_decode(const uint8_t* data, long n, uint8_t* out, int64_t h, int64_t w,
                   SnnPngStatus* st) {
    std::memset(st, 0, sizeof(*st));
    st->index = -1;
    if (data == nullptr || n < 0 || out == nullptr || h < 0 || w < 0) return -1;
    auto s = std::make_unique<Scratch>();
    return guarded(st, [&] { return decode(data, size_t(n), out, h, w, *s, st); }) ? 0 : 1;
}

// Undo the row filters of `buf` in place: `h` rows of a filter-type byte
// and `row_bytes` filtered bytes, `bpp` bytes a pixel. The type bytes are
// left as they are. Returns 0, -1 on a bad argument, or y + 1 for row y
// with an unknown filter type (rows above it are reconstructed, it and
// those below not).
int snn_png_unfilter(uint8_t* buf, int h, int row_bytes, int bpp) {
    if (buf == nullptr || h < 0 || row_bytes < 0 || bpp < 1 || bpp > 8) return -1;
    const long stride = long(row_bytes) + 1;
    const uint8_t* prev = nullptr;
    for (int y = 0; y < h; ++y) {
        uint8_t* cur = buf + y * stride + 1;
        if (!unfilter_row(cur, cur, prev, row_bytes, bpp, cur[-1])) return y + 1;
        prev = cur;
    }
    return 0;
}

// Read and decode the `n` files at `paths` into out (n, h, w, 3) uint8 on
// `n_threads` threads (at most n). Each thread takes the next frame index
// from an atomic counter; after a failure no new frame is started. Returns
// 0, -1 on a bad argument, or 1 with `st` filled for the lowest failing
// index (every index below it was started, and so finished or failed).
int snn_decode_batch(const char* const* paths, int n, uint8_t* out, int h, int w, int n_threads,
                     SnnPngStatus* st) {
    std::memset(st, 0, sizeof(*st));
    st->index = -1;
    if (paths == nullptr || out == nullptr || n < 0 || h <= 0 || w <= 0) return -1;
    n_threads = std::max(1, std::min(n_threads, n));
    const size_t frame_bytes = size_t(h) * size_t(w) * 3;
    std::atomic<int> next(0);
    std::atomic<bool> failed(false);
    std::mutex mu;

    auto worker = [&]() {
        std::unique_ptr<Scratch> s;
        SnnPngStatus mine;
        while (!failed.load()) {
            const int i = next.fetch_add(1);
            if (i >= n) return;
            std::memset(&mine, 0, sizeof(mine));
            if (guarded(&mine, [&] {
                    if (!s) s = std::make_unique<Scratch>();
                    return decode_file(paths[i], out + i * frame_bytes, h, w, *s, &mine);
                }))
                continue;
            std::lock_guard<std::mutex> lock(mu);
            if (st->index < 0 || i < st->index) {
                *st = mine;
                st->index = i;
            }
            failed.store(true);
        }
    };

    std::vector<std::thread> threads;
    try {
        threads.reserve(n_threads - 1);
        for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
    } catch (const std::exception&) {
        // A thread could not be started (a thread or memory limit): the
        // threads already running, this one among them, take every frame.
    }
    worker();  // the calling thread is the first of the pool
    for (auto& th : threads) th.join();
    return st->index < 0 ? 0 : 1;
}

}  // extern "C"
