// OpenCV's raster primitives as the synthetic "hard" generator calls them,
// on 8-bit images, without OpenCV.
//
// Host code, not a kernel: the port's replacement for the cv2 calls of the
// JAX package's data/synthetic.py (_textured_background, _draw_shape,
// make_sequence_hard). Each entry point follows OpenCV's own arithmetic
// (imgproc/src/drawing.cpp and resize.cpp, as the OpenCV 5.0.0 build this
// was held against behaves) so its bytes equal cv2's; the tests hold every
// primitive to cv2 over seeded random draws (tests/test_torch_raster.py).
//
// Drawing (image HxWx3 uint8, colour 3 bytes, LINE_8, shift 0):
// - snn_raster_rectangle: cv2.rectangle at any thickness (-1 fills);
// - snn_raster_ellipse: cv2.ellipse over the full 0-360 degrees at angle 0,
//   filled (thickness -1) or outlined;
// - snn_raster_fill_poly: cv2.fillPoly of one contour;
// - snn_raster_polylines: cv2.polylines of one contour, open or closed.
// Points are kept in 16-bit fixed point (XY_SHIFT) where OpenCV keeps them.
// Rules that matter for the bytes, each checked against cv2:
// - a thin line is Bresenham between rounded endpoints (LineIterator, left
//   to right), clipped to the image first;
// - a thick line is first clipped to the image grown by the thickness,
//   then drawn as a filled quadrilateral (offsets rounded half to even)
//   with a filled circle of radius round(thickness / 2) at each cap;
// - a convex polygon (rectangle fill, thick-line quad, filled ellipse) is
//   outlined and scanned with its edges stepped in fixed point (the
//   outline of a fixed-point polygon is OpenCV's Line2, clipped in fixed
//   point);
// - fillPoly outlines each edge with Bresenham, then scans an edge table
//   whose left ends round up and right ends round down; an edge that
//   leaves the image takes the x of its clipped endpoints;
// - ellipse2Poly steps 90, 30, 18 or 5 degrees by the longer axis through
//   OpenCV's table of sines rounded to 7 decimals.
//
// Resize (snn_raster_resize_cubic): cv2.resize(..., INTER_CUBIC) of an
// HxWx3 uint8 image as cv2 computes it by default in a build with Intel
// IPP (the reference: OpenCV 5.0.0 with ippicv 2026.0.0 on x86-64 AVX-512):
// - both source sides >= 4: IPP's cubic. Weights: Keys' kernel (A = -0.75)
//   in double at tap distances rounded to float (the phase rounded to
//   float, x0 = 1 + t, then x0 - 1, 2 - x0, 3 - x0), rounded to float; a
//   horizontal pass of fused multiply-add chains in float, then a vertical
//   pass fma(r0, w0, r1 * w1) + fma(r2, w2, r3 * w3); rounded half to
//   even. Found by reading IPP's float weights off its 32-bit float path
//   and fitting the 8-bit path's order of operations to cv2's output.
// - a source side below 4: OpenCV's own code, which cv2 then runs: Keys'
//   kernel in float, weights rounded to 11 fractional bits, a horizontal
//   pass in int32 with the border replicated, a vertical pass that for
//   runs of 8 outputs is float (S3*b3 + S2*b2 + S1*b1 + S0*b0, no fused
//   multiply-add, rounded half to even: OpenCV's SSE vector path) and for
//   the rest fixed point ((sum + 2^21) >> 22).
//
// What bounds these is the host's scalar loop over the pixels drawn; a
// 480x640 frame takes well under a millisecond for its shapes. Calls go
// through ctypes, which releases the interpreter lock.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int XY_SHIFT = 16;
constexpr int64_t XY_ONE = int64_t(1) << XY_SHIFT;
constexpr int MAX_THICKNESS = 32767;

struct Pt {
    int64_t x, y;
};

// sin of 0..450 degrees rounded to 7 decimals, as OpenCV's SinTable.
const float kSin[] = {
    0.0000000f, 0.0174524f, 0.0348995f, 0.0523360f, 0.0697565f, 0.0871557f,
    0.1045285f, 0.1218693f, 0.1391731f, 0.1564345f, 0.1736482f, 0.1908090f,
    0.2079117f, 0.2249511f, 0.2419219f, 0.2588190f, 0.2756374f, 0.2923717f,
    0.3090170f, 0.3255682f, 0.3420201f, 0.3583679f, 0.3746066f, 0.3907311f,
    0.4067366f, 0.4226183f, 0.4383711f, 0.4539905f, 0.4694716f, 0.4848096f,
    0.5000000f, 0.5150381f, 0.5299193f, 0.5446390f, 0.5591929f, 0.5735764f,
    0.5877853f, 0.6018150f, 0.6156615f, 0.6293204f, 0.6427876f, 0.6560590f,
    0.6691306f, 0.6819984f, 0.6946584f, 0.7071068f, 0.7193398f, 0.7313537f,
    0.7431448f, 0.7547096f, 0.7660444f, 0.7771460f, 0.7880108f, 0.7986355f,
    0.8090170f, 0.8191520f, 0.8290376f, 0.8386706f, 0.8480481f, 0.8571673f,
    0.8660254f, 0.8746197f, 0.8829476f, 0.8910065f, 0.8987940f, 0.9063078f,
    0.9135455f, 0.9205049f, 0.9271839f, 0.9335804f, 0.9396926f, 0.9455186f,
    0.9510565f, 0.9563048f, 0.9612617f, 0.9659258f, 0.9702957f, 0.9743701f,
    0.9781476f, 0.9816272f, 0.9848078f, 0.9876883f, 0.9902681f, 0.9925462f,
    0.9945219f, 0.9961947f, 0.9975641f, 0.9986295f, 0.9993908f, 0.9998477f,
    1.0000000f, 0.9998477f, 0.9993908f, 0.9986295f, 0.9975641f, 0.9961947f,
    0.9945219f, 0.9925462f, 0.9902681f, 0.9876883f, 0.9848078f, 0.9816272f,
    0.9781476f, 0.9743701f, 0.9702957f, 0.9659258f, 0.9612617f, 0.9563048f,
    0.9510565f, 0.9455186f, 0.9396926f, 0.9335804f, 0.9271839f, 0.9205049f,
    0.9135455f, 0.9063078f, 0.8987940f, 0.8910065f, 0.8829476f, 0.8746197f,
    0.8660254f, 0.8571673f, 0.8480481f, 0.8386706f, 0.8290376f, 0.8191520f,
    0.8090170f, 0.7986355f, 0.7880108f, 0.7771460f, 0.7660444f, 0.7547096f,
    0.7431448f, 0.7313537f, 0.7193398f, 0.7071068f, 0.6946584f, 0.6819984f,
    0.6691306f, 0.6560590f, 0.6427876f, 0.6293204f, 0.6156615f, 0.6018150f,
    0.5877853f, 0.5735764f, 0.5591929f, 0.5446390f, 0.5299193f, 0.5150381f,
    0.5000000f, 0.4848096f, 0.4694716f, 0.4539905f, 0.4383711f, 0.4226183f,
    0.4067366f, 0.3907311f, 0.3746066f, 0.3583679f, 0.3420201f, 0.3255682f,
    0.3090170f, 0.2923717f, 0.2756374f, 0.2588190f, 0.2419219f, 0.2249511f,
    0.2079117f, 0.1908090f, 0.1736482f, 0.1564345f, 0.1391731f, 0.1218693f,
    0.1045285f, 0.0871557f, 0.0697565f, 0.0523360f, 0.0348995f, 0.0174524f,
    0.0000000f, -0.0174524f, -0.0348995f, -0.0523360f, -0.0697565f, -0.0871557f,
    -0.1045285f, -0.1218693f, -0.1391731f, -0.1564345f, -0.1736482f, -0.1908090f,
    -0.2079117f, -0.2249511f, -0.2419219f, -0.2588190f, -0.2756374f, -0.2923717f,
    -0.3090170f, -0.3255682f, -0.3420201f, -0.3583679f, -0.3746066f, -0.3907311f,
    -0.4067366f, -0.4226183f, -0.4383711f, -0.4539905f, -0.4694716f, -0.4848096f,
    -0.5000000f, -0.5150381f, -0.5299193f, -0.5446390f, -0.5591929f, -0.5735764f,
    -0.5877853f, -0.6018150f, -0.6156615f, -0.6293204f, -0.6427876f, -0.6560590f,
    -0.6691306f, -0.6819984f, -0.6946584f, -0.7071068f, -0.7193398f, -0.7313537f,
    -0.7431448f, -0.7547096f, -0.7660444f, -0.7771460f, -0.7880108f, -0.7986355f,
    -0.8090170f, -0.8191520f, -0.8290376f, -0.8386706f, -0.8480481f, -0.8571673f,
    -0.8660254f, -0.8746197f, -0.8829476f, -0.8910065f, -0.8987940f, -0.9063078f,
    -0.9135455f, -0.9205049f, -0.9271839f, -0.9335804f, -0.9396926f, -0.9455186f,
    -0.9510565f, -0.9563048f, -0.9612617f, -0.9659258f, -0.9702957f, -0.9743701f,
    -0.9781476f, -0.9816272f, -0.9848078f, -0.9876883f, -0.9902681f, -0.9925462f,
    -0.9945219f, -0.9961947f, -0.9975641f, -0.9986295f, -0.9993908f, -0.9998477f,
    -1.0000000f, -0.9998477f, -0.9993908f, -0.9986295f, -0.9975641f, -0.9961947f,
    -0.9945219f, -0.9925462f, -0.9902681f, -0.9876883f, -0.9848078f, -0.9816272f,
    -0.9781476f, -0.9743701f, -0.9702957f, -0.9659258f, -0.9612617f, -0.9563048f,
    -0.9510565f, -0.9455186f, -0.9396926f, -0.9335804f, -0.9271839f, -0.9205049f,
    -0.9135455f, -0.9063078f, -0.8987940f, -0.8910065f, -0.8829476f, -0.8746197f,
    -0.8660254f, -0.8571673f, -0.8480481f, -0.8386706f, -0.8290376f, -0.8191520f,
    -0.8090170f, -0.7986355f, -0.7880108f, -0.7771460f, -0.7660444f, -0.7547096f,
    -0.7431448f, -0.7313537f, -0.7193398f, -0.7071068f, -0.6946584f, -0.6819984f,
    -0.6691306f, -0.6560590f, -0.6427876f, -0.6293204f, -0.6156615f, -0.6018150f,
    -0.5877853f, -0.5735764f, -0.5591929f, -0.5446390f, -0.5299193f, -0.5150381f,
    -0.5000000f, -0.4848096f, -0.4694716f, -0.4539905f, -0.4383711f, -0.4226183f,
    -0.4067366f, -0.3907311f, -0.3746066f, -0.3583679f, -0.3420201f, -0.3255682f,
    -0.3090170f, -0.2923717f, -0.2756374f, -0.2588190f, -0.2419219f, -0.2249511f,
    -0.2079117f, -0.1908090f, -0.1736482f, -0.1564345f, -0.1391731f, -0.1218693f,
    -0.1045285f, -0.0871557f, -0.0697565f, -0.0523360f, -0.0348995f, -0.0174524f,
    -0.0000000f, 0.0174524f, 0.0348995f, 0.0523360f, 0.0697565f, 0.0871557f,
    0.1045285f, 0.1218693f, 0.1391731f, 0.1564345f, 0.1736482f, 0.1908090f,
    0.2079117f, 0.2249511f, 0.2419219f, 0.2588190f, 0.2756374f, 0.2923717f,
    0.3090170f, 0.3255682f, 0.3420201f, 0.3583679f, 0.3746066f, 0.3907311f,
    0.4067366f, 0.4226183f, 0.4383711f, 0.4539905f, 0.4694716f, 0.4848096f,
    0.5000000f, 0.5150381f, 0.5299193f, 0.5446390f, 0.5591929f, 0.5735764f,
    0.5877853f, 0.6018150f, 0.6156615f, 0.6293204f, 0.6427876f, 0.6560590f,
    0.6691306f, 0.6819984f, 0.6946584f, 0.7071068f, 0.7193398f, 0.7313537f,
    0.7431448f, 0.7547096f, 0.7660444f, 0.7771460f, 0.7880108f, 0.7986355f,
    0.8090170f, 0.8191520f, 0.8290376f, 0.8386706f, 0.8480481f, 0.8571673f,
    0.8660254f, 0.8746197f, 0.8829476f, 0.8910065f, 0.8987940f, 0.9063078f,
    0.9135455f, 0.9205049f, 0.9271839f, 0.9335804f, 0.9396926f, 0.9455186f,
    0.9510565f, 0.9563048f, 0.9612617f, 0.9659258f, 0.9702957f, 0.9743701f,
    0.9781476f, 0.9816272f, 0.9848078f, 0.9876883f, 0.9902681f, 0.9925462f,
    0.9945219f, 0.9961947f, 0.9975641f, 0.9986295f, 0.9993908f, 0.9998477f,
    1.0000000f,
};

struct Canvas {
    uint8_t* data;
    int h, w;
    const uint8_t* color;
    void hline(int y, int x1, int x2) const {
        uint8_t* p = data + (static_cast<size_t>(y) * w + x1) * 3;
        for (int x = x1; x <= x2; ++x, p += 3) {
            p[0] = color[0];
            p[1] = color[1];
            p[2] = color[2];
        }
    }
    void put(int64_t x, int64_t y) const {
        uint8_t* p = data + (static_cast<size_t>(y) * w + x) * 3;
        p[0] = color[0];
        p[1] = color[1];
        p[2] = color[2];
    }
    void put_clipped(int64_t x, int64_t y) const {
        if (0 <= x && x < w && 0 <= y && y < h) put(x, y);
    }
};

inline int64_t round_half_even(double v) { return static_cast<int64_t>(std::nearbyint(v)); }

inline bool outside(const Pt& p, int64_t w, int64_t h) {
    return static_cast<uint64_t>(p.x) >= static_cast<uint64_t>(w) ||
           static_cast<uint64_t>(p.y) >= static_cast<uint64_t>(h);
}

// Cohen-Sutherland clip of the segment to [0, width) x [0, height), in
// place (cv::clipLine). The points move even when it returns false.
bool clip_line(int64_t width, int64_t height, Pt& p1, Pt& p2) {
    if (width <= 0 || height <= 0) return false;
    const int64_t right = width - 1, bottom = height - 1;
    int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += static_cast<int64_t>(static_cast<double>(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += static_cast<int64_t>(static_cast<double>(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += static_cast<int64_t>(static_cast<double>(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += static_cast<int64_t>(static_cast<double>(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// 8-connected line between pixel centres (LineIterator, left to right).
void line8(const Canvas& cv, Pt a, Pt b) {
    if ((outside(a, cv.w, cv.h) || outside(b, cv.w, cv.h)) && !clip_line(cv.w, cv.h, a, b)) return;
    int dx = static_cast<int>(b.x - a.x), dy = static_cast<int>(b.y - a.y);
    int major = 1, minor = 1;
    if (dx < 0) {
        dx = -dx;
        dy = -dy;
        std::swap(a, b);
    }
    if (dy < 0) {
        dy = -dy;
        minor = -1;
    }
    const bool vert = dy > dx;
    if (vert) {
        std::swap(dx, dy);
        std::swap(major, minor);
    }
    int err = dx - (dy + dy);
    int64_t x = a.x, y = a.y;
    for (int i = 0; i <= dx; ++i) {
        cv.put(x, y);
        const bool step = err < 0;
        err += -(dy + dy) + (step ? dx + dx : 0);
        if (!vert) {
            x += major;
            if (step) y += minor;
        } else {
            y += major;
            if (step) x += minor;
        }
    }
}

inline Pt round_fixed(const Pt& p) {
    return Pt{(p.x + (XY_ONE >> 1)) >> XY_SHIFT, (p.y + (XY_ONE >> 1)) >> XY_SHIFT};
}

// Line between fixed-point points, clipped in fixed point (OpenCV's Line2):
// the outline of a fixed-point polygon.
void line_fixed(const Canvas& cv, Pt p1, Pt p2) {
    if (!clip_line(static_cast<int64_t>(cv.w) << XY_SHIFT, static_cast<int64_t>(cv.h) << XY_SHIFT, p1, p2)) return;
    int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
    const int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
    const int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
    int64_t x_step = XY_ONE, y_step = XY_ONE;
    int ecount;
    if (ax > ay) {
        dy = (dy ^ j) - j;
        if (j) std::swap(p1, p2);
        y_step = (dy * XY_ONE) / (ax | 1);
        ecount = static_cast<int>((p2.x - p1.x) >> XY_SHIFT);
    } else {
        dx = (dx ^ i) - i;
        if (i) std::swap(p1, p2);
        x_step = (dx * XY_ONE) / (ay | 1);
        ecount = static_cast<int>((p2.y - p1.y) >> XY_SHIFT);
    }
    p1.x += XY_ONE >> 1;
    p1.y += XY_ONE >> 1;
    const Pt end = round_fixed(p2);
    cv.put_clipped(end.x, end.y);
    if (ax > ay) {
        p1.x >>= XY_SHIFT;
        for (; ecount >= 0; --ecount, p1.x++, p1.y += y_step) cv.put_clipped(p1.x, p1.y >> XY_SHIFT);
    } else {
        p1.y >>= XY_SHIFT;
        for (; ecount >= 0; --ecount, p1.x += x_step, p1.y++) cv.put_clipped(p1.x >> XY_SHIFT, p1.y);
    }
}

// Convex polygon, outlined and scanned (OpenCV's FillConvexPoly, LINE_8).
// `shift` is the fractional bits of `v`: 0 or XY_SHIFT.
void fill_convex(const Canvas& cv, const Pt* v, int npts, int shift) {
    struct {
        int idx, di;
        int64_t x, dx;
        int ye;
    } edge[2];
    const int delta = 1 << shift >> 1;
    int imin = 0, edges = npts;
    int64_t xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
    Pt p0{v[npts - 1].x << (XY_SHIFT - shift), v[npts - 1].y << (XY_SHIFT - shift)};
    for (int i = 0; i < npts; ++i) {
        const Pt& q = v[i];
        if (q.y < ymin) {
            ymin = q.y;
            imin = i;
        }
        ymax = std::max(ymax, q.y);
        xmax = std::max(xmax, q.x);
        xmin = std::min(xmin, q.x);
        const Pt p{q.x << (XY_SHIFT - shift), q.y << (XY_SHIFT - shift)};
        if (shift == 0)
            line8(cv, Pt{p0.x >> XY_SHIFT, p0.y >> XY_SHIFT}, Pt{p.x >> XY_SHIFT, p.y >> XY_SHIFT});
        else
            line_fixed(cv, p0, p);
        p0 = p;
    }
    xmin = (xmin + delta) >> shift;
    xmax = (xmax + delta) >> shift;
    ymin = (ymin + delta) >> shift;
    ymax = (ymax + delta) >> shift;
    if (npts < 3 || static_cast<int>(xmax) < 0 || static_cast<int>(ymax) < 0 || static_cast<int>(xmin) >= cv.w ||
        static_cast<int>(ymin) >= cv.h)
        return;
    ymax = std::min<int64_t>(ymax, cv.h - 1);
    edge[0].idx = edge[1].idx = imin;
    int y = static_cast<int>(ymin);
    edge[0].ye = edge[1].ye = y;
    edge[0].di = 1;
    edge[1].di = npts - 1;
    edge[0].x = edge[1].x = -XY_ONE;
    edge[0].dx = edge[1].dx = 0;
    do {
        for (int i = 0; i < 2; ++i) {
            if (y < edge[i].ye) continue;
            int idx0 = edge[i].idx, di = edge[i].di;
            int idx = idx0 + di;
            if (idx >= npts) idx -= npts;
            for (; edges-- > 0;) {
                const int ty = static_cast<int>((v[idx].y + delta) >> shift);
                if (ty > y) {
                    const int64_t xs = v[idx0].x << (XY_SHIFT - shift), xe = v[idx].x << (XY_SHIFT - shift);
                    const int64_t rows = static_cast<int64_t>(ty) - y;
                    edge[i].ye = ty;
                    edge[i].dx = ((xe - xs) * 2 + rows) / (2 * rows);
                    edge[i].x = xs;
                    edge[i].idx = idx;
                    break;
                }
                idx0 = idx;
                idx += di;
                if (idx >= npts) idx -= npts;
            }
        }
        if (edges < 0) break;
        if (y >= 0) {
            const int left = edge[0].x > edge[1].x ? 1 : 0, right = 1 - left;
            int x1 = static_cast<int>((edge[left].x + (XY_ONE >> 1)) >> XY_SHIFT);
            int x2 = static_cast<int>((edge[right].x + (XY_ONE >> 1)) >> XY_SHIFT);
            if (x2 >= 0 && x1 < cv.w) {
                cv.hline(y, std::max(x1, 0), std::min(x2, cv.w - 1));
            }
        }
        edge[0].x += edge[0].dx;
        edge[1].x += edge[1].dx;
    } while (++y <= static_cast<int>(ymax));
}

// Filled midpoint circle (OpenCV's Circle with fill; thick-line caps).
void filled_circle(const Canvas& cv, int cx, int cy, int radius) {
    int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
    const bool inside = cx >= radius && cx < cv.w - radius && cy >= radius && cy < cv.h - radius;
    auto span = [&](int y, int xa, int xb) {  // one row, clipped
        if (static_cast<unsigned>(y) < static_cast<unsigned>(cv.h)) cv.hline(y, xa, xb);
    };
    while (dx >= dy) {
        int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
        int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
        if (inside) {
            span(y11, x11, x12);
            span(y12, x11, x12);
            span(y21, x21, x22);
            span(y22, x21, x22);
        } else if (x11 < cv.w && x12 >= 0 && y21 < cv.h && y22 >= 0) {
            x11 = std::max(x11, 0);
            x12 = std::min(x12, cv.w - 1);
            span(y11, x11, x12);
            span(y12, x11, x12);
            if (x21 < cv.w && x22 >= 0) {
                x21 = std::max(x21, 0);
                x22 = std::min(x22, cv.w - 1);
                span(y21, x21, x22);
                span(y22, x21, x22);
            }
        }
        dy++;
        err += plus;
        plus += 2;
        const int mask = (err <= 0) - 1;
        err -= minus & mask;
        dx += mask;
        minus -= mask & 2;
    }
}

// One segment of a polyline (OpenCV's ThickLine, LINE_8). `flags` bit 0 /
// bit 1 asks for the cap at p0 / p1.
void thick_line(const Canvas& cv, Pt p0, Pt p1, int thickness, int flags, int shift) {
    if (thickness > 1 && shift == 0) {
        // clipped to the image grown by the thickness on every side
        Pt a{p0.x + thickness, p0.y + thickness}, b{p1.x + thickness, p1.y + thickness};
        if (!clip_line(cv.w + 2 * int64_t(thickness), cv.h + 2 * int64_t(thickness), a, b)) return;
        p0 = Pt{a.x - thickness, a.y - thickness};
        p1 = Pt{b.x - thickness, b.y - thickness};
    }
    p0 = Pt{p0.x << (XY_SHIFT - shift), p0.y << (XY_SHIFT - shift)};
    p1 = Pt{p1.x << (XY_SHIFT - shift), p1.y << (XY_SHIFT - shift)};
    if (thickness <= 1) {
        line8(cv, round_fixed(p0), round_fixed(p1));
        return;
    }
    const double dx = (p0.x - p1.x) / static_cast<double>(XY_ONE), dy = (p1.y - p0.y) / static_cast<double>(XY_ONE);
    double r = dx * dx + dy * dy;
    const int odd = thickness & 1;
    thickness <<= XY_SHIFT - 1;
    if (std::fabs(r) > 2.220446049250313e-16) {  // DBL_EPSILON
        r = (thickness + odd * XY_ONE * 0.5) / std::sqrt(r);
        const int64_t ox = round_half_even(dy * r), oy = round_half_even(dx * r);
        const Pt quad[4] = {{p0.x + ox, p0.y + oy}, {p0.x - ox, p0.y - oy}, {p1.x - ox, p1.y - oy}, {p1.x + ox, p1.y + oy}};
        fill_convex(cv, quad, 4, XY_SHIFT);
    }
    for (int i = 0; i < 2; ++i) {
        if (flags & (i + 1)) {
            const Pt c = round_fixed(p0);
            filled_circle(cv, static_cast<int>(c.x), static_cast<int>(c.y), (thickness + (XY_ONE >> 1)) >> XY_SHIFT);
        }
        p0 = p1;
    }
}

void poly_line(const Canvas& cv, const Pt* v, int count, bool closed, int thickness, int shift) {
    if (count <= 0) return;
    int flags = 2 + !closed;
    Pt p0 = v[closed ? count - 1 : 0];
    for (int i = !closed; i < count; ++i) {
        thick_line(cv, p0, v[i], thickness, flags, shift);
        p0 = v[i];
        flags = 2;
    }
}

struct Edge {
    int y0 = 0, y1 = 0;
    int64_t x = 0, dx = 0;
    Edge* next = nullptr;
};

// The edges of one contour, each outlined with line8 (CollectPolyEdges).
void collect_edges(const Canvas& cv, const Pt* v, int count, std::vector<Edge>& edges) {
    Pt pt0{v[count - 1].x << XY_SHIFT, v[count - 1].y}, pt1;
    for (int i = 0; i < count; ++i, pt0 = pt1) {
        pt1 = Pt{v[i].x << XY_SHIFT, v[i].y};
        Pt pt0c = pt0, pt1c = pt1;
        Pt t0{(pt0.x + (XY_ONE >> 1)) >> XY_SHIFT, pt0.y}, t1{(pt1.x + (XY_ONE >> 1)) >> XY_SHIFT, pt1.y};
        line8(cv, t0, t1);
        if (outside(t0, cv.w, cv.h) || outside(t1, cv.w, cv.h)) {
            // an edge leaving the image takes the x of its clipped ends
            clip_line(cv.w, cv.h, t0, t1);
            if (t0.y != t1.y) {
                pt0c.y = t0.y;
                pt1c.y = t1.y;
            }
            pt0c.x = t0.x << XY_SHIFT;
            pt1c.x = t1.x << XY_SHIFT;
        }
        if (pt0.y == pt1.y) continue;
        Edge e;
        e.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
        if (pt0.y < pt1.y) {
            e.y0 = static_cast<int>(pt0.y);
            e.y1 = static_cast<int>(pt1.y);
            e.x = pt0c.x + (e.y0 - pt0c.y) * e.dx;
        } else {
            e.y0 = static_cast<int>(pt1.y);
            e.y1 = static_cast<int>(pt0.y);
            e.x = pt1c.x + (e.y0 - pt1c.y) * e.dx;
        }
        edges.push_back(e);
    }
}

// Scanline fill of an edge table (FillEdgeCollection): an active list kept
// sorted by x, spans from ceil(left) to floor(right).
void fill_edges(const Canvas& cv, std::vector<Edge>& edges) {
    const int total = static_cast<int>(edges.size());
    if (total < 2) return;
    int y_max = INT_MIN, y_min = INT_MAX;
    int64_t x_max = INT64_MIN, x_min = INT64_MAX;
    for (const Edge& e1 : edges) {
        const int64_t x1 = e1.x + (e1.y1 - e1.y0) * e1.dx;
        y_min = std::min(y_min, e1.y0);
        y_max = std::max(y_max, e1.y1);
        x_min = std::min({x_min, e1.x, x1});
        x_max = std::max({x_max, e1.x, x1});
    }
    if (y_max < 0 || y_min >= cv.h || x_max < 0 || x_min >= (static_cast<int64_t>(cv.w) << XY_SHIFT)) return;
    std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
        return a.y0 - b.y0 ? a.y0 < b.y0 : a.x - b.x ? a.x < b.x : a.dx < b.dx;
    });
    Edge tmp;
    tmp.y0 = INT_MAX;
    edges.push_back(tmp);  // sentinel; no reallocation below, so pointers stay valid
    tmp.next = nullptr;
    int i = 0;
    Edge* e = &edges[0];
    y_max = std::min(y_max, cv.h);
    for (int y = e->y0; y < y_max; ++y) {
        Edge *last, *prelast, *keep_prelast;
        int draw = 0;
        prelast = &tmp;
        last = tmp.next;
        while (last || e->y0 == y) {
            if (last && last->y1 == y) {  // the edge ends above this row
                prelast->next = last->next;
                last = last->next;
                continue;
            }
            keep_prelast = prelast;
            if (last && (e->y0 > y || last->x < e->x)) {
                prelast = last;
                last = last->next;
            } else if (i < total) {  // an edge starts on this row
                prelast->next = e;
                e->next = last;
                prelast = e;
                e = &edges[++i];
            } else {
                break;
            }
            if (draw) {
                if (y >= 0) {
                    const int64_t xa = std::min(keep_prelast->x, prelast->x), xb = std::max(keep_prelast->x, prelast->x);
                    int x1 = static_cast<int>((xa + XY_ONE - 1) >> XY_SHIFT);
                    int x2 = static_cast<int>(xb >> XY_SHIFT);
                    if (x1 < cv.w && x2 >= 0) cv.hline(y, std::max(x1, 0), std::min(x2, cv.w - 1));
                }
                keep_prelast->x += keep_prelast->dx;
                prelast->x += prelast->dx;
            }
            draw ^= 1;
        }
        // keep the active list sorted by x (bubble sort)
        keep_prelast = nullptr;
        do {
            prelast = &tmp;
            last = tmp.next;
            Edge* last_exchange = nullptr;
            while (last != keep_prelast && last->next != nullptr) {
                Edge* te = last->next;
                if (last->x > te->x) {
                    prelast->next = te;
                    last->next = te->next;
                    te->next = last;
                    prelast = te;
                    last_exchange = prelast;
                } else {
                    prelast = last;
                    last = te;
                }
            }
            if (last_exchange == nullptr) break;
            keep_prelast = last_exchange;
        } while (keep_prelast != tmp.next && keep_prelast != &tmp);
    }
}

// ellipse2Poly over [0, 360] at angle 0, in fixed point, duplicates dropped.
std::vector<Pt> ellipse_points(int64_t cx, int64_t cy, int64_t ax, int64_t ay) {
    int delta = static_cast<int>((std::max(ax, ay) + (XY_ONE >> 1)) >> XY_SHIFT);
    delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
    const double alpha = kSin[450], beta = kSin[0];  // cos 0, sin 0
    std::vector<Pt> out;
    Pt prev{INT64_MIN, INT64_MIN};
    for (int i = 0; i < 360 + delta; i += delta) {
        const int angle = std::min(i, 360);
        const double x = static_cast<double>(ax) * kSin[450 - angle];
        const double y = static_cast<double>(ay) * kSin[angle];
        const double px = static_cast<double>(cx) + x * alpha - y * beta;
        const double py = static_cast<double>(cy) + x * beta + y * alpha;
        Pt p{round_half_even(px / XY_ONE) << XY_SHIFT, round_half_even(py / XY_ONE) << XY_SHIFT};
        p.x += round_half_even(px - p.x);
        p.y += round_half_even(py - p.y);
        if (p.x != prev.x || p.y != prev.y) {
            out.push_back(p);
            prev = p;
        }
    }
    if (out.size() == 1) out.assign(2, Pt{cx, cy});
    return out;
}

inline void cubic_coeffs(float x, float* c) {  // interpolateCubic, A = -0.75
    const float A = -0.75f;
    c[0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A;
    c[1] = ((A + 2) * x - (A + 3)) * x * x + 1;
    c[2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
    c[3] = 1.f - c[0] - c[1] - c[2];
}

inline int16_t weight(float c) {  // saturate_cast<short>(c * 2048)
    return static_cast<int16_t>(std::min(32767L, std::max(-32768L, std::lrint(c * 2048.f))));
}

inline uint8_t saturate_u8(int v) { return static_cast<uint8_t>(std::min(255, std::max(0, v))); }

// cv2.resize INTER_CUBIC through OpenCV's own code (imgproc/src/resize.cpp).
void opencv_cubic(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw) {
    constexpr int cn = 3;
    const double scale_x = 1. / (static_cast<double>(dw) / sw), scale_y = 1. / (static_cast<double>(dh) / sh);
    const int width = dw * cn, swidth = sw * cn;
    std::vector<int> xofs(width), yofs(dh);
    std::vector<int16_t> alpha(static_cast<size_t>(width) * 4), beta(static_cast<size_t>(dh) * 4);
    int xmin = 0, xmax = dw;
    float c[4];
    for (int dx = 0; dx < dw; ++dx) {
        float fx = static_cast<float>((dx + 0.5) * scale_x - 0.5);
        const int sx = static_cast<int>(std::floor(fx));
        fx -= sx;
        if (sx < 1) xmin = dx + 1;                  // taps left of the image
        if (sx + 2 >= sw) xmax = std::min(xmax, dx);  // taps right of it
        cubic_coeffs(fx, c);
        for (int k = 0; k < cn; ++k) {
            xofs[dx * cn + k] = sx * cn + k;
            for (int j = 0; j < 4; ++j) alpha[(static_cast<size_t>(dx) * cn + k) * 4 + j] = weight(c[j]);
        }
    }
    for (int dy = 0; dy < dh; ++dy) {
        float fy = static_cast<float>((dy + 0.5) * scale_y - 0.5);
        yofs[dy] = static_cast<int>(std::floor(fy));
        fy -= yofs[dy];
        cubic_coeffs(fy, c);
        for (int j = 0; j < 4; ++j) beta[static_cast<size_t>(dy) * 4 + j] = weight(c[j]);
    }
    xmin *= cn;
    xmax *= cn;
    // horizontal pass of every source row, int32; the border replicated
    std::vector<int> rows(static_cast<size_t>(sh) * width);
    for (int y = 0; y < sh; ++y) {
        const uint8_t* S = src + static_cast<size_t>(y) * swidth;
        int* D = rows.data() + static_cast<size_t>(y) * width;
        for (int dx = 0; dx < width; ++dx) {
            const int16_t* a = alpha.data() + static_cast<size_t>(dx) * 4;
            const int sx = xofs[dx];
            if (dx >= xmin && dx < xmax) {
                D[dx] = S[sx - cn] * a[0] + S[sx] * a[1] + S[sx + cn] * a[2] + S[sx + cn * 2] * a[3];
                continue;
            }
            int v = 0;
            for (int j = 0; j < 4; ++j) {
                int sxj = sx - cn + j * cn;
                while (sxj < 0) sxj += cn;
                while (sxj >= swidth) sxj -= cn;
                v += S[sxj] * a[j];
            }
            D[dx] = v;
        }
    }
    // vertical pass: float in runs of 8 outputs, fixed point for the tail
    const float scale = 1.f / (2048 * 2048);
    for (int dy = 0; dy < dh; ++dy) {
        const int* R[4];
        for (int k = 0; k < 4; ++k) {
            const int sy = std::min(std::max(yofs[dy] - 1 + k, 0), sh - 1);
            R[k] = rows.data() + static_cast<size_t>(sy) * width;
        }
        const int16_t* b = beta.data() + static_cast<size_t>(dy) * 4;
        const float b0 = b[0] * scale, b1 = b[1] * scale, b2 = b[2] * scale, b3 = b[3] * scale;
        uint8_t* D = dst + static_cast<size_t>(dy) * width;
        const int vec_end = width - width % 8;
        int x = 0;
        for (; x < vec_end; ++x) {
            float v = static_cast<float>(R[3][x]) * b3;
            v = static_cast<float>(R[2][x]) * b2 + v;
            v = static_cast<float>(R[1][x]) * b1 + v;
            v = static_cast<float>(R[0][x]) * b0 + v;
            D[x] = saturate_u8(static_cast<int>(std::nearbyint(v)));
        }
        for (; x < width; ++x) {
            const int v = R[0][x] * b[0] + R[1][x] * b[1] + R[2][x] * b[2] + R[3][x] * b[3];
            D[x] = saturate_u8((v + (1 << 21)) >> 22);
        }
    }
}

// Keys' kernel (A = -0.75) in double, written as IPP's weights were
// matched: (A+2)|x|^3 - (A+3)|x|^2 + 1 inside 1, A|x|^3 - 5A|x|^2 +
// 8A|x| - 4A from 1 to 2.
inline double keys_kernel(double x) {
    const double A = -0.75;
    x = std::fabs(x);
    if (x < 1) return (A + 2) * std::pow(x, 3) - (A + 3) * std::pow(x, 2) + 1;
    if (x < 2) return A * std::pow(x, 3) - 5 * A * std::pow(x, 2) + 8 * A * x - 4 * A;
    return 0;
}

// One axis of the IPP cubic: for each destination index its 4 source
// indices (clamped: the border replicated) and float weights. The phase t
// of the source coordinate (d + 0.5) * s / d - 0.5 is rounded to float;
// the tap distances are x0 = float(1 + t) and x1 = x0 - 1, x2 = 2 - x0,
// x3 = 3 - x0 in float; each weight is the double kernel rounded to float.
void ipp_taps(int s, int d, std::vector<int>& idx, std::vector<float>& w) {
    idx.resize(static_cast<size_t>(d) * 4);
    w.resize(static_cast<size_t>(d) * 4);
    const double scale = static_cast<double>(s) / d;
    for (int i = 0; i < d; ++i) {
        const double f = (i + 0.5) * scale - 0.5;
        const int si = static_cast<int>(std::floor(f));
        const float t = static_cast<float>(f - si);
        const float x0 = 1.0f + t;
        const float xs[4] = {x0, x0 - 1.0f, 2.0f - x0, 3.0f - x0};
        for (int k = 0; k < 4; ++k) {
            idx[static_cast<size_t>(i) * 4 + k] = std::min(std::max(si - 1 + k, 0), s - 1);
            w[static_cast<size_t>(i) * 4 + k] = static_cast<float>(keys_kernel(xs[k]));
        }
    }
}

// cv2.resize INTER_CUBIC of a 3-channel image as cv2 runs it through Intel
// IPP (ippicv 2026.0.0, its AVX-512 kernel: the reference build the JAX
// generator's trees are written with): horizontal pass first, in float, each output a
// fused multiply-add chain over the taps in order (s0*w0, then fma with s1,
// s2, s3); vertical pass over those floats as (fma(r0, w0, r1*w1)) +
// (fma(r2, w2, r3*w3)); rounded half to even and saturated.
void ipp_cubic(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw) {
    constexpr int cn = 3;
    std::vector<int> ix, iy;
    std::vector<float> wx, wy;
    ipp_taps(sw, dw, ix, wx);
    ipp_taps(sh, dh, iy, wy);
    const size_t width = static_cast<size_t>(dw) * cn;
    std::vector<float> rows(static_cast<size_t>(sh) * width);
    for (int y = 0; y < sh; ++y) {
        const uint8_t* S = src + static_cast<size_t>(y) * sw * cn;
        float* H = rows.data() + static_cast<size_t>(y) * width;
        for (int dx = 0; dx < dw; ++dx) {
            const int* j = &ix[static_cast<size_t>(dx) * 4];
            const float* w = &wx[static_cast<size_t>(dx) * 4];
            for (int c = 0; c < cn; ++c) {
                float v = static_cast<float>(S[j[0] * cn + c]) * w[0];
                for (int k = 1; k < 4; ++k) v = std::fma(static_cast<float>(S[j[k] * cn + c]), w[k], v);
                H[static_cast<size_t>(dx) * cn + c] = v;
            }
        }
    }
    for (int dy = 0; dy < dh; ++dy) {
        const float* R[4];
        for (int k = 0; k < 4; ++k) R[k] = rows.data() + static_cast<size_t>(iy[static_cast<size_t>(dy) * 4 + k]) * width;
        const float* w = &wy[static_cast<size_t>(dy) * 4];
        uint8_t* D = dst + static_cast<size_t>(dy) * width;
        for (size_t x = 0; x < width; ++x) {
            const float a = std::fma(R[0][x], w[0], R[1][x] * w[1]);
            const float b = std::fma(R[2][x], w[2], R[3][x] * w[3]);
            D[x] = saturate_u8(static_cast<int>(std::nearbyint(a + b)));
        }
    }
}

}  // namespace

extern "C" {

// Every entry point returns 0, or -1 on an argument it refuses.

int snn_raster_rectangle(uint8_t* img, int h, int w, int x1, int y1, int x2, int y2, const uint8_t* color,
                         int thickness) {
    if (img == nullptr || color == nullptr || h <= 0 || w <= 0 || thickness > MAX_THICKNESS) return -1;
    const Canvas cv{img, h, w, color};
    const Pt pt[4] = {{x1, y1}, {x2, y1}, {x2, y2}, {x1, y2}};
    if (thickness >= 0)
        poly_line(cv, pt, 4, true, thickness, 0);
    else
        fill_convex(cv, pt, 4, 0);
    return 0;
}

int snn_raster_ellipse(uint8_t* img, int h, int w, int cx, int cy, int ax, int ay, const uint8_t* color,
                       int thickness) {
    if (img == nullptr || color == nullptr || h <= 0 || w <= 0 || ax < 0 || ay < 0 || thickness > MAX_THICKNESS)
        return -1;
    const Canvas cv{img, h, w, color};
    std::vector<Pt> v = ellipse_points(int64_t(cx) << XY_SHIFT, int64_t(cy) << XY_SHIFT, int64_t(ax) << XY_SHIFT,
                                       int64_t(ay) << XY_SHIFT);
    if (thickness >= 0)
        poly_line(cv, v.data(), static_cast<int>(v.size()), false, thickness, XY_SHIFT);
    else
        fill_convex(cv, v.data(), static_cast<int>(v.size()), XY_SHIFT);
    return 0;
}

int snn_raster_fill_poly(uint8_t* img, int h, int w, const int32_t* xy, int npts, const uint8_t* color) {
    if (img == nullptr || color == nullptr || xy == nullptr || h <= 0 || w <= 0 || npts <= 0) return -1;
    const Canvas cv{img, h, w, color};
    std::vector<Pt> v(npts);
    for (int i = 0; i < npts; ++i) v[i] = Pt{xy[2 * i], xy[2 * i + 1]};
    std::vector<Edge> edges;
    edges.reserve(npts + 1);
    collect_edges(cv, v.data(), npts, edges);
    fill_edges(cv, edges);
    return 0;
}

int snn_raster_polylines(uint8_t* img, int h, int w, const int32_t* xy, int npts, int closed, const uint8_t* color,
                         int thickness) {
    if (img == nullptr || color == nullptr || xy == nullptr || h <= 0 || w <= 0 || npts <= 0 || thickness < 0 ||
        thickness > MAX_THICKNESS)
        return -1;
    const Canvas cv{img, h, w, color};
    std::vector<Pt> v(npts);
    for (int i = 0; i < npts; ++i) v[i] = Pt{xy[2 * i], xy[2 * i + 1]};
    poly_line(cv, v.data(), npts, closed != 0, thickness, 0);
    return 0;
}


// cv2.resize(src, (dw, dh), interpolation=cv2.INTER_CUBIC) of a 3-channel
// image, as a cv2 with Intel IPP computes it by default: IPP's cubic when
// both source sides are at least 4 pixels, OpenCV's own code below that
// (where cv2 does not call IPP).
int snn_raster_resize_cubic(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw) {
    if (src == nullptr || dst == nullptr || sh < 1 || sw < 1 || dh < 1 || dw < 1) return -1;
    if (sh < 4 || sw < 4)
        opencv_cubic(src, sh, sw, dst, dh, dw);
    else
        ipp_cubic(src, sh, sw, dst, dh, dw);
    return 0;
}

}  // extern "C"
