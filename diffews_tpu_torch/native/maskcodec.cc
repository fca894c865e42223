// Native mask codecs: COCO compressed RLE and polygon rasterization.
//
// TPU-native counterpart of the reference's external native dependencies
// on the episodic data path (`pycocotools.mask` C extension and detectron2
// `polygons_to_bitmask` — evaluation_util/data/lvis.py:97-116,
// paco_part.py:105-124, pascal_part.py:125-128 in the reference).  The
// host data loader must sustain the chip's episode throughput, so the
// per-episode mask decode work (several RLEs + polygon unions at image
// resolution) runs here instead of the Python/PIL fallback in
// diffews_tpu/data/masks.py.
//
// Bit-compatibility contract (tested in tests/test_native_codec.py):
//   * the char codec, RLE expansion and mask->RLE functions produce
//     byte-identical results to the NumPy implementations in masks.py;
//   * polygon rasterization implements the COCO convention (coordinates
//     upsampled x5 and rounded, integer boundary walk, column-boundary
//     crossing parity fill) so boundary pixels land where the COCO API
//     puts them; the NumPy fallback in masks.py implements the SAME
//     convention and is bit-identical (tests/test_native_codec.py).
//
// Build: cc -O2 -shared -fPIC maskcodec.cc -o _maskcodec.so  (see
// diffews_tpu/native/__init__.py, which builds lazily on first import).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode the COCO compressed-RLE count string (5-bit varint groups biased
// by 48, sign-extended when the terminal group has bit 0x10; counts beyond
// the first two are delta-coded against counts[i-2]).  Returns the number
// of counts written, or -1 if `cap` is too small.  `cap = slen` always
// suffices (every count consumes at least one char).
int64_t rle_decode_counts(const char* s, int64_t slen, int64_t* out,
                          int64_t cap) {
  int64_t n = 0, i = 0;
  while (i < slen) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (i >= slen) return n;  // truncated input: stop at last whole count
      int64_t c = (int64_t)(unsigned char)s[i] - 48;
      x |= (c & 0x1F) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * (k + 1));
      ++k;
    }
    if (n > 2) x += out[n - 2];
    if (n >= cap) return -1;
    out[n++] = x;
  }
  return n;
}

// Encode counts into the COCO char codec.  Returns chars written, or -1 if
// `cap` is too small.  `cap = 13 * n` always suffices.
int64_t rle_encode_counts(const int64_t* counts, int64_t n, char* out,
                          int64_t cap) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = counts[i];
    if (i > 2) x -= counts[i - 2];
    bool more = true;
    while (more) {
      int64_t c = x & 0x1F;
      x >>= 5;  // arithmetic shift: negative x converges to -1
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      if (m >= cap) return -1;
      out[m++] = (char)(c + 48);
    }
  }
  return m;
}

// Expand counts (alternating background/foreground runs in column-major
// order) into a row-major (h, w) uint8 mask.  Runs past h*w are clipped;
// a short run list leaves the tail zero (matches masks.py rle_decode).
void rle_expand(const int64_t* counts, int64_t n, int64_t h, int64_t w,
                uint8_t* out) {
  std::memset(out, 0, (size_t)(h * w));
  if (h <= 0 || w <= 0) return;
  int64_t pos = 0;  // column-major flat index
  const int64_t total = h * w;
  for (int64_t i = 0; i < n && pos < total; ++i) {
    int64_t run = counts[i];
    if (run > total - pos) run = total - pos;
    if (i & 1) {  // foreground run: walk (row, col) without div/mod
      int64_t row = pos % h, col = pos / h;
      for (int64_t j = 0; j < run; ++j) {
        out[row * w + col] = 1;
        if (++row == h) {
          row = 0;
          ++col;
        }
      }
    }
    pos += run;
  }
}

// Row-major (h, w) uint8 mask -> column-major run counts (leading
// background run, possibly 0).  Returns the number of counts, or -1 if
// `cap` is too small.  `cap = h * w + 1` always suffices.
int64_t rle_from_mask(const uint8_t* mask, int64_t h, int64_t w,
                      int64_t* out, int64_t cap) {
  int64_t n = 0;
  uint8_t cur = 0;
  int64_t run = 0;
  const int64_t total = h * w;
  for (int64_t col = 0; col < w; ++col) {
    const uint8_t* p = mask + col;
    for (int64_t row = 0; row < h; ++row, p += w) {
      uint8_t v = *p ? 1 : 0;
      if (v != cur) {
        if (n >= cap) return -1;
        out[n++] = run;
        cur = v;
        run = 0;
      }
      ++run;
    }
  }
  if (total > 0) {
    if (n >= cap) return -1;
    out[n++] = run;
  }
  return n;
}

namespace {

// Rasterize one polygon (flat [x0,y0,x1,y1,...]) into column-major run
// counts via the COCO convention: upsample coordinates x5 with rounding,
// walk every lattice point of every edge, find the column-boundary
// crossings, downsample them, and fill by crossing parity in column-major
// order.  (This is the rasterization rule the COCO API defines; pixels on
// the outline are included.)
void poly_to_counts(const double* xy, int64_t npts, int64_t h, int64_t w,
                    std::vector<int64_t>* counts) {
  counts->clear();
  if (npts < 3) {  // degenerate: empty mask (one background run)
    counts->push_back(h * w);
    return;
  }
  const double scale = 5.0;
  const int64_t k = npts;
  std::vector<int64_t> x(k + 1), y(k + 1);
  for (int64_t j = 0; j < k; ++j) {
    x[j] = (int64_t)std::floor(scale * xy[2 * j + 0] + 0.5);
    y[j] = (int64_t)std::floor(scale * xy[2 * j + 1] + 0.5);
  }
  x[k] = x[0];
  y[k] = y[0];

  // every lattice point along every (upsampled) edge, in edge order
  std::vector<int64_t> u, v;
  {
    int64_t m = 0;
    for (int64_t j = 0; j < k; ++j)
      m += std::max(std::llabs(x[j] - x[j + 1]), std::llabs(y[j] - y[j + 1])) + 1;
    u.reserve(m);
    v.reserve(m);
  }
  for (int64_t j = 0; j < k; ++j) {
    int64_t xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
    int64_t dx = std::llabs(xe - xs), dy = std::llabs(ye - ys);
    bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
    if (flip) {
      std::swap(xs, xe);
      std::swap(ys, ye);
    }
    if (dx >= dy) {
      double s = dx == 0 ? 0.0 : (double)(ye - ys) / (double)dx;
      for (int64_t d = 0; d <= dx; ++d) {
        int64_t t = flip ? dx - d : d;
        u.push_back(t + xs);
        v.push_back((int64_t)std::floor(ys + s * (double)t + 0.5));
      }
    } else {
      double s = dy == 0 ? 0.0 : (double)(xe - xs) / (double)dy;
      for (int64_t d = 0; d <= dy; ++d) {
        int64_t t = flip ? dy - d : d;
        v.push_back(t + ys);
        u.push_back((int64_t)std::floor(xs + s * (double)t + 0.5));
      }
    }
  }

  // column-boundary crossings, downsampled to pixel resolution
  std::vector<int64_t> cx, cy;
  for (size_t j = 1; j < u.size(); ++j) {
    if (u[j] == u[j - 1]) continue;
    double xd = (double)(u[j] < u[j - 1] ? u[j] : u[j] - 1);
    xd = (xd + 0.5) / scale - 0.5;
    if (std::floor(xd) != xd || xd < 0 || xd > (double)(w - 1)) continue;
    double yd = (double)(v[j] < v[j - 1] ? v[j] : v[j - 1]);
    yd = (yd + 0.5) / scale - 0.5;
    if (yd < 0) yd = 0;
    if (yd > (double)h) yd = (double)h;
    yd = std::ceil(yd);
    cx.push_back((int64_t)xd);
    cy.push_back((int64_t)yd);
  }

  // crossings -> run counts by parity, in column-major flat order
  std::vector<int64_t> a(cx.size() + 1);
  for (size_t j = 0; j < cx.size(); ++j) a[j] = cx[j] * h + cy[j];
  a[cx.size()] = h * w;
  std::sort(a.begin(), a.end());
  int64_t prev = 0;
  for (size_t j = 0; j < a.size(); ++j) {
    int64_t t = a[j];
    a[j] -= prev;
    prev = t;
  }
  // zero-length runs mean two crossings coincide: the parity flips cancel,
  // so the NEXT run extends the PREVIOUS one instead of starting a new one
  counts->push_back(a[0]);
  size_t j = 1;
  while (j < a.size()) {
    if (a[j] > 0) {
      counts->push_back(a[j]);
      ++j;
    } else {
      ++j;
      if (j < a.size()) {
        counts->back() += a[j];
        ++j;
      }
    }
  }
}

}  // namespace

// Union of rasterized polygons -> row-major (h, w) uint8 mask.  `xy` holds
// all polygons' flat coords back to back; `poly_lens[i]` is the number of
// points (not doubles) of polygon i.  Polygons with <3 points are skipped
// (matches the PIL fallback in masks.py).
void polys_to_mask(const double* xy, const int64_t* poly_lens,
                   int64_t n_polys, int64_t h, int64_t w, uint8_t* out) {
  std::memset(out, 0, (size_t)(h * w));
  if (h <= 0 || w <= 0) return;
  std::vector<int64_t> counts;
  std::vector<uint8_t> tmp((size_t)(h * w));
  const double* p = xy;
  for (int64_t i = 0; i < n_polys; ++i) {
    int64_t npts = poly_lens[i];
    if (npts >= 3) {
      poly_to_counts(p, npts, h, w, &counts);
      rle_expand(counts.data(), (int64_t)counts.size(), h, w, tmp.data());
      for (int64_t j = 0; j < h * w; ++j) out[j] |= tmp[j];
    }
    p += 2 * npts;
  }
}

}  // extern "C"
