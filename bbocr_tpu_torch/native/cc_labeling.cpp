// Connected-component labeling with per-component statistics.
//
// Native replacement for the contour/labeling steps the reference delegates
// to OpenCV C++ (cv2.findContours / boundingRect in
// pipeline_demo/extractor/enhanced_extractor.py:282-297, and the
// connectedComponents pass EasyOCR's CRAFT postprocessing performs inside
// libtorch/cv2). Score maps are produced on the device; this host step is tiny
// compared to the conv nets (SURVEY.md §7 "Hard parts") but sits on the
// latency path, so it is C++ rather than Python.
//
// Two-pass union-find labeling, 4- or 8-connectivity.
// Per component (1-based labels; 0 = background), emits 11 doubles:
//   [x0, y0, x1, y1, count, sx, sy, sxx, syy, sxy, max_score]
// where (x1, y1) are inclusive, count is the pixel population, s* are raw
// moment sums for centroid/PCA-based rotated boxes, and max_score is the
// max of the optional float32 score image over the component (0 if null).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  }
};

}  // namespace

extern "C" {

// Returns the number of components (capped at max_comps).
// labels_out: int32[h*w], 0 background, 1..n component ids.
// stats_out: double[max_comps * 11].
int32_t bbocr_label_components(const uint8_t* mask, const float* score,
                               int32_t h, int32_t w, int32_t connectivity,
                               int32_t* labels_out, double* stats_out,
                               int32_t max_comps) {
  const int64_t n = static_cast<int64_t>(h) * w;
  std::vector<int32_t> raw(n, 0);
  // Provisional labels, 1-based; union-find over provisional ids.
  UnionFind uf(1);
  uf.parent.reserve(1 << 16);
  int32_t next = 1;
  const bool diag = connectivity == 8;

  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* row = mask + static_cast<int64_t>(y) * w;
    int32_t* lrow = raw.data() + static_cast<int64_t>(y) * w;
    const int32_t* lup = y > 0 ? raw.data() + static_cast<int64_t>(y - 1) * w : nullptr;
    for (int32_t x = 0; x < w; ++x) {
      if (!row[x]) continue;
      int32_t label = 0;
      const int32_t left = x > 0 ? lrow[x - 1] : 0;
      const int32_t up = lup ? lup[x] : 0;
      const int32_t upleft = (diag && lup && x > 0) ? lup[x - 1] : 0;
      const int32_t upright = (diag && lup && x + 1 < w) ? lup[x + 1] : 0;
      for (int32_t nb : {left, up, upleft, upright}) {
        if (!nb) continue;
        if (!label) {
          label = nb;
        } else if (nb != label) {
          uf.unite(label, nb);
        }
      }
      if (!label) {
        label = next++;
        uf.parent.push_back(label);
      }
      lrow[x] = label;
    }
  }

  // Resolve roots -> compact 1-based ids.
  std::vector<int32_t> remap(next, 0);
  int32_t n_comp = 0;
  for (int32_t i = 1; i < next; ++i) {
    const int32_t root = uf.find(i);
    if (!remap[root]) {
      if (n_comp >= max_comps) { remap[root] = -1; continue; }
      remap[root] = ++n_comp;
    }
  }

  // Init stats.
  for (int32_t c = 0; c < n_comp; ++c) {
    double* s = stats_out + static_cast<int64_t>(c) * 11;
    s[0] = w; s[1] = h; s[2] = -1; s[3] = -1;
    for (int k = 4; k < 11; ++k) s[k] = 0.0;
  }

  for (int32_t y = 0; y < h; ++y) {
    int32_t* lrow = raw.data() + static_cast<int64_t>(y) * w;
    const float* srow = score ? score + static_cast<int64_t>(y) * w : nullptr;
    for (int32_t x = 0; x < w; ++x) {
      if (!lrow[x]) { labels_out[static_cast<int64_t>(y) * w + x] = 0; continue; }
      int32_t id = remap[uf.find(lrow[x])];
      if (id <= 0) { labels_out[static_cast<int64_t>(y) * w + x] = 0; continue; }
      labels_out[static_cast<int64_t>(y) * w + x] = id;
      double* s = stats_out + static_cast<int64_t>(id - 1) * 11;
      if (x < s[0]) s[0] = x;
      if (y < s[1]) s[1] = y;
      if (x > s[2]) s[2] = x;
      if (y > s[3]) s[3] = y;
      s[4] += 1.0;
      s[5] += x;
      s[6] += y;
      s[7] += static_cast<double>(x) * x;
      s[8] += static_cast<double>(y) * y;
      s[9] += static_cast<double>(x) * y;
      if (srow && srow[x] > s[10]) s[10] = srow[x];
    }
  }
  return n_comp;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full CRAFT detection postprocessing: score maps -> word quads.
//
// Native equivalent of decode/boxes.py::extract_boxes (itself the
// behavioral match of EasyOCR's CRAFT getDetBoxes, SURVEY.md §2.3): threshold
// region/affinity, label components, filter by population and peak region
// score, min-area rectangle via convex hull + rotating calipers, near-square
// axis-aligned fallback, dilation-margin growth, clockwise corner order.
// One call replaces the labeling + per-component numpy geometry loop.
// ---------------------------------------------------------------------------

namespace {

struct Pt {
  double x, y;
};

inline double cross3(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Monotone-chain hull over unique, lex-sorted points (matches np.unique +
// lexsort order in the Python implementation).
std::vector<Pt> convex_hull(std::vector<Pt> pts) {
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x != b.x ? a.x < b.x : a.y < b.y;
  });
  pts.erase(std::unique(pts.begin(), pts.end(),
                        [](const Pt& a, const Pt& b) {
                          return a.x == b.x && a.y == b.y;
                        }),
            pts.end());
  const size_t n = pts.size();
  if (n <= 2) return pts;
  std::vector<Pt> out;
  out.reserve(2 * n);
  auto half = [&out](const Pt* seq, size_t count, int step) {
    const size_t base = out.size();
    for (size_t k = 0; k < count; ++k) {
      const Pt& p = step > 0 ? seq[k] : seq[count - 1 - k];
      while (out.size() - base >= 2 &&
             cross3(out[out.size() - 2], out.back(), p) <= 0.0) {
        out.pop_back();
      }
      out.push_back(p);
    }
    out.pop_back();  // drop the closing point (lower[:-1] / upper[:-1])
  };
  half(pts.data(), n, +1);
  half(pts.data(), n, -1);
  return out;
}

// Min-area rectangle corners (4) via rotating calipers over edge angles,
// replicating the numpy reference exactly (angles mod pi/2, sorted unique,
// first strictly-smaller area wins).
void min_area_rect(const std::vector<Pt>& points, Pt rect[4]) {
  std::vector<Pt> hull = convex_hull(points);
  if (hull.size() == 1) {
    for (int i = 0; i < 4; ++i) rect[i] = hull[0];
    return;
  }
  if (hull.size() == 2) {
    rect[0] = hull[0];
    rect[1] = hull[1];
    rect[2] = hull[1];
    rect[3] = hull[0];
    return;
  }
  const double half_pi = M_PI / 2.0;
  std::vector<double> angles;
  angles.reserve(hull.size());
  for (size_t i = 0; i < hull.size(); ++i) {
    const Pt& a = hull[i];
    const Pt& b = hull[(i + 1) % hull.size()];
    double ang = std::fmod(std::atan2(b.y - a.y, b.x - a.x), half_pi);
    if (ang < 0) ang += half_pi;
    angles.push_back(ang);
  }
  std::sort(angles.begin(), angles.end());
  angles.erase(std::unique(angles.begin(), angles.end()), angles.end());

  double best_area = -1.0, best_ang = 0.0;
  double best_min[2] = {0, 0}, best_max[2] = {0, 0};
  for (double ang : angles) {
    const double c = std::cos(ang), s = std::sin(ang);
    double mn[2] = {1e300, 1e300}, mx[2] = {-1e300, -1e300};
    for (const Pt& p : hull) {
      // proj = hull @ [[c, s], [-s, c]]^T
      const double u = p.x * c + p.y * s;
      const double v = -p.x * s + p.y * c;
      mn[0] = std::min(mn[0], u);
      mn[1] = std::min(mn[1], v);
      mx[0] = std::max(mx[0], u);
      mx[1] = std::max(mx[1], v);
    }
    const double area = (mx[0] - mn[0]) * (mx[1] - mn[1]);
    if (best_area < 0 || area < best_area) {
      best_area = area;
      best_ang = ang;
      best_min[0] = mn[0]; best_min[1] = mn[1];
      best_max[0] = mx[0]; best_max[1] = mx[1];
    }
  }
  const double c = std::cos(best_ang), s = std::sin(best_ang);
  const double corners[4][2] = {
      {best_min[0], best_min[1]},
      {best_max[0], best_min[1]},
      {best_max[0], best_max[1]},
      {best_min[0], best_max[1]},
  };
  for (int i = 0; i < 4; ++i) {
    // corners @ [[c, s], [-s, c]]
    rect[i].x = corners[i][0] * c - corners[i][1] * s;
    rect[i].y = corners[i][0] * s + corners[i][1] * c;
  }
}

inline double norm2(double x, double y) { return std::sqrt(x * x + y * y); }

}  // namespace

extern "C" {
int32_t bbocr_label_components(const uint8_t*, const float*, int32_t, int32_t,
                               int32_t, int32_t*, double*, int32_t);
}

namespace {

// Shared postprocessing core over a prebuilt mask + float score map
// (score values and text_threshold just need a consistent scale).
int32_t extract_quads_core(const uint8_t* mask, const float* score, int32_t h,
                           int32_t w, float text_threshold, int32_t min_size,
                           double* quads_out, int32_t max_quads) {
  const int64_t n = static_cast<int64_t>(h) * w;
  std::vector<int32_t> labels(n);
  const int32_t max_comps = 65536;
  std::vector<double> stats(static_cast<int64_t>(max_comps) * 11);
  const int32_t n_comp =
      bbocr_label_components(mask, score, h, w, /*connectivity=*/4,
                             labels.data(), stats.data(), max_comps);
  if (n_comp == 0) return 0;

  // Bucket pixel coordinates by component id (counting sort).
  std::vector<int64_t> offsets(n_comp + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] > 0) ++offsets[labels[i]];
  }
  for (int32_t c = 0; c < n_comp; ++c) offsets[c + 1] += offsets[c];
  std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
  std::vector<Pt> pix(offsets[n_comp]);
  for (int32_t y = 0; y < h; ++y) {
    const int32_t* lrow = labels.data() + static_cast<int64_t>(y) * w;
    for (int32_t x = 0; x < w; ++x) {
      const int32_t id = lrow[x];
      if (id > 0) {
        pix[cursor[id - 1]++] = Pt{static_cast<double>(x), static_cast<double>(y)};
      }
    }
  }

  int32_t n_out = 0;
  for (int32_t idx = 0; idx < n_comp && n_out < max_quads; ++idx) {
    const double* s = stats.data() + static_cast<int64_t>(idx) * 11;
    const double count = s[4];
    if (count < min_size) continue;
    if (s[10] < text_threshold) continue;

    const std::vector<Pt> pts(pix.begin() + offsets[idx],
                              pix.begin() + offsets[idx + 1]);
    const double bw = s[2] - s[0] + 1.0, bh = s[3] - s[1] + 1.0;
    const int32_t niter = static_cast<int32_t>(
        std::sqrt(count * std::min(bw, bh) / (bw * bh)) * 2.0);

    Pt rect[4];
    min_area_rect(pts, rect);
    double cx = (rect[0].x + rect[1].x + rect[2].x + rect[3].x) / 4.0;
    double cy = (rect[0].y + rect[1].y + rect[2].y + rect[3].y) / 4.0;
    const double side1 = norm2(rect[1].x - rect[0].x, rect[1].y - rect[0].y);
    const double side2 = norm2(rect[2].x - rect[1].x, rect[2].y - rect[1].y);
    if (std::min(side1, side2) > 0) {
      const double ratio =
          std::max(side1, side2) / (std::min(side1, side2) + 1e-5);
      if (std::fabs(1.0 - ratio) <= 0.1) {
        // Near-square: fall back to the axis-aligned bbox of the pixels.
        rect[0] = Pt{s[0], s[1]};
        rect[1] = Pt{s[2], s[1]};
        rect[2] = Pt{s[2], s[3]};
        rect[3] = Pt{s[0], s[3]};
        cx = (s[0] + s[2]) / 2.0;
        cy = (s[1] + s[3]) / 2.0;
      }
    }
    const double grow = (niter + 1.0) * std::sqrt(2.0);
    Pt grown[4];
    for (int i = 0; i < 4; ++i) {
      const double dx = rect[i].x - cx, dy = rect[i].y - cy;
      const double nrm = std::max(norm2(dx, dy), 1e-6);
      grown[i] = Pt{rect[i].x + dx / nrm * grow, rect[i].y + dy / nrm * grow};
    }
    // Clockwise order starting at the top-left (min x+y) corner.
    int start = 0;
    double best_sum = grown[0].x + grown[0].y;
    for (int i = 1; i < 4; ++i) {
      const double sum = grown[i].x + grown[i].y;
      if (sum < best_sum) {
        best_sum = sum;
        start = i;
      }
    }
    Pt rolled[4];
    for (int i = 0; i < 4; ++i) rolled[i] = grown[(start + i) % 4];
    if (cross3(rolled[0], rolled[1], rolled[2]) < 0) {
      Pt tmp = rolled[1];
      rolled[1] = rolled[3];
      rolled[3] = tmp;
    }
    double* q = quads_out + static_cast<int64_t>(n_out) * 8;
    for (int i = 0; i < 4; ++i) {
      q[2 * i] = rolled[i].x;
      q[2 * i + 1] = rolled[i].y;
    }
    ++n_out;
  }
  return n_out;
}

}  // namespace

extern "C" {

// region/affinity: float32[h*w] score maps straight off the device.
// quads_out: double[max_quads * 8] as (x0,y0,x1,y1,x2,y2,x3,y3) per quad,
// top-left first, clockwise. Returns the number of quads written.
int32_t bbocr_extract_quads(const float* region, const float* affinity,
                            int32_t h, int32_t w, float text_threshold,
                            float link_threshold, float low_text,
                            int32_t min_size, double* quads_out,
                            int32_t max_quads) {
  const int64_t n = static_cast<int64_t>(h) * w;
  std::vector<uint8_t> mask(n);
  for (int64_t i = 0; i < n; ++i) {
    mask[i] = (region[i] > low_text) || (affinity[i] > link_threshold) ? 1 : 0;
  }
  return extract_quads_core(mask.data(), region, h, w, text_threshold,
                            min_size, quads_out, max_quads);
}

// Variant for device-thresholded detection: the mask is computed on the device
// inside the detect program and the region score arrives uint8-quantized
// (round(score * 255)), so the host downloads 2x u8 planes instead of 2x f32
// maps. text_threshold_255 is the CRAFT text threshold pre-scaled by 255.
int32_t bbocr_extract_quads_masked(const uint8_t* mask,
                                   const uint8_t* score_u8, int32_t h,
                                   int32_t w, float text_threshold_255,
                                   int32_t min_size, double* quads_out,
                                   int32_t max_quads) {
  const int64_t n = static_cast<int64_t>(h) * w;
  std::vector<float> score(n);
  for (int64_t i = 0; i < n; ++i) score[i] = static_cast<float>(score_u8[i]);
  return extract_quads_core(mask, score.data(), h, w, text_threshold_255,
                            min_size, quads_out, max_quads);
}

}  // extern "C"
