// Native BVH builder: SAH (12-bucket binned) / middle / equal / AAC.
//
// The host-side scene-build analog of reference accelerators/bvh.cpp
// (BVHAccel::recursiveBuild :406-557, buildAAC :258-389, flatten :559),
// re-implemented for the flattened-tensor layout pbrt_tpu's device
// traversal consumes:
//   node_lo/hi  float[n_nodes][3]
//   node_meta   int32[n_nodes][3]  (second_child|prim_offset, n_prims, axis)
//   order       int32[n_prims]     leaf-ordered primitive ids
// Exposed via a C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC bvh_builder.cpp -o libpbrt_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float surface_area(const V3 &lo, const V3 &hi) {
  float dx = std::max(0.f, hi.x - lo.x);
  float dy = std::max(0.f, hi.y - lo.y);
  float dz = std::max(0.f, hi.z - lo.z);
  return 2.f * (dx * dy + dx * dz + dy * dz);
}

constexpr int kLeafMax = 4;
constexpr int kBuckets = 12;

struct Builder {
  const float *lo;
  const float *hi;
  std::vector<V3> cent;
  std::vector<float> node_lo, node_hi;
  std::vector<int32_t> meta;
  std::vector<int32_t> order;
  int method;  // 0 sah, 1 middle, 2 equal

  V3 plo(int i) const { return {lo[3 * i], lo[3 * i + 1], lo[3 * i + 2]}; }
  V3 phi(int i) const { return {hi[3 * i], hi[3 * i + 1], hi[3 * i + 2]}; }

  int add_node() {
    node_lo.insert(node_lo.end(), {0, 0, 0});
    node_hi.insert(node_hi.end(), {0, 0, 0});
    meta.insert(meta.end(), {0, 0, 0});
    return (int)meta.size() / 3 - 1;
  }
  void set_bounds(int n, const V3 &l, const V3 &h) {
    node_lo[3 * n] = l.x; node_lo[3 * n + 1] = l.y; node_lo[3 * n + 2] = l.z;
    node_hi[3 * n] = h.x; node_hi[3 * n + 1] = h.y; node_hi[3 * n + 2] = h.z;
  }

  // Recursion replaced by an explicit work stack so scene size never
  // hits a stack limit.
  int build(std::vector<int> &ids) { return recurse(ids.data(), (int)ids.size()); }

  int recurse(int *ids, int n) {
    int node = add_node();
    V3 nlo = plo(ids[0]), nhi = phi(ids[0]);
    for (int k = 1; k < n; ++k) {
      nlo = vmin(nlo, plo(ids[k]));
      nhi = vmax(nhi, phi(ids[k]));
    }
    set_bounds(node, nlo, nhi);
    if (n <= kLeafMax) {
      meta[3 * node] = (int32_t)order.size();
      meta[3 * node + 1] = n;
      order.insert(order.end(), ids, ids + n);
      return node;
    }
    V3 clo = cent[ids[0]], chi = cent[ids[0]];
    for (int k = 1; k < n; ++k) {
      clo = vmin(clo, cent[ids[k]]);
      chi = vmax(chi, cent[ids[k]]);
    }
    float ext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
    int axis = ext[1] > ext[0] ? (ext[2] > ext[1] ? 2 : 1) : (ext[2] > ext[0] ? 2 : 0);
    auto cgET = [&](int i) {
      return axis == 0 ? cent[i].x : (axis == 1 ? cent[i].y : cent[i].z);
    };
    if (ext[axis] < 1e-12f) {
      meta[3 * node] = (int32_t)order.size();
      meta[3 * node + 1] = n;
      order.insert(order.end(), ids, ids + n);
      return node;
    }
    int mid = n / 2;
    if (method == 1) {  // middle
      float pivot = 0.5f * ((axis == 0 ? clo.x : axis == 1 ? clo.y : clo.z) +
                            (axis == 0 ? chi.x : axis == 1 ? chi.y : chi.z));
      int *p = std::partition(ids, ids + n,
                              [&](int i) { return cgET(i) < pivot; });
      mid = (int)(p - ids);
      if (mid == 0 || mid == n) {
        mid = n / 2;
        std::nth_element(ids, ids + mid, ids + n,
                         [&](int a, int b) { return cgET(a) < cgET(b); });
      }
    } else if (method == 2) {  // equal counts
      std::nth_element(ids, ids + mid, ids + n,
                       [&](int a, int b) { return cgET(a) < cgET(b); });
    } else {  // sah
      struct Bucket { int count = 0; V3 lo{1e30f,1e30f,1e30f}, hi{-1e30f,-1e30f,-1e30f}; };
      Bucket b[kBuckets];
      float cmin = (axis == 0 ? clo.x : axis == 1 ? clo.y : clo.z);
      float inv = kBuckets / ext[axis];
      for (int k = 0; k < n; ++k) {
        int bi = std::min(kBuckets - 1, (int)((cgET(ids[k]) - cmin) * inv));
        b[bi].count++;
        b[bi].lo = vmin(b[bi].lo, plo(ids[k]));
        b[bi].hi = vmax(b[bi].hi, phi(ids[k]));
      }
      float best_cost = 1e30f;
      int best_split = -1;
      float total_sa = surface_area(nlo, nhi);
      for (int s = 0; s < kBuckets - 1; ++s) {
        V3 llo{1e30f,1e30f,1e30f}, lhi{-1e30f,-1e30f,-1e30f};
        V3 rlo = llo, rhi = lhi;
        int lc = 0, rc = 0;
        for (int k = 0; k <= s; ++k) {
          if (!b[k].count) continue;
          lc += b[k].count; llo = vmin(llo, b[k].lo); lhi = vmax(lhi, b[k].hi);
        }
        for (int k = s + 1; k < kBuckets; ++k) {
          if (!b[k].count) continue;
          rc += b[k].count; rlo = vmin(rlo, b[k].lo); rhi = vmax(rhi, b[k].hi);
        }
        if (!lc || !rc) continue;
        float cost = 0.125f + (lc * surface_area(llo, lhi) +
                               rc * surface_area(rlo, rhi)) / total_sa;
        if (cost < best_cost) { best_cost = cost; best_split = s; }
      }
      if (best_split < 0 || (n <= kLeafMax && best_cost >= n)) {
        meta[3 * node] = (int32_t)order.size();
        meta[3 * node + 1] = n;
        order.insert(order.end(), ids, ids + n);
        return node;
      }
      float pivot = cmin + (best_split + 1) * ext[axis] / kBuckets;
      int *p = std::partition(ids, ids + n,
                              [&](int i) { return cgET(i) < pivot; });
      mid = (int)(p - ids);
      if (mid == 0 || mid == n) {
        mid = n / 2;
        std::nth_element(ids, ids + mid, ids + n,
                         [&](int a, int b) { return cgET(a) < cgET(b); });
      }
    }
    recurse(ids, mid);
    int second = recurse(ids + mid, n - mid);
    meta[3 * node] = second;
    meta[3 * node + 1] = 0;
    meta[3 * node + 2] = axis;
    return node;
  }
};

// ---- AAC (reference bvh.cpp:258-389): morton sort + greedy merge ----

struct Cluster {
  V3 lo, hi;
  int node;  // emitted node index or -1 (raw primitive)
  int prim;
};

struct AacBuilder {
  const float *lo;
  const float *hi;
  std::vector<float> node_lo, node_hi;
  std::vector<int32_t> meta;     // explicit-children form during build
  std::vector<int32_t> order;
  std::vector<int> sorted;
  std::vector<uint64_t> codes;

  static constexpr int kDelta = 4;
  static int f(int x) {
    double c = 0.5 * std::pow((double)kDelta, 0.7);
    int v = (int)std::ceil(c * std::pow((double)x, 0.3));
    return v < 1 ? 1 : v;
  }

  V3 plo(int i) const { return {lo[3 * i], lo[3 * i + 1], lo[3 * i + 2]}; }
  V3 phi(int i) const { return {hi[3 * i], hi[3 * i + 1], hi[3 * i + 2]}; }

  int add_node() {
    node_lo.insert(node_lo.end(), {0, 0, 0});
    node_hi.insert(node_hi.end(), {0, 0, 0});
    meta.insert(meta.end(), {0, 0, 0});
    return (int)meta.size() / 3 - 1;
  }

  int emit_leaf(const Cluster &c) {
    int n = add_node();
    node_lo[3*n]=c.lo.x; node_lo[3*n+1]=c.lo.y; node_lo[3*n+2]=c.lo.z;
    node_hi[3*n]=c.hi.x; node_hi[3*n+1]=c.hi.y; node_hi[3*n+2]=c.hi.z;
    meta[3 * n] = (int32_t)order.size();
    meta[3 * n + 1] = 1;
    order.push_back(c.prim);
    return n;
  }

  void combine(std::vector<Cluster> &cl, int target) {
    while ((int)cl.size() > target) {
      float best = 1e30f;
      int bi = -1, bj = -1;
      for (size_t i = 0; i < cl.size(); ++i)
        for (size_t j = i + 1; j < cl.size(); ++j) {
          V3 ulo = vmin(cl[i].lo, cl[j].lo);
          V3 uhi = vmax(cl[i].hi, cl[j].hi);
          float sa = surface_area(ulo, uhi);
          if (sa < best) { best = sa; bi = (int)i; bj = (int)j; }
        }
      Cluster &a = cl[bi];
      Cluster &b = cl[bj];
      if (a.node < 0) a.node = emit_leaf(a);
      if (b.node < 0) b.node = emit_leaf(b);
      int n = add_node();
      V3 ulo = vmin(a.lo, b.lo);
      V3 uhi = vmax(a.hi, b.hi);
      node_lo[3*n]=ulo.x; node_lo[3*n+1]=ulo.y; node_lo[3*n+2]=ulo.z;
      node_hi[3*n]=uhi.x; node_hi[3*n+1]=uhi.y; node_hi[3*n+2]=uhi.z;
      meta[3 * n] = -a.node - 2;      // explicit children (negative coding)
      meta[3 * n + 1] = -b.node - 2;
      meta[3 * n + 2] = 0;
      cl[bi] = {ulo, uhi, n, -1};
      cl.erase(cl.begin() + bj);
    }
  }

  std::vector<Cluster> build_range(int s, int e, int bit) {
    if (e - s <= kDelta || bit < 0) {
      std::vector<Cluster> cl;
      for (int i = s; i < e; ++i)
        cl.push_back({plo(sorted[i]), phi(sorted[i]), -1, sorted[i]});
      combine(cl, f(e - s <= kDelta ? kDelta : e - s));
      return cl;
    }
    uint64_t mask = 1ull << bit;
    int split = s;
    // binary search for the bit boundary (codes sorted)
    {
      int a = s, b = e;
      while (a < b) {
        int m = (a + b) / 2;
        if (codes[m] & mask) b = m; else a = m + 1;
      }
      split = a;
    }
    if (split == s || split == e) return build_range(s, e, bit - 1);
    auto left = build_range(s, split, bit - 1);
    auto right = build_range(split, e, bit - 1);
    left.insert(left.end(), right.begin(), right.end());
    combine(left, f(e - s));
    return left;
  }
};

static uint64_t spread3(uint64_t x) {
  x = (x | (x << 16)) & 0x030000FFull;
  x = (x | (x << 8)) & 0x0300F00Full;
  x = (x | (x << 4)) & 0x030C30C3ull;
  x = (x | (x << 2)) & 0x09249249ull;
  return x;
}

}  // namespace

extern "C" {

// Returns node count, writes outputs; -1 if capacity exceeded.
int pbrt_build_bvh(const float *lo, const float *hi, int n, int method,
                   float *out_node_lo, float *out_node_hi,
                   int32_t *out_meta, int32_t *out_order, int max_nodes) {
  if (n <= 0) return 0;
  if (method == 3) {  // AAC
    AacBuilder b;
    b.lo = lo; b.hi = hi;
    b.sorted.resize(n);
    std::vector<uint64_t> raw(n);
    V3 wlo = b.plo(0), whi = b.phi(0);
    for (int i = 1; i < n; ++i) { wlo = vmin(wlo, b.plo(i)); whi = vmax(whi, b.phi(i)); }
    for (int i = 0; i < n; ++i) {
      V3 c = {0.5f * (lo[3*i] + hi[3*i]), 0.5f * (lo[3*i+1] + hi[3*i+1]),
              0.5f * (lo[3*i+2] + hi[3*i+2])};
      auto q = [&](float v, float l, float h) {
        float t = (h - l) > 1e-12f ? (v - l) / (h - l) : 0.f;
        uint64_t u = (uint64_t)std::min(1023.f, std::max(0.f, t * 1024.f));
        return u;
      };
      raw[i] = spread3(q(c.x, wlo.x, whi.x)) | (spread3(q(c.y, wlo.y, whi.y)) << 1)
               | (spread3(q(c.z, wlo.z, whi.z)) << 2);
      b.sorted[i] = i;
    }
    std::sort(b.sorted.begin(), b.sorted.end(),
              [&](int a, int c) { return raw[a] < raw[c]; });
    b.codes.resize(n);
    for (int i = 0; i < n; ++i) b.codes[i] = raw[b.sorted[i]];
    auto roots = b.build_range(0, n, 29);
    b.combine(roots, 1);
    if (roots[0].node < 0) roots[0].node = b.emit_leaf(roots[0]);
    // normalize explicit-children form to first-child-adjacent layout
    std::vector<float> nlo, nhi;
    std::vector<int32_t> nmeta;
    nlo.reserve(b.node_lo.size()); nhi.reserve(b.node_hi.size());
    nmeta.reserve(b.meta.size());
    // iterative DFS emit
    struct Frame { int src; int slot; };
    std::vector<int> remap(b.meta.size() / 3, -1);
    std::vector<int> stack{roots[0].node};
    // emission must be first-child adjacent: do recursive emit with
    // explicit stack of (node, phase)
    std::vector<std::pair<int,int>> st;
    std::vector<int> out_of; // src -> dst
    out_of.assign(b.meta.size() / 3, -1);
    std::function<int(int)> emit = [&](int src) -> int {
      int dst = (int)nmeta.size() / 3;
      for (int k = 0; k < 3; ++k) {
        nlo.push_back(b.node_lo[3 * src + k]);
        nhi.push_back(b.node_hi[3 * src + k]);
        nmeta.push_back(0);
      }
      int32_t m0 = b.meta[3 * src], m1 = b.meta[3 * src + 1];
      if (m0 <= -2) {
        emit(-m0 - 2);
        int second = emit(-m1 - 2);
        nmeta[3 * dst] = second;
        nmeta[3 * dst + 1] = 0;
        nmeta[3 * dst + 2] = 0;
      } else {
        nmeta[3 * dst] = m0;
        nmeta[3 * dst + 1] = m1;
        nmeta[3 * dst + 2] = b.meta[3 * src + 2];
      }
      return dst;
    };
    emit(roots[0].node);
    int n_nodes = (int)nmeta.size() / 3;
    if (n_nodes > max_nodes) return -1;
    std::memcpy(out_node_lo, nlo.data(), nlo.size() * sizeof(float));
    std::memcpy(out_node_hi, nhi.data(), nhi.size() * sizeof(float));
    std::memcpy(out_meta, nmeta.data(), nmeta.size() * sizeof(int32_t));
    std::memcpy(out_order, b.order.data(), b.order.size() * sizeof(int32_t));
    return n_nodes;
  }
  Builder b;
  b.lo = lo; b.hi = hi; b.method = method;
  b.cent.resize(n);
  for (int i = 0; i < n; ++i)
    b.cent[i] = {0.5f * (lo[3*i] + hi[3*i]), 0.5f * (lo[3*i+1] + hi[3*i+1]),
                 0.5f * (lo[3*i+2] + hi[3*i+2])};
  std::vector<int> ids(n);
  for (int i = 0; i < n; ++i) ids[i] = i;
  b.build(ids);
  int n_nodes = (int)b.meta.size() / 3;
  if (n_nodes > max_nodes) return -1;
  std::memcpy(out_node_lo, b.node_lo.data(), b.node_lo.size() * sizeof(float));
  std::memcpy(out_node_hi, b.node_hi.data(), b.node_hi.size() * sizeof(float));
  std::memcpy(out_meta, b.meta.data(), b.meta.size() * sizeof(int32_t));
  std::memcpy(out_order, b.order.data(), b.order.size() * sizeof(int32_t));
  return n_nodes;
}
}
