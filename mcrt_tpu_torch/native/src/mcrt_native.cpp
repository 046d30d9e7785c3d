// mcrt_tpu_torch native runtime: host-side hot paths in C++.
//
// The reference is a 100% C++ renderer; here the device owns the per-ray
// compute, while the host-side build pipeline — BVH
// construction over millions of primitive AABBs and OBJ mesh parsing — stays
// native for the same reason the reference's is: it's pointer-heavy, branchy,
// serial-recursive work that Python/numpy does 50-100x slower.
//
// Components (capability parity, new implementation):
//   * Binned-SAH / quaternary / centroid-octant BVH builders producing the
//     flat DFS skip-link layout from which the cluster tables are built
//     (reference builders: source/bvh/bvh.cpp:131-426; our layout replaces its
//     LinearNode+priority-queue scheme with skip links, see accel/bvh_build.py).
//   * Wavefront OBJ parser (reference: source/scene/scene.cpp:238-323).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). Opaque handles
// carry variable-size results; callers query sizes then export into
// numpy-owned buffers.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline double half_area(const Vec3& mn, const Vec3& mx) {
  double ex = mx.x - mn.x, ey = mx.y - mn.y, ez = mx.z - mn.z;
  return ex * ey + ey * ez + ex * ez;  // proportional to surface area
}

struct BuildNode {
  Vec3 bb_min, bb_max;
  int32_t first = -1;   // leaf: offset into prim_order
  int32_t count = 0;    // leaf primitive count; 0 => internal
  std::vector<int32_t> children;
};

struct BVHHandle {
  std::vector<BuildNode> nodes;       // tree in build order, root = 0
  std::vector<int32_t> prim_order;    // leaf primitives, contiguous per leaf
  // flattened (filled by flatten()):
  std::vector<float> bb_min, bb_max;
  std::vector<int32_t> first, count, skip;
  int32_t max_leaf = 0;
};

struct Builder {
  const double* tri_min;
  const double* tri_max;
  std::vector<Vec3> centers;
  int bins;
  int max_leaf;
  bool strict_leaf;
  int force_leaf_limit;
  BVHHandle* out;

  Vec3 mn(int32_t i) const { return {tri_min[3 * i], tri_min[3 * i + 1], tri_min[3 * i + 2]}; }
  Vec3 mx(int32_t i) const { return {tri_max[3 * i], tri_max[3 * i + 1], tri_max[3 * i + 2]}; }

  void bounds(const int32_t* ids, int64_t n, Vec3* bmn, Vec3* bmx) const {
    Vec3 a = mn(ids[0]), b = mx(ids[0]);
    for (int64_t i = 1; i < n; ++i) {
      a = vmin(a, mn(ids[i]));
      b = vmax(b, mx(ids[i]));
    }
    *bmn = a;
    *bmx = b;
  }

  // Binned SAH on the largest-centroid-extent axis. Returns the split point
  // (stable partition of ids in place) or -1 for "make a leaf".
  // Cost model matches the reference (bvh.cpp:165-288) and accel/bvh_build.py:
  // leaf = N, split = 1 + sum(A_i * N_i) / A_parent.
  int64_t sah_split(int32_t* ids, int64_t n, const Vec3& bmn, const Vec3& bmx) {
    Vec3 cmn = centers[ids[0]], cmx = centers[ids[0]];
    for (int64_t i = 1; i < n; ++i) {
      cmn = vmin(cmn, centers[ids[i]]);
      cmx = vmax(cmx, centers[ids[i]]);
    }
    double ext[3] = {cmx.x - cmn.x, cmx.y - cmn.y, cmx.z - cmn.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 0.0) return -1;
    double area_whole = half_area(bmn, bmx);
    if (area_whole <= 0.0) return -1;

    const double lo = axis == 0 ? cmn.x : (axis == 1 ? cmn.y : cmn.z);
    const double inv = bins / ext[axis];

    // Bin primitives.
    std::vector<int32_t> bin_n(bins, 0);
    std::vector<Vec3> bin_mn(bins, {DBL_MAX, DBL_MAX, DBL_MAX});
    std::vector<Vec3> bin_mx(bins, {-DBL_MAX, -DBL_MAX, -DBL_MAX});
    std::vector<int8_t> bin_of(n);
    for (int64_t i = 0; i < n; ++i) {
      const Vec3& c = centers[ids[i]];
      double v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
      int b = (int)((v - lo) * inv);
      if (b >= bins) b = bins - 1;
      if (b < 0) b = 0;
      bin_of[i] = (int8_t)b;
      bin_n[b]++;
      bin_mn[b] = vmin(bin_mn[b], mn(ids[i]));
      bin_mx[b] = vmax(bin_mx[b], mx(ids[i]));
    }

    // Suffix sweep for right-side bounds, prefix for left.
    std::vector<double> right_area(bins + 1, 0.0);
    std::vector<int64_t> right_n(bins + 1, 0);
    {
      Vec3 rmn = {DBL_MAX, DBL_MAX, DBL_MAX}, rmx = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
      int64_t cnt = 0;
      for (int b = bins - 1; b >= 1; --b) {
        if (bin_n[b]) {
          rmn = vmin(rmn, bin_mn[b]);
          rmx = vmax(rmx, bin_mx[b]);
          cnt += bin_n[b];
        }
        right_n[b] = cnt;
        right_area[b] = cnt ? half_area(rmn, rmx) : 0.0;
      }
    }
    double best_cost = (double)n;  // leaf cost
    int best_b = -1;
    {
      Vec3 lmn = {DBL_MAX, DBL_MAX, DBL_MAX}, lmx = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
      int64_t cnt = 0;
      for (int b = 1; b < bins; ++b) {
        if (bin_n[b - 1]) {
          lmn = vmin(lmn, bin_mn[b - 1]);
          lmx = vmax(lmx, bin_mx[b - 1]);
          cnt += bin_n[b - 1];
        }
        if (cnt == 0 || right_n[b] == 0) continue;
        double cost =
            1.0 + (half_area(lmn, lmx) * cnt + right_area[b] * right_n[b]) / area_whole;
        if (cost < best_cost) {
          best_cost = cost;
          best_b = b;
        }
      }
    }
    if (best_b < 0) return -1;
    // Stable partition preserving relative order (matches numpy ids[mask]).
    std::vector<int32_t> l, r;
    l.reserve(n);
    r.reserve(n);
    for (int64_t i = 0; i < n; ++i)
      (bin_of[i] < best_b ? l : r).push_back(ids[i]);
    std::memcpy(ids, l.data(), l.size() * sizeof(int32_t));
    std::memcpy(ids + l.size(), r.data(), r.size() * sizeof(int32_t));
    return (int64_t)l.size();
  }

  int32_t make_leaf(const Vec3& bmn, const Vec3& bmx, const int32_t* ids, int64_t n) {
    BuildNode nd;
    nd.bb_min = bmn;
    nd.bb_max = bmx;
    nd.first = (int32_t)out->prim_order.size();
    nd.count = (int32_t)n;
    out->prim_order.insert(out->prim_order.end(), ids, ids + n);
    out->nodes.push_back(std::move(nd));
    return (int32_t)out->nodes.size() - 1;
  }

  int32_t build_sah(int32_t* ids, int64_t n) {
    Vec3 bmn, bmx;
    bounds(ids, n, &bmn, &bmx);
    if (n <= max_leaf) return make_leaf(bmn, bmx, ids, n);
    int64_t split = sah_split(ids, n, bmn, bmx);
    if (split < 0) {
      int64_t limit = strict_leaf ? max_leaf : force_leaf_limit;
      if (n > limit) {
        split = n / 2;  // arbitrary split (reference arbitrarySplit, bvh.cpp:451-473)
      } else {
        return make_leaf(bmn, bmx, ids, n);
      }
    }
    int32_t me;
    {
      BuildNode nd;
      nd.bb_min = bmn;
      nd.bb_max = bmx;
      out->nodes.push_back(std::move(nd));
      me = (int32_t)out->nodes.size() - 1;
    }
    int32_t l = build_sah(ids, split);
    int32_t r = build_sah(ids + split, n - split);
    out->nodes[me].children = {l, r};
    return me;
  }

  int32_t build_octant(int32_t* ids, int64_t n) {
    Vec3 bmn, bmx;
    bounds(ids, n, &bmn, &bmx);
    if (n <= max_leaf) return make_leaf(bmn, bmx, ids, n);
    Vec3 cmn = centers[ids[0]], cmx = centers[ids[0]];
    for (int64_t i = 1; i < n; ++i) {
      cmn = vmin(cmn, centers[ids[i]]);
      cmx = vmax(cmx, centers[ids[i]]);
    }
    Vec3 mid = {(cmn.x + cmx.x) * 0.5, (cmn.y + cmx.y) * 0.5, (cmn.z + cmx.z) * 0.5};
    std::vector<int32_t> part[8];
    for (int64_t i = 0; i < n; ++i) {
      const Vec3& c = centers[ids[i]];
      int o = (c.x >= mid.x) | ((c.y >= mid.y) << 1) | ((c.z >= mid.z) << 2);
      part[o].push_back(ids[i]);
    }
    int nonempty = 0;
    for (auto& p : part)
      if (!p.empty()) nonempty++;
    if (nonempty <= 1) {
      // Degenerate (coincident centroids): arbitrary half split.
      int64_t half = n / 2;
      if (half == 0) return make_leaf(bmn, bmx, ids, n);
      int32_t me;
      {
        BuildNode nd;
        nd.bb_min = bmn;
        nd.bb_max = bmx;
        out->nodes.push_back(std::move(nd));
        me = (int32_t)out->nodes.size() - 1;
      }
      int32_t l = build_octant(ids, half);
      int32_t r = build_octant(ids + half, n - half);
      out->nodes[me].children = {l, r};
      return me;
    }
    int32_t me;
    {
      BuildNode nd;
      nd.bb_min = bmn;
      nd.bb_max = bmx;
      out->nodes.push_back(std::move(nd));
      me = (int32_t)out->nodes.size() - 1;
    }
    std::vector<int32_t> kids;
    int64_t off = 0;
    for (auto& p : part) {
      if (p.empty()) continue;
      std::memcpy(ids + off, p.data(), p.size() * sizeof(int32_t));
      kids.push_back(build_octant(ids + off, (int64_t)p.size()));
      off += (int64_t)p.size();
    }
    out->nodes[me].children = std::move(kids);
    return me;
  }
};

// Collapse binary tree two levels at a time -> up to 4 children (quaternary).
void collapse_quaternary(BVHHandle* h, int32_t node) {
  BuildNode& nd = h->nodes[node];
  if (nd.count > 0) return;
  std::vector<int32_t> grand;
  for (int32_t c : nd.children) {
    if (h->nodes[c].count > 0) {
      grand.push_back(c);
    } else {
      for (int32_t g : h->nodes[c].children) grand.push_back(g);
    }
  }
  nd.children = std::move(grand);
  for (int32_t c : h->nodes[node].children) collapse_quaternary(h, c);
}

// DFS flatten with skip links: child k's skip = child k+1; last child inherits
// the parent's skip (accel/bvh_build.py _flatten).
void flatten(BVHHandle* h) {
  int64_t total = 0;
  // Count reachable nodes (quaternary collapse orphans intermediate nodes).
  {
    std::vector<int32_t> stack = {0};
    while (!stack.empty()) {
      int32_t i = stack.back();
      stack.pop_back();
      total++;
      for (int32_t c : h->nodes[i].children) stack.push_back(c);
    }
  }
  h->bb_min.resize(total * 3);
  h->bb_max.resize(total * 3);
  h->first.assign(total, 0);
  h->count.assign(total, 0);
  h->skip.assign(total, (int32_t)total);

  struct Item {
    int32_t node;
    int32_t skip_to;
  };
  // Emit DFS order: process a node, then push children so the first child pops
  // next and lands at index cur+1.
  std::vector<Item> stack;
  stack.push_back({0, (int32_t)total});
  int32_t cur = 0;
  int32_t max_leaf = 0;
  // Pre-compute DFS indices so skip links (which point forward) are known:
  // child k's flat index = parent's index + 1 + subtree sizes of children <k.
  std::vector<int64_t> subtree(h->nodes.size(), 0);
  {
    // Post-order subtree sizes via explicit two-phase stack.
    std::vector<std::pair<int32_t, bool>> st = {{0, false}};
    while (!st.empty()) {
      auto [i, done] = st.back();
      st.pop_back();
      if (done) {
        int64_t s = 1;
        for (int32_t c : h->nodes[i].children) s += subtree[c];
        subtree[i] = s;
      } else {
        st.push_back({i, true});
        for (int32_t c : h->nodes[i].children) st.push_back({c, false});
      }
    }
  }
  while (!stack.empty()) {
    auto [node, skip_to] = stack.back();
    stack.pop_back();
    BuildNode& nd = h->nodes[node];
    int32_t i = cur++;
    h->bb_min[3 * i] = (float)nd.bb_min.x;
    h->bb_min[3 * i + 1] = (float)nd.bb_min.y;
    h->bb_min[3 * i + 2] = (float)nd.bb_min.z;
    h->bb_max[3 * i] = (float)nd.bb_max.x;
    h->bb_max[3 * i + 1] = (float)nd.bb_max.y;
    h->bb_max[3 * i + 2] = (float)nd.bb_max.z;
    h->skip[i] = skip_to;
    if (nd.count > 0) {
      h->first[i] = nd.first;
      h->count[i] = nd.count;
      if (nd.count > max_leaf) max_leaf = nd.count;
    } else {
      // Children DFS indices follow contiguously by subtree size.
      int32_t base = i + 1;
      std::vector<int32_t> idx(nd.children.size());
      for (size_t k = 0; k < nd.children.size(); ++k) {
        idx[k] = base;
        base += (int32_t)subtree[nd.children[k]];
      }
      // Push in reverse so the first child pops first.
      for (size_t k = nd.children.size(); k-- > 0;) {
        int32_t next = (k + 1 < nd.children.size()) ? idx[k + 1] : skip_to;
        stack.push_back({nd.children[k], next});
      }
    }
  }
  h->max_leaf = max_leaf;
}

}  // namespace

extern "C" {

// kind: 0 = binary_sah, 1 = quaternary_sah, 2 = octree, 3 = median(octant alias)
void* mcrt_bvh_build(const double* tri_min, const double* tri_max, int64_t P,
                     int32_t bins, int32_t max_leaf, int32_t strict_leaf,
                     int32_t kind) {
  if (P <= 0) return nullptr;
  auto* h = new BVHHandle();
  h->nodes.reserve((size_t)(2.2 * P / std::max(1, max_leaf) + 16));
  h->prim_order.reserve(P);
  Builder b;
  b.tri_min = tri_min;
  b.tri_max = tri_max;
  b.centers.resize(P);
  for (int64_t i = 0; i < P; ++i) {
    b.centers[i] = {(tri_min[3 * i] + tri_max[3 * i]) * 0.5,
                    (tri_min[3 * i + 1] + tri_max[3 * i + 1]) * 0.5,
                    (tri_min[3 * i + 2] + tri_max[3 * i + 2]) * 0.5};
  }
  b.bins = bins;
  b.max_leaf = max_leaf;
  b.strict_leaf = strict_leaf != 0;
  b.force_leaf_limit = strict_leaf ? max_leaf : 255;
  b.out = h;
  std::vector<int32_t> ids(P);
  for (int64_t i = 0; i < P; ++i) ids[i] = (int32_t)i;

  // Children are appended after parents, so root is NOT index 0 in build
  // order for leaves-only trees; normalize by rebuilding with root-first
  // guarantee: build functions push parent before children, so root == 0
  // unless the whole tree is a single leaf (also index 0). OK.
  if (kind == 2 || kind == 3) {
    b.build_octant(ids.data(), P);
  } else {
    b.build_sah(ids.data(), P);
    if (kind == 1) collapse_quaternary(h, 0);
  }
  flatten(h);
  return h;
}

int64_t mcrt_bvh_num_nodes(void* handle) {
  return handle ? (int64_t)((BVHHandle*)handle)->first.size() : 0;
}
int64_t mcrt_bvh_num_prims(void* handle) {
  return handle ? (int64_t)((BVHHandle*)handle)->prim_order.size() : 0;
}
int32_t mcrt_bvh_max_leaf(void* handle) {
  return handle ? ((BVHHandle*)handle)->max_leaf : 0;
}
void mcrt_bvh_export(void* handle, float* bb_min, float* bb_max, int32_t* first,
                     int32_t* count, int32_t* skip, int32_t* prim_order) {
  auto* h = (BVHHandle*)handle;
  std::memcpy(bb_min, h->bb_min.data(), h->bb_min.size() * sizeof(float));
  std::memcpy(bb_max, h->bb_max.data(), h->bb_max.size() * sizeof(float));
  std::memcpy(first, h->first.data(), h->first.size() * sizeof(int32_t));
  std::memcpy(count, h->count.data(), h->count.size() * sizeof(int32_t));
  std::memcpy(skip, h->skip.data(), h->skip.size() * sizeof(int32_t));
  std::memcpy(prim_order, h->prim_order.data(),
              h->prim_order.size() * sizeof(int32_t));
}
void mcrt_bvh_free(void* handle) { delete (BVHHandle*)handle; }

// ---------------------------------------------------------------------------
// OBJ parser (reference scene.cpp:238-323 capability: v / vn / f, 1-based
// indices, v | v/vt | v//vn | v/vt/vn forms, triangles).

struct ObjHandle {
  std::vector<double> vertices;  // xyz triples
  std::vector<double> normals;
  std::vector<int64_t> tri_v;  // 3 per face
  std::vector<int64_t> tri_vn;
  bool has_vn_faces = true;
};

void* mcrt_obj_parse(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  size_t rd = std::fread(buf.data(), 1, size, f);
  std::fclose(f);
  buf[rd] = '\0';

  auto* h = new ObjHandle();
  char* p = buf.data();
  char* end = buf.data() + rd;
  while (p < end) {
    // Find line end.
    char* eol = (char*)memchr(p, '\n', end - p);
    if (!eol) eol = end;
    *eol = '\0';
    while (*p == ' ' || *p == '\t') ++p;
    if (p[0] == 'v' && p[1] == ' ') {
      char* q = p + 2;
      double x = strtod(q, &q), y = strtod(q, &q), z = strtod(q, &q);
      h->vertices.insert(h->vertices.end(), {x, y, z});
    } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') {
      char* q = p + 3;
      double x = strtod(q, &q), y = strtod(q, &q), z = strtod(q, &q);
      h->normals.insert(h->normals.end(), {x, y, z});
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      char* q = p + 2;
      int64_t fv[3], fn[3];
      int nv = 0, nn = 0;
      while (*q && nv < 3) {
        while (*q == ' ' || *q == '\t') ++q;
        if (!*q) break;
        char* r;
        long long vi = strtoll(q, &r, 10);
        if (r == q) break;
        q = r;
        fv[nv++] = vi - 1;
        if (*q == '/') {
          ++q;  // texcoord (skipped)
          if (*q != '/') strtoll(q, &q, 10);
          if (*q == '/') {
            ++q;
            long long ni = strtoll(q, &r, 10);
            if (r != q) {
              fn[nn++] = ni - 1;
              q = r;
            }
          }
        }
      }
      if (nv == 3) {
        h->tri_v.insert(h->tri_v.end(), {fv[0], fv[1], fv[2]});
        if (nn == 3) {
          h->tri_vn.insert(h->tri_vn.end(), {fn[0], fn[1], fn[2]});
        } else {
          h->has_vn_faces = false;
        }
      }
    }
    p = eol + 1;
  }
  if (!h->has_vn_faces || h->tri_vn.size() != h->tri_v.size()) h->tri_vn.clear();
  return h;
}

int64_t mcrt_obj_num_vertices(void* h) {
  return h ? (int64_t)((ObjHandle*)h)->vertices.size() / 3 : 0;
}
int64_t mcrt_obj_num_normals(void* h) {
  return h ? (int64_t)((ObjHandle*)h)->normals.size() / 3 : 0;
}
int64_t mcrt_obj_num_tris(void* h) {
  return h ? (int64_t)((ObjHandle*)h)->tri_v.size() / 3 : 0;
}
int32_t mcrt_obj_has_normal_indices(void* h) {
  return h && !((ObjHandle*)h)->tri_vn.empty() ? 1 : 0;
}
void mcrt_obj_export(void* handle, double* vertices, double* normals,
                     int64_t* tri_v, int64_t* tri_vn) {
  auto* h = (ObjHandle*)handle;
  std::memcpy(vertices, h->vertices.data(), h->vertices.size() * sizeof(double));
  std::memcpy(normals, h->normals.data(), h->normals.size() * sizeof(double));
  std::memcpy(tri_v, h->tri_v.data(), h->tri_v.size() * sizeof(int64_t));
  if (!h->tri_vn.empty() && tri_vn)
    std::memcpy(tri_vn, h->tri_vn.data(), h->tri_vn.size() * sizeof(int64_t));
}
void mcrt_obj_free(void* h) { delete (ObjHandle*)h; }

}  // extern "C"
