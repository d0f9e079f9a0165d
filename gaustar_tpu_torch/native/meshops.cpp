// Native mesh kernels of gaustar_tpu_torch (C ABI, loaded via ctypes), a copy
// of gaustar_tpu/native/meshops.cpp: the same source, built with the same
// flags, gives bit-equal results.
//
// Host replacement for the reference's native/external mesh dependencies:
//   - quadric edge-collapse decimation: pyfqmr (humanrf/trainer.py:746-749) and
//     o3d simplify_quadric_decimation (refined_mesh.py:458). Implements the
//     threshold-schedule variant of Garland-Heckbert (iterative passes with
//     err < 1e-9*(it+3)^agg). The quadric section below (SymMat layout, the
//     threshold schedule, border flagging) is adapted from sp4cerat's
//     Fast-Quadric-Mesh-Simplification (MIT license,
//     github.com/sp4cerat/Fast-Quadric-Mesh-Simplification — the algorithm
//     pyfqmr wraps); it is an adaptation, not a from-scratch design.
//   - laplacian smoothing: o3d filter_smooth_laplacian (refined_mesh.py:451).
//   - 3-NN mean squared distance: simple-knn distCUDA2 (simple_knn.cu:45-221),
//     uniform-grid version for host-side initialization.
//   - face connected components: trimesh.graph.connected_component_labels.
//
// Build: gaustar_tpu_torch/native/__init__.py runs g++ at first use into
// build/native/libmeshops-<hash>.so.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <array>
#include <algorithm>
#include <unordered_map>

extern "C" {

// ---------------------------------------------------------------------------
// Quadric decimation
// ---------------------------------------------------------------------------

namespace qd {

struct SymMat {
  double m[10];  // upper triangle of symmetric 4x4
  SymMat() { std::memset(m, 0, sizeof(m)); }
  SymMat(double a, double b, double c, double d) {
    m[0] = a * a; m[1] = a * b; m[2] = a * c; m[3] = a * d;
    m[4] = b * b; m[5] = b * c; m[6] = b * d;
    m[7] = c * c; m[8] = c * d;
    m[9] = d * d;
  }
  SymMat operator+(const SymMat& o) const {
    SymMat r;
    for (int i = 0; i < 10; i++) r.m[i] = m[i] + o.m[i];
    return r;
  }
  SymMat& operator+=(const SymMat& o) {
    for (int i = 0; i < 10; i++) m[i] += o.m[i];
    return *this;
  }
  double det(int a11, int a12, int a13, int a21, int a22, int a23, int a31,
             int a32, int a33) const {
    return m[a11] * m[a22] * m[a33] + m[a13] * m[a21] * m[a32] +
           m[a12] * m[a23] * m[a31] - m[a13] * m[a22] * m[a31] -
           m[a11] * m[a23] * m[a32] - m[a12] * m[a21] * m[a33];
  }
};

struct V3 {
  double x, y, z;
  V3() : x(0), y(0), z(0) {}
  V3(double a, double b, double c) : x(a), y(b), z(c) {}
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
  V3 cross(const V3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
  void normalize() {
    double n = norm();
    if (n > 1e-20) { x /= n; y /= n; z /= n; }
  }
};

struct Tri {
  int v[3];
  double err[4];
  bool deleted, dirty;
  V3 n;
};
struct Vert {
  V3 p;
  int tstart, tcount;
  SymMat q;
  bool border;
};
struct Ref {
  int tid, tvertex;
};

struct Simplifier {
  std::vector<Tri> triangles;
  std::vector<Vert> vertices;
  std::vector<Ref> refs;

  double vertex_error(const SymMat& q, double x, double y, double z) {
    return q.m[0] * x * x + 2 * q.m[1] * x * y + 2 * q.m[2] * x * z +
           2 * q.m[3] * x + q.m[4] * y * y + 2 * q.m[5] * y * z +
           2 * q.m[6] * y + q.m[7] * z * z + 2 * q.m[8] * z + q.m[9];
  }

  double calculate_error(int id_v1, int id_v2, V3& p_result) {
    SymMat q = vertices[id_v1].q + vertices[id_v2].q;
    bool border = vertices[id_v1].border && vertices[id_v2].border;
    double error = 0;
    double det = q.det(0, 1, 2, 1, 4, 5, 2, 5, 7);
    if (det != 0 && !border) {
      p_result.x = -1.0 / det * q.det(1, 2, 3, 4, 5, 6, 5, 7, 8);
      p_result.y = 1.0 / det * q.det(0, 2, 3, 1, 5, 6, 2, 7, 8);
      p_result.z = -1.0 / det * q.det(0, 1, 3, 1, 4, 6, 2, 5, 8);
      error = vertex_error(q, p_result.x, p_result.y, p_result.z);
    } else {
      V3 p1 = vertices[id_v1].p;
      V3 p2 = vertices[id_v2].p;
      V3 p3 = (p1 + p2) * 0.5;
      double e1 = vertex_error(q, p1.x, p1.y, p1.z);
      double e2 = vertex_error(q, p2.x, p2.y, p2.z);
      double e3 = vertex_error(q, p3.x, p3.y, p3.z);
      error = std::min(e1, std::min(e2, e3));
      if (error == e1) p_result = p1;
      else if (error == e2) p_result = p2;
      else p_result = p3;
    }
    return error;
  }

  bool flipped(const V3& p, int i1, const Vert& v0, std::vector<int>& deleted) {
    for (int k = 0; k < v0.tcount; k++) {
      const Tri& t = triangles[refs[v0.tstart + k].tid];
      if (t.deleted) continue;
      int s = refs[v0.tstart + k].tvertex;
      int id1 = t.v[(s + 1) % 3];
      int id2 = t.v[(s + 2) % 3];
      if (id1 == i1 || id2 == i1) {  // face collapses with the edge
        deleted[k] = 1;
        continue;
      }
      V3 d1 = vertices[id1].p - p; d1.normalize();
      V3 d2 = vertices[id2].p - p; d2.normalize();
      if (std::fabs(d1.dot(d2)) > 0.999) return true;
      V3 n = d1.cross(d2); n.normalize();
      deleted[k] = 0;
      if (n.dot(t.n) < 0.2) return true;
    }
    return false;
  }

  void update_triangles(int i0, const Vert& v, std::vector<int>& deleted, int& deleted_triangles) {
    V3 p;
    for (int k = 0; k < v.tcount; k++) {
      Ref& r = refs[v.tstart + k];
      Tri& t = triangles[r.tid];
      if (t.deleted) continue;
      if (deleted[k]) {
        t.deleted = true;
        deleted_triangles++;
        continue;
      }
      t.v[r.tvertex] = i0;
      t.dirty = true;
      t.err[0] = calculate_error(t.v[0], t.v[1], p);
      t.err[1] = calculate_error(t.v[1], t.v[2], p);
      t.err[2] = calculate_error(t.v[2], t.v[0], p);
      t.err[3] = std::min(t.err[0], std::min(t.err[1], t.err[2]));
      refs.push_back(r);
    }
  }

  void update_mesh(int iteration) {
    if (iteration > 0) {  // compact triangles
      int dst = 0;
      for (auto& t : triangles)
        if (!t.deleted) triangles[dst++] = t;
      triangles.resize(dst);
    }
    // Rebuild refs
    for (auto& v : vertices) { v.tstart = 0; v.tcount = 0; }
    for (auto& t : triangles)
      for (int j = 0; j < 3; j++) vertices[t.v[j]].tcount++;
    int tstart = 0;
    for (auto& v : vertices) { v.tstart = tstart; tstart += v.tcount; v.tcount = 0; }
    refs.resize(triangles.size() * 3);
    for (size_t i = 0; i < triangles.size(); i++) {
      Tri& t = triangles[i];
      for (int j = 0; j < 3; j++) {
        Vert& v = vertices[t.v[j]];
        refs[v.tstart + v.tcount] = {(int)i, j};
        v.tcount++;
      }
    }
    if (iteration == 0) {
      // Identify borders + init quadrics
      for (auto& v : vertices) v.border = false;
      std::vector<int> vcount, vids;
      for (size_t i = 0; i < vertices.size(); i++) {
        Vert& v = vertices[i];
        vcount.clear(); vids.clear();
        for (int j = 0; j < v.tcount; j++) {
          const Tri& t = triangles[refs[v.tstart + j].tid];
          for (int k = 0; k < 3; k++) {
            int id = t.v[k];
            if (id == (int)i) continue;
            int ofs = -1;
            for (size_t c = 0; c < vids.size(); c++)
              if (vids[c] == id) { ofs = (int)c; break; }
            if (ofs < 0) { vcount.push_back(1); vids.push_back(id); }
            else vcount[ofs]++;
          }
        }
        for (size_t j = 0; j < vcount.size(); j++)
          if (vcount[j] == 1) { v.border = true; vertices[vids[j]].border = true; }
      }
      for (auto& v : vertices) v.q = SymMat();
      for (auto& t : triangles) {
        V3 p[3] = {vertices[t.v[0]].p, vertices[t.v[1]].p, vertices[t.v[2]].p};
        V3 n = (p[1] - p[0]).cross(p[2] - p[0]);
        n.normalize();
        t.n = n;
        SymMat plane(n.x, n.y, n.z, -n.dot(p[0]));
        for (int j = 0; j < 3; j++) vertices[t.v[j]].q += plane;
      }
      V3 p;
      for (auto& t : triangles) {
        for (int j = 0; j < 3; j++)
          t.err[j] = calculate_error(t.v[j], t.v[(j + 1) % 3], p);
        t.err[3] = std::min(t.err[0], std::min(t.err[1], t.err[2]));
      }
    }
  }

  void simplify(int target_count, double aggressiveness) {
    for (auto& t : triangles) t.deleted = false;
    int deleted_triangles = 0;
    std::vector<int> deleted0, deleted1;
    int triangle_count = (int)triangles.size();

    for (int iteration = 0; iteration < 200; iteration++) {
      if (triangle_count - deleted_triangles <= target_count) break;
      if (iteration % 5 == 0) update_mesh(iteration);
      for (auto& t : triangles) t.dirty = false;
      double threshold = 1e-9 * std::pow(double(iteration + 3), aggressiveness);

      for (auto& t : triangles) {
        if (t.err[3] > threshold || t.deleted || t.dirty) continue;
        for (int j = 0; j < 3; j++) {
          if (t.err[j] >= threshold) continue;
          int i0 = t.v[j];
          int i1 = t.v[(j + 1) % 3];
          Vert& v0 = vertices[i0];
          Vert& v1 = vertices[i1];
          if (v0.border != v1.border) continue;
          V3 p;
          calculate_error(i0, i1, p);
          deleted0.resize(v0.tcount);
          deleted1.resize(v1.tcount);
          if (flipped(p, i1, v0, deleted0)) continue;
          if (flipped(p, i0, v1, deleted1)) continue;
          v0.p = p;
          v0.q = v1.q + v0.q;
          int tstart = (int)refs.size();
          update_triangles(i0, v0, deleted0, deleted_triangles);
          update_triangles(i0, v1, deleted1, deleted_triangles);
          int tcount = (int)refs.size() - tstart;
          v0.tstart = tstart;
          v0.tcount = tcount;
          break;
        }
        if (triangle_count - deleted_triangles <= target_count) break;
      }
    }
    // Drop deleted triangles; vertex remapping is done by the caller against
    // the INTACT vertices array.
    int dst = 0;
    for (auto& t : triangles)
      if (!t.deleted) triangles[dst++] = t;
    triangles.resize(dst);
  }
};

}  // namespace qd

// Decimate. Returns new counts through out params; caller provides output
// buffers sized (n_verts*3) and (n_faces*3) — output is never larger.
int decimate_quadric(const double* verts, int64_t n_verts, const int32_t* faces,
                     int64_t n_faces, int64_t target_faces, double aggressiveness,
                     double* out_verts, int32_t* out_faces, int64_t* out_nv,
                     int64_t* out_nf) {
  qd::Simplifier s;
  s.vertices.resize(n_verts);
  for (int64_t i = 0; i < n_verts; i++)
    s.vertices[i].p = {verts[i * 3], verts[i * 3 + 1], verts[i * 3 + 2]};
  s.triangles.resize(n_faces);
  for (int64_t i = 0; i < n_faces; i++) {
    for (int j = 0; j < 3; j++) s.triangles[i].v[j] = faces[i * 3 + j];
    s.triangles[i].deleted = false;
    s.triangles[i].dirty = false;
  }
  s.simplify((int)target_faces, aggressiveness);

  // Remap (tstart holds new index for retained vertices, tcount the flag).
  // Recompute explicit remap to be safe:
  std::vector<int64_t> remap(n_verts, -1);
  int64_t nv = 0;
  std::vector<char> used(n_verts, 0);
  for (auto& t : s.triangles)
    for (int j = 0; j < 3; j++) used[t.v[j]] = 1;
  for (int64_t i = 0; i < n_verts; i++)
    if (used[i]) {
      remap[i] = nv;
      out_verts[nv * 3] = s.vertices[i].p.x;
      out_verts[nv * 3 + 1] = s.vertices[i].p.y;
      out_verts[nv * 3 + 2] = s.vertices[i].p.z;
      nv++;
    }
  int64_t nf = 0;
  for (auto& t : s.triangles) {
    out_faces[nf * 3] = (int32_t)remap[t.v[0]];
    out_faces[nf * 3 + 1] = (int32_t)remap[t.v[1]];
    out_faces[nf * 3 + 2] = (int32_t)remap[t.v[2]];
    nf++;
  }
  *out_nv = nv;
  *out_nf = nf;
  return 0;
}

// ---------------------------------------------------------------------------
// Laplacian smoothing (uniform weights, like o3d filter_smooth_laplacian lambda=0.5)
// ---------------------------------------------------------------------------
int laplacian_smooth(double* verts, int64_t n_verts, const int32_t* faces,
                     int64_t n_faces, int iterations, double lam) {
  std::vector<std::vector<int32_t>> adj(n_verts);
  for (int64_t i = 0; i < n_faces; i++) {
    const int32_t* f = faces + i * 3;
    for (int e = 0; e < 3; e++) {
      int32_t a = f[e], b = f[(e + 1) % 3];
      adj[a].push_back(b);
      adj[b].push_back(a);
    }
  }
  std::vector<double> next(n_verts * 3);
  for (int it = 0; it < iterations; it++) {
    for (int64_t i = 0; i < n_verts; i++) {
      if (adj[i].empty()) {
        for (int d = 0; d < 3; d++) next[i * 3 + d] = verts[i * 3 + d];
        continue;
      }
      double acc[3] = {0, 0, 0};
      for (int32_t nb : adj[i])
        for (int d = 0; d < 3; d++) acc[d] += verts[nb * 3 + d];
      double inv = 1.0 / adj[i].size();
      for (int d = 0; d < 3; d++) {
        double mean = acc[d] * inv;
        next[i * 3 + d] = verts[i * 3 + d] + lam * (mean - verts[i * 3 + d]);
      }
    }
    std::memcpy(verts, next.data(), sizeof(double) * n_verts * 3);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Mean squared distance to 3 nearest neighbors (uniform grid) — distCUDA2.
// ---------------------------------------------------------------------------
int knn3_mean_sq_dist(const float* pts, int64_t n, float* out) {
  if (n <= 1) { for (int64_t i = 0; i < n; i++) out[i] = 0; return 0; }
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; i++)
    for (int d = 0; d < 3; d++) {
      lo[d] = std::min(lo[d], pts[i * 3 + d]);
      hi[d] = std::max(hi[d], pts[i * 3 + d]);
    }
  double vol = 1.0;
  for (int d = 0; d < 3; d++) vol *= std::max(1e-9f, hi[d] - lo[d]);
  double cell = std::cbrt(vol / (double)n) + 1e-12;
  auto cell_of = [&](const float* p, int64_t* c) {
    for (int d = 0; d < 3; d++) c[d] = (int64_t)((p[d] - lo[d]) / cell);
  };
  auto key_of = [&](int64_t ix, int64_t iy, int64_t iz) {
    return (ix * 73856093LL) ^ (iy * 19349663LL) ^ (iz * 83492791LL);
  };
  std::unordered_map<int64_t, std::vector<int32_t>> grid;
  grid.reserve(n * 2);
  for (int64_t i = 0; i < n; i++) {
    int64_t c[3];
    cell_of(pts + i * 3, c);
    grid[key_of(c[0], c[1], c[2])].push_back((int32_t)i);
  }
  // Clustered clouds (bbox mostly empty) leave dense cells with dozens of
  // points; shrink the cell toward ~4 points per occupied cell and rebuild.
  double occ = (double)n / std::max<size_t>(grid.size(), 1);
  if (occ > 8.0) {
    cell /= std::cbrt(occ / 4.0);
    grid.clear();
    grid.reserve(n * 2);
    for (int64_t i = 0; i < n; i++) {
      int64_t c[3];
      cell_of(pts + i * 3, c);
      grid[key_of(c[0], c[1], c[2])].push_back((int32_t)i);
    }
  }

  for (int64_t i = 0; i < n; i++) {
    const float* p = pts + i * 3;
    int64_t c[3];
    cell_of(p, c);
    double best[3] = {1e30, 1e30, 1e30};
    for (int ring = 1; ring <= 32; ring++) {
      // search (2*ring+1)^3 neighborhood; stop once 3 found within (ring-1)*cell
      for (int dx = -ring; dx <= ring; dx++)
        for (int dy = -ring; dy <= ring; dy++)
          for (int dz = -ring; dz <= ring; dz++) {
            if (ring > 1 && std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) < ring)
              continue;  // only the new shell
            auto it = grid.find(key_of(c[0] + dx, c[1] + dy, c[2] + dz));
            if (it == grid.end()) continue;
            for (int32_t j : it->second) {
              if (j == (int32_t)i) continue;
              double d0 = p[0] - pts[j * 3], d1 = p[1] - pts[j * 3 + 1],
                     d2 = p[2] - pts[j * 3 + 2];
              double d = d0 * d0 + d1 * d1 + d2 * d2;
              if (d < best[2]) {
                best[2] = d;
                if (best[2] < best[1]) std::swap(best[1], best[2]);
                if (best[1] < best[0]) std::swap(best[0], best[1]);
              }
            }
          }
      // A point within r of p lies in a cell at Chebyshev distance <= ceil(r/cell),
      // so shells 0..ring cover the full ball of radius ring*cell.
      double reach = (double)ring * cell;
      if (best[2] < reach * reach) break;
    }
    out[i] = (float)((best[0] + best[1] + best[2]) / 3.0);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Face connected components (union-find over shared edges)
// ---------------------------------------------------------------------------
static int32_t uf_find(std::vector<int32_t>& parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

int face_connected_components(const int32_t* faces, int64_t n_faces,
                              int64_t n_verts, int32_t* labels) {
  std::vector<int32_t> parent(n_faces);
  for (int64_t i = 0; i < n_faces; i++) parent[i] = (int32_t)i;
  std::unordered_map<int64_t, int32_t> edge_face;
  edge_face.reserve(n_faces * 3);
  for (int64_t i = 0; i < n_faces; i++) {
    for (int e = 0; e < 3; e++) {
      int64_t a = faces[i * 3 + e], b = faces[i * 3 + (e + 1) % 3];
      if (a > b) std::swap(a, b);
      int64_t k = a * n_verts + b;
      auto it = edge_face.find(k);
      if (it == edge_face.end()) {
        edge_face[k] = (int32_t)i;
      } else {
        int32_t ra = uf_find(parent, it->second);
        int32_t rb = uf_find(parent, (int32_t)i);
        if (ra != rb) parent[rb] = ra;
      }
    }
  }
  std::unordered_map<int32_t, int32_t> relabel;
  int32_t next = 0;
  for (int64_t i = 0; i < n_faces; i++) {
    int32_t r = uf_find(parent, (int32_t)i);
    auto it = relabel.find(r);
    if (it == relabel.end()) { relabel[r] = next; labels[i] = next; next++; }
    else labels[i] = it->second;
  }
  return next;
}

}  // extern "C"
