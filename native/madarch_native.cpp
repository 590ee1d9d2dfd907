// Native host-runtime components of madarch_tpu.
//
// The reference's host layer is compiled Ada; the JAX rebuild keeps its
// hot host-side paths native too: OBJ parsing, SAH BVH construction
// (/root/reference/madarch/support/bounding_volume_hierarchies.adb:57-211)
// and the Danielsson-style vector distance transform
// (/root/reference/madarch/support/meshes-distance_maps.adb:17-145).
// Exposed as a C ABI consumed through ctypes (madarch_tpu/native.py), with
// pure-Python fallbacks when the library is not built.
//
// Build: make -C native   (produces libmadarch_native.so)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <cfloat>
#include <vector>
#include <string>
#include <algorithm>
#include <numeric>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader: v / vn / f with v//n references, fan triangulation.
// Returns 0 on success; caller frees with md_free.
// ---------------------------------------------------------------------------
int md_load_obj(const char *path,
                float **out_verts, int *n_verts,
                float **out_normals, int *n_normals,
                int **out_tris, int **out_tri_normals, int *n_tris) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;

  std::vector<float> verts, normals;
  std::vector<int> tris, tri_ns;
  char line[1024];

  while (fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        verts.push_back(x); verts.push_back(y); verts.push_back(z);
      }
    } else if (line[0] == 'v' && line[1] == 'n') {
      float x, y, z;
      if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        normals.push_back(x); normals.push_back(y); normals.push_back(z);
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      std::vector<int> vi, ni;
      char *tok = strtok(line + 2, " \t\r\n");
      while (tok) {
        int v = 0, n = 0;
        // accept "v", "v/t", "v//n", "v/t/n"
        char *slash1 = strchr(tok, '/');
        v = atoi(tok);
        if (slash1) {
          char *slash2 = strchr(slash1 + 1, '/');
          n = slash2 ? atoi(slash2 + 1) : v;
        } else {
          n = v;
        }
        vi.push_back(v - 1);
        ni.push_back(n - 1);
        tok = strtok(nullptr, " \t\r\n");
      }
      for (size_t i = 1; i + 1 < vi.size(); ++i) {  // fan
        tris.push_back(vi[0]); tris.push_back(vi[i]); tris.push_back(vi[i+1]);
        tri_ns.push_back(ni[0]); tri_ns.push_back(ni[i]);
        tri_ns.push_back(ni[i+1]);
      }
    }
  }
  fclose(f);

  auto copy_out = [](const std::vector<float> &src, float **dst) {
    *dst = (float *)malloc(src.size() * sizeof(float));
    memcpy(*dst, src.data(), src.size() * sizeof(float));
  };
  auto copy_out_i = [](const std::vector<int> &src, int **dst) {
    *dst = (int *)malloc(src.size() * sizeof(int));
    memcpy(*dst, src.data(), src.size() * sizeof(int));
  };
  copy_out(verts, out_verts);       *n_verts = (int)(verts.size() / 3);
  copy_out(normals, out_normals);   *n_normals = (int)(normals.size() / 3);
  copy_out_i(tris, out_tris);
  copy_out_i(tri_ns, out_tri_normals);
  *n_tris = (int)(tris.size() / 3);
  return 0;
}

void md_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// SAH BVH build (sweep over all 3 axes).  Nodes are emitted pre-order into
// flat arrays sized 2n-1; leaves hold one primitive index each
// (node_leaf_index >= 0), inner nodes have left/right child slots.
// ---------------------------------------------------------------------------
struct BvhCtx {
  const float *los, *his;
  std::vector<float> centers;          // n*3
  float *node_lo, *node_hi;
  int *node_left, *node_right, *node_leaf;
  int next;
};

static float surface_area(const float lo[3], const float hi[3]) {
  float d0 = std::max(hi[0] - lo[0], 0.f);
  float d1 = std::max(hi[1] - lo[1], 0.f);
  float d2 = std::max(hi[2] - lo[2], 0.f);
  return 2.f * (d0 * d1 + d1 * d2 + d0 * d2);
}

static int bvh_recurse(BvhCtx &ctx, std::vector<int> &idx) {
  int me = ctx.next++;
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i : idx)
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], ctx.los[i * 3 + a]);
      hi[a] = std::max(hi[a], ctx.his[i * 3 + a]);
    }
  memcpy(ctx.node_lo + me * 3, lo, sizeof lo);
  memcpy(ctx.node_hi + me * 3, hi, sizeof hi);

  if (idx.size() == 1) {
    ctx.node_leaf[me] = idx[0];
    ctx.node_left[me] = ctx.node_right[me] = -1;
    return me;
  }
  ctx.node_leaf[me] = -1;

  size_t n = idx.size();
  double best_cost = DBL_MAX;
  int best_axis = 0;
  size_t best_k = n / 2;
  std::vector<int> best_order;

  std::vector<float> pref(n), suff(n);
  for (int axis = 0; axis < 3; ++axis) {
    std::vector<int> order = idx;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return ctx.centers[a * 3 + axis] < ctx.centers[b * 3 + axis];
    });
    float l_lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float l_hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (size_t i = 0; i < n; ++i) {
      int p = order[i];
      for (int a = 0; a < 3; ++a) {
        l_lo[a] = std::min(l_lo[a], ctx.los[p * 3 + a]);
        l_hi[a] = std::max(l_hi[a], ctx.his[p * 3 + a]);
      }
      pref[i] = surface_area(l_lo, l_hi);
    }
    float r_lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float r_hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (size_t i = n; i-- > 0;) {
      int p = order[i];
      for (int a = 0; a < 3; ++a) {
        r_lo[a] = std::min(r_lo[a], ctx.los[p * 3 + a]);
        r_hi[a] = std::max(r_hi[a], ctx.his[p * 3 + a]);
      }
      suff[i] = surface_area(r_lo, r_hi);
    }
    for (size_t k = 1; k < n; ++k) {
      double cost = (double)pref[k - 1] * k + (double)suff[k] * (n - k);
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_k = k;
        best_order = order;
      }
    }
  }

  std::vector<int> left_idx(best_order.begin(), best_order.begin() + best_k);
  std::vector<int> right_idx(best_order.begin() + best_k, best_order.end());
  ctx.node_left[me] = bvh_recurse(ctx, left_idx);
  ctx.node_right[me] = bvh_recurse(ctx, right_idx);
  (void)best_axis;
  return me;
}

int md_build_bvh(const float *los, const float *his, int n,
                 float *node_lo, float *node_hi,
                 int *node_left, int *node_right, int *node_leaf,
                 int *n_nodes) {
  if (n <= 0) return -1;
  BvhCtx ctx;
  ctx.los = los;
  ctx.his = his;
  ctx.centers.resize((size_t)n * 3);
  for (int i = 0; i < n * 3; ++i) ctx.centers[i] = (los[i] + his[i]) * 0.5f;
  ctx.node_lo = node_lo;
  ctx.node_hi = node_hi;
  ctx.node_left = node_left;
  ctx.node_right = node_right;
  ctx.node_leaf = node_leaf;
  ctx.next = 0;
  std::vector<int> all(n);
  std::iota(all.begin(), all.end(), 0);
  bvh_recurse(ctx, all);
  *n_nodes = ctx.next;
  return 0;
}

// ---------------------------------------------------------------------------
// Danielsson-style vector distance transform over an occupancy grid
// (meshes-distance_maps.adb:17-145): propagate nearest-site offset vectors
// in forward and backward raster sweeps, then emit Euclidean distances.
// ---------------------------------------------------------------------------
void md_distance_transform(const unsigned char *occ, int nx, int ny, int nz,
                           float sx, float sy, float sz, float *out_dist) {
  const long n = (long)nx * ny * nz;
  // offset vector to the nearest occupied voxel, in voxel units
  std::vector<int> vx(n), vy(n), vz(n);
  const int FAR_ = 1 << 14;
  auto at = [&](int x, int y, int z) -> long {
    return ((long)x * ny + y) * nz + z;
  };
  for (long i = 0; i < n; ++i) {
    if (occ[i]) { vx[i] = vy[i] = vz[i] = 0; }
    else { vx[i] = vy[i] = vz[i] = FAR_; }
  }
  auto d2 = [&](long i) -> double {
    double ax = vx[i] * (double)sx, ay = vy[i] * (double)sy,
           az = vz[i] * (double)sz;
    return ax * ax + ay * ay + az * az;
  };
  auto relax = [&](long i, long j, int dx, int dy, int dz) {
    if (vx[j] >= FAR_) return;
    double cx = (vx[j] + dx) * (double)sx;
    double cy = (vy[j] + dy) * (double)sy;
    double cz = (vz[j] + dz) * (double)sz;
    double cand = cx * cx + cy * cy + cz * cz;
    if (cand < d2(i)) {
      vx[i] = vx[j] + dx; vy[i] = vy[j] + dy; vz[i] = vz[j] + dz;
    }
  };
  // forward sweep
  for (int x = 0; x < nx; ++x)
    for (int y = 0; y < ny; ++y)
      for (int z = 0; z < nz; ++z) {
        long i = at(x, y, z);
        if (x > 0) relax(i, at(x - 1, y, z), 1, 0, 0);
        if (y > 0) relax(i, at(x, y - 1, z), 0, 1, 0);
        if (z > 0) relax(i, at(x, y, z - 1), 0, 0, 1);
      }
  // backward sweep
  for (int x = nx - 1; x >= 0; --x)
    for (int y = ny - 1; y >= 0; --y)
      for (int z = nz - 1; z >= 0; --z) {
        long i = at(x, y, z);
        if (x + 1 < nx) relax(i, at(x + 1, y, z), -1, 0, 0);
        if (y + 1 < ny) relax(i, at(x, y + 1, z), 0, -1, 0);
        if (z + 1 < nz) relax(i, at(x, y, z + 1), 0, 0, -1);
      }
  // second forward sweep tightens diagonal paths (Danielsson 3-pass shape)
  for (int x = 0; x < nx; ++x)
    for (int y = 0; y < ny; ++y)
      for (int z = 0; z < nz; ++z) {
        long i = at(x, y, z);
        if (x > 0) relax(i, at(x - 1, y, z), 1, 0, 0);
        if (y > 0) relax(i, at(x, y - 1, z), 0, 1, 0);
        if (z > 0) relax(i, at(x, y, z - 1), 0, 0, 1);
      }
  for (long i = 0; i < n; ++i)
    out_dist[i] = (float)std::sqrt(d2(i));
}

}  // extern "C"
