// Native IBM-preprocessing kernels for udales_jax.
//
// C++ replacements for the hot geometry loops of prep/ibmprep.py /
// prep/geom.py (the reference implements these in Fortran,
// tools/python/fortran/ibm_preproc/).  Exposed through a plain C ABI and
// loaded with ctypes; the Python implementations remain as the reference
// semantics and fallback.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libibmprep.so ibmprep.cpp
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct V3 {
    double x, y, z;
};
static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
static inline double dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
static inline double comp(const V3& v, int ax) {
    return ax == 0 ? v.x : (ax == 1 ? v.y : v.z);
}
static inline void setcomp(V3& v, int ax, double val) {
    if (ax == 0) v.x = val; else if (ax == 1) v.y = val; else v.z = val;
}

constexpr double EPS = 1e-9;

// Sutherland-Hodgman clip of a polygon against one half-space
// sign*(p[ax]-bound) >= -EPS
static void clip_plane(std::vector<V3>& poly, int ax, double sign,
                       double bound, std::vector<V3>& out) {
    out.clear();
    size_t n = poly.size();
    for (size_t i = 0; i < n; ++i) {
        const V3& cur = poly[i];
        const V3& nxt = poly[(i + 1) % n];
        double dc = sign * (comp(cur, ax) - bound);
        double dn = sign * (comp(nxt, ax) - bound);
        bool cin = dc >= -EPS, nin = dn >= -EPS;
        if (cin) out.push_back(cur);
        if (cin != nin) {
            double t = dc / (dc - dn);
            out.push_back({cur.x + t * (nxt.x - cur.x),
                           cur.y + t * (nxt.y - cur.y),
                           cur.z + t * (nxt.z - cur.z)});
        }
    }
}

static double polygon_area(const std::vector<V3>& poly) {
    if (poly.size() < 3) return 0.0;
    V3 s{0, 0, 0};
    for (size_t i = 1; i + 1 < poly.size(); ++i) {
        V3 a = sub(poly[i], poly[0]);
        V3 b = sub(poly[i + 1], poly[0]);
        V3 c = cross(a, b);
        s.x += c.x; s.y += c.y; s.z += c.z;
    }
    return 0.5 * std::sqrt(dot(s, s));
}

}  // namespace

extern "C" {

// Solid mask: ray-parity (+z rays, column-factored) + on-facet detection.
// tris: (nt,3,3) row-major; normals: (nt,3); xs/ys/zs: grid point coords.
// out: uint8 (nx*ny*nzg), 1 = solid.
void grid_solid_mask(const double* tris, const double* normals, long nt,
                     const double* xs, long nx, const double* ys, long ny,
                     const double* zs, long nzg, double tol,
                     uint8_t* out) {
    std::memset(out, 0, (size_t)nx * ny * nzg);
    // per-column ray parity
    #pragma omp parallel for collapse(2) schedule(dynamic)
    for (long i = 0; i < nx; ++i) {
        for (long j = 0; j < ny; ++j) {
            double px = xs[i], py = ys[j];
            // gather z-hits for this column
            std::vector<std::pair<double, double>> hits;  // (zhit, weight)
            std::vector<double> onz;
            for (long t = 0; t < nt; ++t) {
                const double* T = tris + 9 * t;
                double ax = T[0], ay = T[1], az = T[2];
                double bx = T[3], by = T[4], bz = T[5];
                double cx = T[6], cy = T[7], cz = T[8];
                double d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy);
                if (std::fabs(d) < 1e-14) continue;  // vertical triangle
                double l1 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) / d;
                double l2 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) / d;
                double l3 = 1.0 - l1 - l2;
                if (l1 <= -1e-12 || l2 <= -1e-12 || l3 <= -1e-12) continue;
                double zhit = l1 * az + l2 * bz + l3 * cz;
                bool edge = (std::fabs(l1) <= 1e-12 ||
                             std::fabs(l2) <= 1e-12 ||
                             std::fabs(l3) <= 1e-12);
                hits.emplace_back(zhit, edge ? 0.5 : 1.0);
            }
            uint8_t* col = out + ((size_t)i * ny + j) * nzg;
            for (long k = 0; k < nzg; ++k) {
                double z = zs[k];
                double cnt = 0.0;
                bool on = false;
                for (auto& h : hits) {
                    if (h.first > z + tol) cnt += h.second;
                    else if (std::fabs(h.first - z) <= tol) on = true;
                }
                long ic = (long)std::llround(cnt);
                if ((ic % 2) == 1 || on) col[k] = 1;
            }
        }
    }
    // on-facet points for walls of any orientation
    for (long t = 0; t < nt; ++t) {
        const double* T = tris + 9 * t;
        const double* n = normals + 3 * t;
        double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
        for (int v = 0; v < 3; ++v)
            for (int a = 0; a < 3; ++a) {
                lo[a] = std::min(lo[a], T[3 * v + a]);
                hi[a] = std::max(hi[a], T[3 * v + a]);
            }
        int ax = 0;
        double best = std::fabs(n[0]);
        if (std::fabs(n[1]) > best) { ax = 1; best = std::fabs(n[1]); }
        if (std::fabs(n[2]) > best) { ax = 2; }
        int k1 = (ax + 1) % 3, k2 = (ax + 2) % 3;  // projection axes
        auto inrange = [&](const double* arr, long narr, double vlo,
                           double vhi, long& s, long& e) {
            s = std::lower_bound(arr, arr + narr, vlo - tol) - arr;
            e = std::upper_bound(arr, arr + narr, vhi + tol) - arr;
        };
        long i0, i1, j0, j1, kk0, kk1;
        inrange(xs, nx, lo[0], hi[0], i0, i1);
        inrange(ys, ny, lo[1], hi[1], j0, j1);
        inrange(zs, nzg, lo[2], hi[2], kk0, kk1);
        double a2[2] = {T[0 + k1], T[0 + k2]};
        double b2[2] = {T[3 + k1], T[3 + k2]};
        double c2[2] = {T[6 + k1], T[6 + k2]};
        double d = (b2[1] - c2[1]) * (a2[0] - c2[0])
                 + (c2[0] - b2[0]) * (a2[1] - c2[1]);
        if (std::fabs(d) < 1e-14) continue;
        for (long i = i0; i < i1; ++i)
            for (long j = j0; j < j1; ++j)
                for (long k = kk0; k < kk1; ++k) {
                    double P[3] = {xs[i], ys[j], zs[k]};
                    double dist = std::fabs((P[0] - T[0]) * n[0]
                                          + (P[1] - T[1]) * n[1]
                                          + (P[2] - T[2]) * n[2]);
                    if (dist > tol) continue;
                    double p2x = P[k1], p2y = P[k2];
                    double l1 = ((b2[1] - c2[1]) * (p2x - c2[0])
                               + (c2[0] - b2[0]) * (p2y - c2[1])) / d;
                    double l2 = ((c2[1] - a2[1]) * (p2x - c2[0])
                               + (a2[0] - c2[0]) * (p2y - c2[1])) / d;
                    double l3 = 1.0 - l1 - l2;
                    if (l1 > -1e-9 && l2 > -1e-9 && l3 > -1e-9)
                        out[((size_t)i * ny + j) * nzg + k] = 1;
                }
    }
}

// Facet-section generation (prep/ibmprep.py cut_sections semantics).
// Cell boxes are given by per-axis face coordinate arrays: box of point
// (i,j,k) is [bxlo[i],bxhi[i]] x [bylo[j],byhi[j]] x [bzlo[k],bzhi[k]].
// skip_axis: -1 (c grid) or 0/1/2 — skip facets with |normal[axis]| == 1.
// fluid: uint8 (nx*ny*nzg).
// Output rows appended to preallocated arrays of capacity cap; returns the
// number of rows, or -(needed) if cap would be exceeded.
long cut_sections(const double* tris, const double* normals,
                  const long* facids, long nt,
                  const double* bxlo, const double* bxhi, long nx,
                  const double* bylo, const double* byhi, long ny,
                  const double* bzlo, const double* bzhi, long nzg,
                  const double* px, const double* py, const double* pz,
                  const uint8_t* fluid, int skip_axis, double area_tol,
                  long cap, long* out_fac, double* out_area,
                  long* out_ijk, double* out_dist) {
    long count = 0;
    std::vector<V3> poly, tmp;
    for (long t = 0; t < nt; ++t) {
        const double* T = tris + 9 * t;
        const double* n = normals + 3 * t;
        if (skip_axis >= 0 &&
            std::fabs(std::fabs(n[skip_axis]) - 1.0) < 1e-9)
            continue;
        double lo[3] = {1e300, 1e300, 1e300};
        double hi[3] = {-1e300, -1e300, -1e300};
        for (int v = 0; v < 3; ++v)
            for (int a = 0; a < 3; ++a) {
                lo[a] = std::min(lo[a], T[3 * v + a]);
                hi[a] = std::max(hi[a], T[3 * v + a]);
            }
        // candidate index ranges: boxes overlapping the triangle AABB
        auto range = [&](const double* blo, const double* bhi, long nn,
                         double vlo, double vhi, long& s, long& e) {
            s = 0; e = nn;
            while (s < nn && bhi[s] < vlo - EPS) ++s;
            long ee = s;
            while (ee < nn && blo[ee] <= vhi + EPS) ++ee;
            e = ee;
        };
        long i0, i1, j0, j1, k0, k1;
        range(bxlo, bxhi, nx, lo[0], hi[0], i0, i1);
        range(bylo, byhi, ny, lo[1], hi[1], j0, j1);
        range(bzlo, bzhi, nzg, lo[2], hi[2], k0, k1);
        for (long i = i0; i < i1; ++i)
            for (long j = j0; j < j1; ++j)
                for (long k = k0; k < k1; ++k) {
                    double blo[3] = {bxlo[i], bylo[j], bzlo[k]};
                    double bhi[3] = {bxhi[i], byhi[j], bzhi[k]};
                    poly = {{T[0], T[1], T[2]}, {T[3], T[4], T[5]},
                            {T[6], T[7], T[8]}};
                    for (int a = 0; a < 3 && !poly.empty(); ++a) {
                        clip_plane(poly, a, 1.0, blo[a], tmp);
                        poly.swap(tmp);
                        if (poly.empty()) break;
                        clip_plane(poly, a, -1.0, bhi[a], tmp);
                        poly.swap(tmp);
                    }
                    double area = polygon_area(poly);
                    if (area <= area_tol) continue;
                    // face-coincident pieces belong to the cell the normal
                    // points into
                    bool skip = false;
                    for (int a = 0; a < 3; ++a) {
                        bool onlo = true, onhi = true;
                        for (auto& p : poly) {
                            double v = comp(p, a);
                            if (std::fabs(v - blo[a]) >= 1e-9) onlo = false;
                            if (std::fabs(v - bhi[a]) >= 1e-9) onhi = false;
                        }
                        if (onlo && n[a] <= 0) skip = true;
                        if (onhi && n[a] >= 0) skip = true;
                    }
                    if (skip) continue;
                    size_t idx = ((size_t)i * ny + j) * nzg + k;
                    long oi = i, oj = j, ok = k;
                    double dist;
                    if (fluid[idx]) {
                        dist = std::fabs((px[i] - T[0]) * n[0]
                                       + (py[j] - T[1]) * n[1]
                                       + (pz[k] - T[2]) * n[2]);
                    } else {
                        // reassign to the nearest fluid 26-neighbour
                        double best = 1e300;
                        long bi = -1, bj = -1, bk = -1;
                        for (int di = -1; di <= 1; ++di)
                            for (int dj = -1; dj <= 1; ++dj)
                                for (int dk = -1; dk <= 1; ++dk) {
                                    long ii = (i + di + nx) % nx;
                                    long jj = (j + dj + ny) % ny;
                                    long kk = k + dk;
                                    if (kk < 0 || kk >= nzg) continue;
                                    if (!fluid[((size_t)ii * ny + jj) * nzg
                                               + kk])
                                        continue;
                                    double qx = px[ii], qy = py[jj],
                                           qz = pz[kk];
                                    double dmin = 1e300;
                                    for (auto& p : poly) {
                                        double dx = p.x - qx, dy = p.y - qy,
                                               dz = p.z - qz;
                                        double dd = dx * dx + dy * dy
                                                  + dz * dz;
                                        dmin = std::min(dmin, dd);
                                    }
                                    if (dmin < best) {
                                        best = dmin;
                                        bi = ii; bj = jj; bk = kk;
                                    }
                                }
                        if (bi < 0) continue;
                        oi = bi; oj = bj; ok = bk;
                        dist = std::sqrt(best);
                    }
                    if (count >= cap) return -(count + 1);
                    out_fac[count] = facids[t];
                    out_area[count] = area;
                    out_ijk[3 * count] = oi;
                    out_ijk[3 * count + 1] = oj;
                    out_ijk[3 * count + 2] = ok;
                    out_dist[count] = dist;
                    ++count;
                }
    }
    return count;
}

}  // extern "C"
