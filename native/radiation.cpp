// Native radiation-preprocessing kernels for udales_jax.
//
// C++ replacements for the hot loops of prep/radiation.py — facet-facet
// view factors with centroid-ray occlusion (the reference uses the C
// View3D submodule, tools/View3D) and the direct-shortwave shading ray
// tracer (the reference uses tools/python/fortran/directShortwave.f90).
// Exposed through a plain C ABI and loaded with ctypes; the numpy
// implementation in prep/radiation.py remains the reference semantics and
// fallback, and tests/test_prep_native.py validates this port against it.
//
// Unlike the numpy path, which materializes an (m,m) patch-pair kernel
// (O(m^2) memory, ~1 GB at a few thousand facets), this streams over
// patch pairs row-by-row with OpenMP parallelism over facets.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o libradiation.so radiation.cpp
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct V3 { double x, y, z; };
static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 mul(V3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
static inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
static inline double dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
static inline double norm(V3 a) { return std::sqrt(dot(a, a)); }

// Moller-Trumbore: does segment orig + t*dir, t in (tmin, tmax), hit
// triangle (A, e1, e2)?  Mirrors _segment_blocked / ray_hits tolerances.
static inline bool seg_hit(const V3& o, const V3& d, double tmin,
                           double tmax, const V3& A, const V3& e1,
                           const V3& e2) {
    V3 p = cross(d, e2);
    double det = dot(p, e1);
    if (std::fabs(det) <= 1e-14) return false;
    double inv = 1.0 / det;
    V3 tv = sub(o, A);
    double u = dot(tv, p) * inv;
    if (u < -1e-10) return false;
    V3 q = cross(tv, e1);
    double v = dot(q, d) * inv;
    if (v < -1e-10 || u + v > 1.0 + 1e-10) return false;
    double t = dot(q, e2) * inv;
    return (t > tmin && t < tmax);
}

// subdivide one triangle into 4^levels patches (same refinement as
// prep/radiation.py:_subdivide; ordering differs but only sums are used)
static void subdivide(const V3* tri, int levels, std::vector<V3>& out) {
    std::vector<V3> cur(tri, tri + 3);
    for (int l = 0; l < levels; ++l) {
        std::vector<V3> nxt;
        nxt.reserve(cur.size() * 4);
        for (size_t t = 0; t < cur.size(); t += 3) {
            V3 A = cur[t], B = cur[t + 1], C = cur[t + 2];
            V3 ab = mul(add(A, B), 0.5), bc = mul(add(B, C), 0.5),
               ca = mul(add(C, A), 0.5);
            V3 quads[12] = {A, ab, ca, ab, B, bc, ca, bc, C, ab, bc, ca};
            nxt.insert(nxt.end(), quads, quads + 12);
        }
        cur.swap(nxt);
    }
    out = cur;
}

static inline double tri_area(const V3& A, const V3& B, const V3& C) {
    return 0.5 * norm(cross(sub(B, A), sub(C, A)));
}

}  // namespace

extern "C" {

// view_factors: F[i*nf+j] = fraction of radiation leaving facet i that
// arrives at facet j; svf[i] = 1 - row sum (clipped to [0,1]).
// tris: (nf,3,3) row-major xyz vertices; normals: (nf,3) unit normals.
void view_factors(const double* tris, const double* normals, long nf,
                  int subdiv, int occlusion, double* F, double* svf) {
    // subdivide every facet
    std::vector<V3> pat;          // all patches, facet-major
    std::vector<double> parea;
    std::vector<V3> pcen;
    long per = 1;
    for (int l = 0; l < subdiv; ++l) per *= 4;
    pat.reserve((size_t)nf * per * 3);
    for (long f = 0; f < nf; ++f) {
        V3 tri[3] = {{tris[9 * f + 0], tris[9 * f + 1], tris[9 * f + 2]},
                     {tris[9 * f + 3], tris[9 * f + 4], tris[9 * f + 5]},
                     {tris[9 * f + 6], tris[9 * f + 7], tris[9 * f + 8]}};
        std::vector<V3> out;
        subdivide(tri, subdiv, out);
        pat.insert(pat.end(), out.begin(), out.end());
    }
    long m = (long)pat.size() / 3;
    pcen.resize(m);
    parea.resize(m);
    for (long p = 0; p < m; ++p) {
        V3 A = pat[3 * p], B = pat[3 * p + 1], C = pat[3 * p + 2];
        pcen[p] = mul(add(add(A, B), C), 1.0 / 3.0);
        parea[p] = tri_area(A, B, C);
    }
    // precompute triangle edges for occlusion rays
    std::vector<V3> TA(nf), Te1(nf), Te2(nf), Nrm(nf);
    std::vector<double> facarea(nf, 0.0);
    for (long f = 0; f < nf; ++f) {
        V3 A = {tris[9 * f + 0], tris[9 * f + 1], tris[9 * f + 2]};
        V3 B = {tris[9 * f + 3], tris[9 * f + 4], tris[9 * f + 5]};
        V3 C = {tris[9 * f + 6], tris[9 * f + 7], tris[9 * f + 8]};
        TA[f] = A; Te1[f] = sub(B, A); Te2[f] = sub(C, A);
        Nrm[f] = {normals[3 * f], normals[3 * f + 1], normals[3 * f + 2]};
    }
    for (long p = 0; p < m; ++p) facarea[p / per] += parea[p];

#pragma omp parallel for schedule(dynamic)
    for (long fi = 0; fi < nf; ++fi) {
        double* row = F + (size_t)fi * nf;
        std::memset(row, 0, sizeof(double) * nf);
        for (long pi = fi * per; pi < (fi + 1) * per; ++pi) {
            const V3 ci = pcen[pi];
            const V3 ni = Nrm[fi];
            for (long pj = 0; pj < m; ++pj) {
                long fj = pj / per;
                if (fj == fi) continue;
                V3 d = sub(pcen[pj], ci);
                double r2 = dot(d, d);
                if (r2 <= 1e-12) continue;
                double r = std::sqrt(r2);
                double ct_i = dot(d, ni) / r;
                double ct_j = -dot(d, Nrm[fj]) / r;
                if (ct_i <= 0.0 || ct_j <= 0.0) continue;
                if (occlusion && nf > 1) {
                    // shortened centre-to-centre segment, offset off the
                    // source plane; the two endpoint facets are excluded
                    V3 o = add(ci, mul(ni, 1e-6));
                    V3 dir = mul(d, 1.0 / r);
                    bool blocked = false;
                    for (long t = 0; t < nf; ++t) {
                        if (t == fi || t == fj) continue;
                        if (seg_hit(o, dir, 1e-4 * r, (1.0 - 1e-4) * r,
                                    TA[t], Te1[t], Te2[t])) {
                            blocked = true;
                            break;
                        }
                    }
                    if (blocked) continue;
                }
                double K = ct_i * ct_j / (M_PI * r2);
                row[fj] += K * parea[pi] * parea[pj];
            }
        }
        double ai = std::max(facarea[fi], 1e-30);
        double rs = 0.0;
        for (long fj = 0; fj < nf; ++fj) { row[fj] /= ai; rs += row[fj]; }
        if (rs > 1.0)
            for (long fj = 0; fj < nf; ++fj) row[fj] /= rs;
        svf[fi] = std::min(std::max(1.0 - std::min(rs, 1.0), 0.0), 1.0);
    }
}

// direct_shortwave: facet-averaged direct irradiance [W/m^2] with shading
// (directShortwave.f90 semantics; prep/radiation.py:135-158).
void direct_shortwave(const double* tris, const double* normals, long nf,
                      const double* sun, double I_dir, int subdiv,
                      double* out) {
    long per = 1;
    for (int l = 0; l < subdiv; ++l) per *= 4;
    V3 s = {sun[0], sun[1], sun[2]};
    std::vector<V3> TA(nf), Te1(nf), Te2(nf);
    for (long f = 0; f < nf; ++f) {
        V3 A = {tris[9 * f + 0], tris[9 * f + 1], tris[9 * f + 2]};
        V3 B = {tris[9 * f + 3], tris[9 * f + 4], tris[9 * f + 5]};
        V3 C = {tris[9 * f + 6], tris[9 * f + 7], tris[9 * f + 8]};
        TA[f] = A; Te1[f] = sub(B, A); Te2[f] = sub(C, A);
    }
#pragma omp parallel for schedule(dynamic)
    for (long f = 0; f < nf; ++f) {
        V3 n = {normals[3 * f], normals[3 * f + 1], normals[3 * f + 2]};
        double cosi = dot(n, s);
        if (cosi <= 0.0) { out[f] = 0.0; continue; }
        V3 tri[3] = {{tris[9 * f + 0], tris[9 * f + 1], tris[9 * f + 2]},
                     {tris[9 * f + 3], tris[9 * f + 4], tris[9 * f + 5]},
                     {tris[9 * f + 6], tris[9 * f + 7], tris[9 * f + 8]}};
        std::vector<V3> sub_;
        subdivide(tri, subdiv, sub_);
        double lit_area = 0.0, tot_area = 0.0;
        for (long p = 0; p < per; ++p) {
            V3 A = sub_[3 * p], B = sub_[3 * p + 1], C = sub_[3 * p + 2];
            double a = tri_area(A, B, C);
            tot_area += a;
            V3 cen = mul(add(add(A, B), C), 1.0 / 3.0);
            V3 o = add(cen, mul(n, 1e-5));
            bool shaded = false;
            for (long t = 0; t < nf; ++t) {
                if (t == f) continue;
                if (seg_hit(o, s, 1e-5, 1e30, TA[t], Te1[t], Te2[t])) {
                    shaded = true;
                    break;
                }
            }
            if (!shaded) lit_area += a;
        }
        out[f] = I_dir * cosi * lit_area / std::max(tot_area, 1e-30);
    }
}

}  // extern "C"
