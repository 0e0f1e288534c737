// czx native runtime — C++ equivalents of the reference's native (C++) layer,
// exposed over a C ABI for ctypes.
//
// Components (reference parity, re-implemented from the math / formats):
//  * czx_auto_division    — 3D block-decomposition search; the CBrick
//                           SubDomain::findOptimalDivision equivalent
//                           (reference CB_SubDomain_stub.h:255,434-491):
//                           score = (max block volume, halo surface, cubeness).
//  * czx_tdma / czx_tdma_batch — Thomas-algorithm tridiagonal solve, the
//                           sequential host oracle (reference tdma.cpp:25-69,
//                           obsolete.f90:40-166 behavior).
//  * czx_pcr              — host parallel cyclic reduction on one line
//                           (reference cz_pcr.cpp:42-96 behavior) for
//                           cross-checking the Pallas PCR stages.
//  * czx_write_sph        — SPH voxel-field dump in Fortran unformatted
//                           sequential format (fileout_t, cz_utility.f90:17-47):
//                           each record framed by int32 byte counts.
//  * czx_write_history    — bulk residual-history writer with the reference's
//                           line format "%6d, %13.6e\n" (cz_Poisson.cpp:71).
//
// Build: native/Makefile -> libczx.so ; loaded via ctypes in
// cubez_tpu/utils/native.py (which carries pure-Python fallbacks).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// --------------------------------------------------------------------------
// Domain decomposition search
// --------------------------------------------------------------------------

// Find the best (d0, d1, d2) factorization of nproc for a (g0, g1, g2) grid.
// Scoring identical to parallel/decomp.py: minimize (ceil-block volume,
// halo surface of a block, max/min extent ratio); ties prefer more division
// on the last axis, then the middle.
// Returns 0 on success, -1 if no factorization fits (axis counts < divisions).
int czx_auto_division(int64_t nproc, const int64_t g[3], int64_t out_div[3]) {
  double best_vol = 0, best_surf = 0, best_cube = 0;
  int64_t best[3] = {0, 0, 0};
  bool found = false;
  for (int64_t d0 = 1; d0 <= nproc; ++d0) {
    if (nproc % d0) continue;
    int64_t rest = nproc / d0;
    for (int64_t d1 = 1; d1 <= rest; ++d1) {
      if (rest % d1) continue;
      int64_t d2 = rest / d1;
      if (d0 > g[0] || d1 > g[1] || d2 > g[2]) continue;
      double b0 = std::ceil(double(g[0]) / d0);
      double b1 = std::ceil(double(g[1]) / d1);
      double b2 = std::ceil(double(g[2]) / d2);
      double vol = b0 * b1 * b2;
      double surf = 0;
      if (d0 > 1) surf += 2 * b1 * b2;
      if (d1 > 1) surf += 2 * b0 * b2;
      if (d2 > 1) surf += 2 * b0 * b1;
      double mx = std::max(b0, std::max(b1, b2));
      double mn = std::min(b0, std::min(b1, b2));
      double cube = mx / mn;
      bool better = false;
      if (!found) better = true;
      else if (vol != best_vol) better = vol < best_vol;
      else if (surf != best_surf) better = surf < best_surf;
      else if (cube != best_cube) better = cube < best_cube;
      else if (d2 != best[2]) better = d2 > best[2];
      else if (d1 != best[1]) better = d1 > best[1];
      if (better) {
        best_vol = vol; best_surf = surf; best_cube = cube;
        best[0] = d0; best[1] = d1; best[2] = d2;
        found = true;
      }
    }
  }
  if (!found) return -1;
  out_div[0] = best[0]; out_div[1] = best[1]; out_div[2] = best[2];
  return 0;
}

// --------------------------------------------------------------------------
// Tridiagonal host oracles
// --------------------------------------------------------------------------

// Thomas algorithm on one system  a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]
// with a[0] = c[n-1] = 0.  x overwrites d.
void czx_tdma(int64_t n, double* d, const double* a, const double* b,
              const double* c) {
  std::vector<double> cp(n), dp(n);
  cp[0] = c[0] / b[0];
  dp[0] = d[0] / b[0];
  for (int64_t i = 1; i < n; ++i) {
    double denom = b[i] - a[i] * cp[i - 1];
    cp[i] = c[i] / denom;
    dp[i] = (d[i] - a[i] * dp[i - 1]) / denom;
  }
  d[n - 1] = dp[n - 1];
  for (int64_t i = n - 2; i >= 0; --i) d[i] = dp[i] - cp[i] * d[i + 1];
}

// m independent systems laid out system-major: arrays are (m, n) row-major.
void czx_tdma_batch(int64_t m, int64_t n, double* d, const double* a,
                    const double* b, const double* c) {
  for (int64_t s = 0; s < m; ++s)
    czx_tdma(n, d + s * n, a + s * n, b + s * n, c + s * n);
}

// Parallel cyclic reduction on one unit-diagonal system
// (b == 1; the normalized form all CubeZ line solves use).
// Runs stages 1..pn-1 with zero extension, then 2x2 pair inversion.
void czx_pcr(int64_t n, double* d, const double* a_in, const double* c_in) {
  std::vector<double> a(a_in, a_in + n), c(c_in, c_in + n);
  std::vector<double> an(n), cn(n), dn(n);
  int pn = 1;
  while ((int64_t(1) << pn) <= n) ++pn;
  auto get = [n](const std::vector<double>& v, int64_t i) -> double {
    return (i < 0 || i >= n) ? 0.0 : v[i];
  };
  std::vector<double> dv(d, d + n);
  for (int p = 1; p < pn; ++p) {
    int64_t s = int64_t(1) << (p - 1);
    for (int64_t i = 0; i < n; ++i) {
      double ai = a[i], ci = c[i];
      double e = 1.0 / (1.0 - ai * get(c, i - s) - ci * get(a, i + s));
      an[i] = -e * ai * get(a, i - s);
      cn[i] = -e * ci * get(c, i + s);
      dn[i] = e * (dv[i] - ai * get(dv, i - s) - ci * get(dv, i + s));
    }
    a.swap(an); c.swap(cn); dv.swap(dn);
  }
  int64_t s = int64_t(1) << (pn - 1);
  for (int64_t i = 0; i < s && i < n; ++i) {
    double d_lo = dv[i];
    double d_hi = (i + s < n) ? dv[i + s] : 0.0;
    double a_hi = (i + s < n) ? a[i + s] : 0.0;
    double c_lo = c[i];
    double jj = 1.0 / (1.0 - a_hi * c_lo);
    d[i] = (d_lo - c_lo * d_hi) * jj;
    if (i + s < n) d[i + s] = (d_hi - a_hi * d_lo) * jj;
  }
}

// --------------------------------------------------------------------------
// SPH voxel dump (Fortran unformatted sequential, single precision)
// --------------------------------------------------------------------------

static int write_rec(FILE* f, const void* buf, int32_t nbytes) {
  if (fwrite(&nbytes, 4, 1, f) != 1) return -1;
  if (nbytes && fwrite(buf, 1, (size_t)nbytes, f) != (size_t)nbytes) return -1;
  if (fwrite(&nbytes, 4, 1, f) != 1) return -1;
  return 0;
}

// Scalar single-precision SPH file (svType=1 scalar, dType=1 float):
// records: (svType,dType) | (imax,jmax,kmax) | (xorg,yorg,zorg) |
//          (dx,dy,dz) | (step,time) | data[imax*jmax*kmax] (i fastest).
int czx_write_sph(const char* path, int32_t imax, int32_t jmax, int32_t kmax,
                  float xorg, float yorg, float zorg,
                  float dx, float dy, float dz,
                  int32_t step, float time, const float* data) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int32_t head[3] = {1, 1, 0};
  int rc = 0;
  rc |= write_rec(f, head, 8);            // svType, dType
  int32_t dims[3] = {imax, jmax, kmax};
  rc |= write_rec(f, dims, 12);
  float org[3] = {xorg, yorg, zorg};
  rc |= write_rec(f, org, 12);
  float pit[3] = {dx, dy, dz};
  rc |= write_rec(f, pit, 12);
  struct { int32_t s; float t; } st = {step, time};
  rc |= write_rec(f, &st, 8);
  int64_t nv = int64_t(imax) * jmax * kmax;
  rc |= write_rec(f, data, (int32_t)(nv * 4));
  fclose(f);
  return rc ? -1 : 0;
}

// --------------------------------------------------------------------------
// History file writer
// --------------------------------------------------------------------------

int czx_write_history(const char* path, const double* res, int64_t n) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  fprintf(f, "Itration      Residual\n");
  for (int64_t i = 0; i < n; ++i)
    fprintf(f, "%6lld, %13.6e\n", (long long)(i + 1), res[i]);
  fclose(f);
  return 0;
}

}  // extern "C"
