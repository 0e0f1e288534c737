// ref_oracle: serial re-implementation of the CubeZ reference solvers used
// ONLY to generate reference residual histories for parity tests.
//
// Why this exists: the reference's hot kernels are Fortran90 and this
// environment has no Fortran compiler, so the reference binary cannot be
// built.  This tool replicates the reference's *serial* semantics instead —
// same traversal order (j,i,k with k fastest), same accumulator precisions
// (float per-kernel partial sums cast to double, or double where the
// reference uses double), same update formulas, same stopping rule — and is
// compiled with g++.  Serial execution is the reference's canonical
// behavior: its OpenMP psor/pcr are racy (in-place updates), so only the
// serial order defines a deterministic answer.
//
// Reference provenance (all /root/reference):
//   BC profile           src/cz_f90/cz_solver.f90:22-191  (bc_k)
//   jacobi               src/cz_f90/cz_solver.f90:284-387
//   psor                 src/cz_f90/cz_solver.f90:207-269  (serial = lexicographic GS)
//   psor2sma_core        src/cz_f90/cz_solver.f90:404-493
//   pcr  (line-GS)       src/cz_f90/cz_solver.f90:666-878  (stages pn-2, 4x4 Cramer)
//   pcr_rb               src/cz_f90/cz_solver.f90:497-662  (stages pn-1, 2x2)
//   pcr_j_esa            src/cz_f90/cz_solver.f90:1473-1676 (zero-extended, 2x2)
//   PBiCGSTAB            src/cz_cpp/cz_Poisson.cpp:332-504
//   Preconditioner       src/cz_cpp/cz_Poisson.cpp:273-322 (8 fixed sweeps)
//   psor_maf             src/cz_f90/cz_maf.f90:23-114   (metrics per point)
//   jacobi_maf           src/cz_f90/cz_maf.f90:131-282
//   psor2sma_core_maf    src/cz_f90/cz_maf.f90:301-438
//   pcr_rb_maf           src/cz_f90/cz_maf.f90:442-668  (variable tridiag, 2x2)
//   pcr_maf              src/cz_f90/cz_maf.f90:672-892  (line-GS, 2x2 final —
//                        unlike const pcr's 4x4; eda/esa MAF variants are the
//                        same math with different work-array storage)
//   calc_rk_maf/ax_maf   src/cz_f90/cz_blas.f90:738-936 (pvt row scaling)
//   search_pivot         src/cz_f90/cz_blas.f90:947-1039
//   coordinates          src/cz_cpp/cz_Evaluate.cpp:88,342-363 (uniform
//                        xc[i] = (i-1)*pitch in REAL_TYPE; metrics depend on
//                        coordinate DIFFERENCES only, so the driver's one-cell
//                        index shift vs bc_k's x=(i-1)*dh is invisible)
//   driver/stop rule     src/cz_cpp/cz_Poisson.cpp:39-79, eps=1e-5 (cz.h:162)
//   exact solution       src/cz_f90/cz_utility.f90:52-82
//
// Usage: ref_oracle N solver itmax omega [precond] [--fp64] [--eps E] [--out F]
//                   [--plane-partials]
// Writes "<solver>.txt" history rows "%6d, %13.6e" (cz_Poisson.cpp:71) and
// prints "iters=... res=... errmax=..." on stdout.
//
// --plane-partials (sor2sma): one float residual partial per j-plane, added
// in double in plane order, instead of one float partial per color.  The
// reference's OpenMP build keeps one float partial per thread; this is the
// limit of one thread per plane.  The field arithmetic is unchanged (nodes
// of one color never neighbour each other), only the residual's rounding:
// a single float accumulator over the ~6.6e7 nodes of a 512^3 color adds
// terms far below its ulp and undercounts the sum.  Compiled with -fopenmp
// the planes run in parallel; the result does not depend on it.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

bool g_plane_partials = false;  // --plane-partials

template <typename Real>
struct Field {
  int n;            // nodes per axis (cube)
  std::vector<Real> v;  // index [(j*n + i)*n + k] — k fastest, like Fortran (k,i,j)
  explicit Field(int n_) : n(n_), v(static_cast<size_t>(n_) * n_ * n_, Real(0)) {}
  Real& at(int k, int i, int j) { return v[(static_cast<size_t>(j) * n + i) * n + k]; }
  const Real& at(int k, int i, int j) const {
    return v[(static_cast<size_t>(j) * n + i) * n + k];
  }
};

template <typename Real>
void apply_bc(Field<Real>& p, double dh) {
  // bc_k: sin(pi x) sin(pi y) on both K faces, 0 on I/J walls
  // (cz_solver.f90:42-186); x = dh*(i-1) 1-based == dh*i 0-based.
  const int n = p.n;
  const double pi = 2.0 * std::asin(1.0);
  for (int j = 0; j < n; ++j)
    for (int i = 0; i < n; ++i) {
      Real val = static_cast<Real>(std::sin(pi * dh * i) * std::sin(pi * dh * j));
      p.at(0, i, j) = val;
      p.at(n - 1, i, j) = val;
    }
  for (int j = 0; j < n; ++j)
    for (int k = 0; k < n; ++k) {
      p.at(k, 0, j) = Real(0);
      p.at(k, n - 1, j) = Real(0);
    }
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < n; ++k) {
      p.at(k, i, 0) = Real(0);
      p.at(k, i, n - 1) = Real(0);
    }
}

// ---- point sweeps ---------------------------------------------------------

template <typename Real>
double jacobi_sweep(Field<Real>& p, const Field<Real>& b, Field<Real>& wk,
                    Real omg) {
  // cz_solver.f90:284-387: write wk2, accumulate dp^2 in REAL, copy back.
  const int n = p.n;
  const Real r6 = Real(1) / Real(6);
  Real res1 = 0;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) {
        Real pp = p.at(k, i, j);
        Real ss = p.at(k, i + 1, j) + p.at(k, i - 1, j) + p.at(k, i, j + 1) +
                  p.at(k, i, j - 1) + p.at(k + 1, i, j) + p.at(k - 1, i, j);
        Real dp = ((ss - b.at(k, i, j)) * r6 - pp) * omg;
        wk.at(k, i, j) = pp + dp;
        res1 += dp * dp;
      }
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) p.at(k, i, j) = wk.at(k, i, j);
  return static_cast<double>(res1);
}

template <typename Real>
double psor_sweep(Field<Real>& p, const Field<Real>& b, Real omg) {
  // cz_solver.f90:207-269: in-place; serial j,i,k order = true Gauss-Seidel.
  const int n = p.n;
  const Real r6 = Real(1) / Real(6);
  Real res1 = 0;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) {
        Real pp = p.at(k, i, j);
        Real ss = p.at(k, i + 1, j) + p.at(k, i - 1, j) + p.at(k, i, j + 1) +
                  p.at(k, i, j - 1) + p.at(k + 1, i, j) + p.at(k - 1, i, j);
        Real dp = ((ss - b.at(k, i, j)) * r6 - pp) * omg;
        p.at(k, i, j) = pp + dp;
        res1 += dp * dp;
      }
  return static_cast<double>(res1);
}

template <typename Real>
double sor2sma_sweep(Field<Real>& p, const Field<Real>& b, Real omg) {
  // psor2sma_core (cz_solver.f90:404-493), both colors; serial ip = 0
  // (cz_Poisson.cpp:174-186).  1-based k starts at kst+mod(i+j+color,2).
  const int n = p.n;
  const Real r6 = Real(1) / Real(6);
  double res = 0.0;
  std::vector<Real> plane(n + 1, Real(0));  // --plane-partials, by 1-based j
  for (int color = 0; color < 2; ++color) {
    Real res1 = 0;
    if (g_plane_partials) {
#pragma omp parallel for schedule(static)
      for (int j1 = 2; j1 <= n - 1; ++j1) {
        Real rj = 0;
        for (int i1 = 2; i1 <= n - 1; ++i1) {
          int k1st = 2 + (i1 + j1 + color) % 2;
          for (int k1 = k1st; k1 <= n - 1; k1 += 2) {
            int i = i1 - 1, j = j1 - 1, k = k1 - 1;
            Real pp = p.at(k, i, j);
            Real ss = p.at(k, i + 1, j) + p.at(k, i - 1, j) +
                      p.at(k, i, j + 1) + p.at(k, i, j - 1) +
                      p.at(k + 1, i, j) + p.at(k - 1, i, j);
            Real dp = ((ss - b.at(k, i, j)) * r6 - pp) * omg;
            p.at(k, i, j) = pp + dp;
            rj += dp * dp;
          }
        }
        plane[j1] = rj;
      }
      for (int j1 = 2; j1 <= n - 1; ++j1) res += static_cast<double>(plane[j1]);
      continue;
    }
    for (int j1 = 2; j1 <= n - 1; ++j1)      // 1-based loops to keep the
      for (int i1 = 2; i1 <= n - 1; ++i1) {  // parity formula literal
        int k1st = 2 + (i1 + j1 + color) % 2;
        for (int k1 = k1st; k1 <= n - 1; k1 += 2) {
          int i = i1 - 1, j = j1 - 1, k = k1 - 1;
          Real pp = p.at(k, i, j);
          Real ss = p.at(k, i + 1, j) + p.at(k, i - 1, j) + p.at(k, i, j + 1) +
                    p.at(k, i, j - 1) + p.at(k + 1, i, j) + p.at(k - 1, i, j);
          Real dp = ((ss - b.at(k, i, j)) * r6 - pp) * omg;
          p.at(k, i, j) = pp + dp;
          res1 += dp * dp;
        }
      }
    res += static_cast<double>(res1);
  }
  return res;
}

// ---- line (PCR) sweeps ----------------------------------------------------

inline int num_stage(int m) {  // getNumStage: smallest pn with 2^pn > m (cz.h:293-300)
  int pn = 0;
  while ((1 << pn) <= m) ++pn;
  return pn;
}

// Work arrays for one K line, 0-based over inner k in [0, m); index helpers
// clamp like the reference's max/min with zero ghosts (reference reads its
// kst-1/ked+1 entries which hold 0 in pcr and are zero-extended in *_esa).
struct LineWork {
  std::vector<double> a, c, d, a1, c1, d1;  // double slots; store Real values
};

// One line solve exactly as reference pcr_rb / pcr_j_esa: stages 1..pn-1,
// final 2x2 (cz_solver.f90:583-630, 1594-1633).  Template on Real: every
// arithmetic op is rounded to Real to mirror the float build.
template <typename Real>
void pcr_line_2x2(std::vector<Real>& a, std::vector<Real>& c,
                  std::vector<Real>& d, std::vector<Real>& a1,
                  std::vector<Real>& c1, std::vector<Real>& d1, int m, int pn) {
  auto A = [&](int k) { return (k < 0 || k >= m) ? Real(0) : a[k]; };
  auto C = [&](int k) { return (k < 0 || k >= m) ? Real(0) : c[k]; };
  auto D = [&](int k) { return (k < 0 || k >= m) ? Real(0) : d[k]; };
  for (int p = 1; p <= pn - 1; ++p) {
    int s = 1 << (p - 1);
    for (int k = 0; k < m; ++k) {
      Real ap = a[k], cp = c[k];
      Real e = Real(1) / (Real(1) - ap * C(k - s) - cp * A(k + s));
      a1[k] = -e * ap * A(k - s);
      c1[k] = -e * cp * C(k + s);
      d1[k] = e * (d[k] - ap * D(k - s) - cp * D(k + s));
    }
    for (int k = 0; k < m; ++k) { a[k] = a1[k]; c[k] = c1[k]; d[k] = d1[k]; }
  }
  int s = 1 << (pn - 1);
  for (int k = 0; k < s && k < m; ++k) {
    Real cc1 = c[k], aa2 = A(k + s), f1 = d[k], f2 = D(k + s);
    Real jj = Real(1) / (Real(1) - aa2 * cc1);
    d1[k] = (f1 - cc1 * f2) * jj;
    if (k + s < m) d1[k + s] = (f2 - aa2 * f1) * jj;
  }
}

// Full-plane pcr final form: stages 1..pn-2 then 4x4 Cramer
// (cz_solver.f90:757-844).
template <typename Real>
void pcr_line_4x4(std::vector<Real>& a, std::vector<Real>& c,
                  std::vector<Real>& d, std::vector<Real>& a1,
                  std::vector<Real>& c1, std::vector<Real>& d1, int m, int pn) {
  auto A = [&](int k) { return (k < 0 || k >= m) ? Real(0) : a[k]; };
  auto C = [&](int k) { return (k < 0 || k >= m) ? Real(0) : c[k]; };
  auto D = [&](int k) { return (k < 0 || k >= m) ? Real(0) : d[k]; };
  for (int p = 1; p <= pn - 2; ++p) {
    int s = 1 << (p - 1);
    for (int k = 0; k < m; ++k) {
      Real ap = a[k], cp = c[k];
      Real e = Real(1) / (Real(1) - ap * C(k - s) - cp * A(k + s));
      a1[k] = -e * ap * A(k - s);
      c1[k] = -e * cp * C(k + s);
      d1[k] = e * (d[k] - ap * D(k - s) - cp * D(k + s));
    }
    for (int k = 0; k < m; ++k) { a[k] = a1[k]; c[k] = c1[k]; d[k] = d1[k]; }
  }
  int s = 1 << (pn - 2);
  for (int k = 0; k < s && k < m; ++k) {
    int kl = k + s, km = k + 2 * s, kr = k + 3 * s;  // clamped reads via A/C/D
    Real cc1 = C(k), cc2 = C(kl), cc3 = C(km);
    Real aa2 = A(kl), aa3 = A(km), aa4 = A(kr);
    Real dd1 = D(k), dd2 = D(kl), dd3 = D(km), dd4 = D(kr);
    Real inv_detA = Real(1) / (Real(1) - aa4 * cc3 - aa3 * cc2 -
                               aa2 * cc1 * (Real(1) - cc3 * aa4));
    Real detA1 = -cc3 * (aa4 * dd1 + cc1 * cc2 * dd4 - aa4 * cc1 * dd2) + dd1 +
                 cc1 * cc2 * dd3 - aa3 * cc2 * dd1 - cc1 * dd2;
    Real detA2 = dd2 + cc2 * cc3 * dd4 - aa4 * cc3 * dd2 - cc2 * dd3 -
                 aa2 * (dd1 - aa4 * cc3 * dd1);
    Real detA3 = dd3 - cc3 * dd4 - aa3 * dd2 -
                 aa2 * (cc1 * dd3 - cc1 * cc3 * dd4 - aa3 * dd1);
    Real detA4 = dd4 + aa3 * aa4 * dd2 - aa4 * dd3 - aa3 * cc2 * dd4 -
                 aa2 * (cc1 * dd4 + aa3 * aa4 * dd1 - aa4 * cc1 * dd3);
    d1[k] = detA1 * inv_detA;
    if (kl < m) d1[kl] = detA2 * inv_detA;
    if (km < m) d1[km] = detA3 * inv_detA;
    if (kr < m) d1[kr] = detA4 * inv_detA;
  }
}

// Build the line RHS for line (i,j) from the CURRENT x (cz_solver.f90:566-579).
template <typename Real>
void build_line(const Field<Real>& x, const Field<Real>& b, int i, int j,
                std::vector<Real>& a, std::vector<Real>& c,
                std::vector<Real>& d) {
  const int n = x.n, m = n - 2;
  const Real r6 = Real(1) / Real(6);
  for (int k = 0; k < m; ++k) {
    a[k] = (k == 0) ? Real(0) : -r6;
    c[k] = (k == m - 1) ? Real(0) : -r6;
    d[k] = (x.at(k + 1, i, j - 1) + x.at(k + 1, i, j + 1) +
            x.at(k + 1, i - 1, j) + x.at(k + 1, i + 1, j) -
            b.at(k + 1, i, j)) * r6;
  }
  d[0] = d[0] + x.at(0, i, j) * r6;           // BC fold (cz_solver.f90:578-579)
  d[m - 1] = d[m - 1] + x.at(n - 1, i, j) * r6;
}

enum class LineMode { GS, RB, JACOBI };

template <typename Real>
double line_sweep(Field<Real>& x, const Field<Real>& b, Real omg,
                  LineMode mode) {
  const int n = x.n, m = n - 2;
  const int pn = num_stage(m);
  std::vector<Real> a(m), c(m), d(m), a1(m), c1(m), d1(m);
  double res = 0.0;

  if (mode == LineMode::JACOBI) {
    // pcr_j_esa: transverse source from OLD x for every line, then update
    // (cz_solver.f90:1521-1531, 1659-1665); res1 accumulates in Real.
    Field<Real> src(n);
    const Real r6 = Real(1) / Real(6);
    for (int j = 1; j <= n - 2; ++j)
      for (int i = 1; i <= n - 2; ++i)
        for (int k = 1; k <= n - 2; ++k)
          src.at(k, i, j) = (x.at(k, i, j - 1) + x.at(k, i, j + 1) +
                             x.at(k, i - 1, j) + x.at(k, i + 1, j) -
                             b.at(k, i, j)) * r6;
    Field<Real> wrk(n);
    Real res1 = 0;
    for (int j = 1; j <= n - 2; ++j)
      for (int i = 1; i <= n - 2; ++i) {
        for (int k = 0; k < m; ++k) {
          a[k] = (k == 0) ? Real(0) : Real(-1.0 / 6.0);
          c[k] = (k == m - 1) ? Real(0) : Real(-1.0 / 6.0);
          d[k] = src.at(k + 1, i, j);
        }
        d[0] = d[0] + x.at(0, i, j) * r6;
        d[m - 1] = d[m - 1] + x.at(n - 1, i, j) * r6;
        pcr_line_2x2(a, c, d, a1, c1, d1, m, pn);
        for (int k = 0; k < m; ++k) {
          Real pp = x.at(k + 1, i, j);
          Real dp = (d1[k] - pp) * omg;
          wrk.at(k + 1, i, j) = pp + dp;
          res1 += dp * dp;
        }
      }
    for (int j = 1; j <= n - 2; ++j)
      for (int i = 1; i <= n - 2; ++i)
        for (int k = 1; k <= n - 2; ++k) x.at(k, i, j) = wrk.at(k, i, j);
    return static_cast<double>(res1);
  }

  if (mode == LineMode::GS) {
    // full-plane pcr: in-place over lexicographic (j,i) = line-Gauss-Seidel
    // in serial execution (relax inside the ij loop, cz_solver.f90:848-856);
    // res1 accumulates in Real.
    Real res1 = 0;
    for (int j = 1; j <= n - 2; ++j)
      for (int i = 1; i <= n - 2; ++i) {
        build_line(x, b, i, j, a, c, d);
        pcr_line_4x4(a, c, d, a1, c1, d1, m, pn);
        for (int k = 0; k < m; ++k) {
          Real pp = x.at(k + 1, i, j);
          Real dp = (d1[k] - pp) * omg;
          x.at(k + 1, i, j) = pp + dp;
          res1 += dp * dp;
        }
      }
    return static_cast<double>(res1);
  }

  // RB: two colors by 1-based (i+j) parity == color (cz_solver.f90:549);
  // res accumulates DIRECTLY in double (cz_solver.f90:645-647).
  for (int color = 0; color < 2; ++color)
    for (int j1 = 2; j1 <= n - 1; ++j1)
      for (int i1 = 2; i1 <= n - 1; ++i1) {
        if ((i1 + j1) % 2 != color) continue;
        int i = i1 - 1, j = j1 - 1;
        build_line(x, b, i, j, a, c, d);
        pcr_line_2x2(a, c, d, a1, c1, d1, m, pn);
        for (int k = 0; k < m; ++k) {
          Real pp = x.at(k + 1, i, j);
          Real dp = (d1[k] - pp) * omg;
          x.at(k + 1, i, j) = pp + dp;
          res += static_cast<double>(dp) * static_cast<double>(dp);
        }
      }
  return res;
}

// ---- BiCGSTAB -------------------------------------------------------------

template <typename Real>
Real dot2(const Field<Real>& p, const Field<Real>& q) {
  // blas_dot2: Real accumulator, j,i,k order (cz_blas.f90:386-437)
  const int n = p.n;
  Real r = 0;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) r += p.at(k, i, j) * q.at(k, i, j);
  return r;
}

template <typename Real>
Real dot1(const Field<Real>& p) {
  const int n = p.n;
  Real r = 0;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) {
        Real q = p.at(k, i, j);
        r += q * q;
      }
  return r;
}

template <typename Real>
void calc_ax(Field<Real>& ap, const Field<Real>& p) {
  // blas_calc_ax: ap = sum(nb) - 6 p on inner (cz_blas.f90:579-644)
  const int n = p.n;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k)
        ap.at(k, i, j) = p.at(k, i + 1, j) + p.at(k, i - 1, j) +
                         p.at(k, i, j + 1) + p.at(k, i, j - 1) +
                         p.at(k + 1, i, j) + p.at(k - 1, i, j) -
                         Real(6) * p.at(k, i, j);
}

template <typename Real>
void calc_rk(Field<Real>& r, const Field<Real>& x, const Field<Real>& b) {
  const int n = x.n;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k)
        r.at(k, i, j) = b.at(k, i, j) -
                        (x.at(k, i + 1, j) + x.at(k, i - 1, j) +
                         x.at(k, i, j + 1) + x.at(k, i, j - 1) +
                         x.at(k + 1, i, j) + x.at(k - 1, i, j) -
                         Real(6) * x.at(k, i, j));
}

// ---- MAF (matrix-assembly-free variable-coefficient) family ---------------
//
// The driver initializes UNIFORM coordinates xc[i] = (i-1)*pitch in REAL_TYPE
// (cz_Evaluate.cpp:88,342-363) and every MAF kernel recomputes the metric
// terms from them per point in REAL_TYPE arithmetic (cz_maf.f90).  On the
// uniform grid the MAF operator is numerically ~= the constant-coefficient
// one, but the f32 metric arithmetic (i*pitch differences, reciprocals)
// perturbs each coefficient by ulps, so the residual histories are distinct
// — these sweeps reproduce that arithmetic literally.

template <typename Real>
std::vector<Real> make_coords(int n) {
  // pitch = 1.0/(REAL_TYPE)(n-1); xc[i] = (REAL_TYPE)(i-1)*pitch
  // (cz_Evaluate.cpp:88,344).  0-based node q <-> Fortran node q+1; only
  // differences of entries are ever used, so the constant shift drops out.
  Real pitch = static_cast<Real>(1.0 / static_cast<Real>(n - 1));
  std::vector<Real> x(n);
  for (int q = 0; q < n; ++q) x[q] = static_cast<Real>(q) * pitch;
  return x;
}

template <typename Real>
struct MafW {  // the seven row coefficients at one point
  Real wxp, wxm, wyp, wym, wzp, wzm, dd;
};

// Literal transliteration of the psor_maf metric block (cz_maf.f90:68-94);
// identical block in jacobi_maf/psor2sma_core_maf/calc_*_maf/search_pivot.
template <typename Real>
inline MafW<Real> maf_point_metrics(const std::vector<Real>& X,
                                    const std::vector<Real>& Y,
                                    const std::vector<Real>& Z, int i, int j,
                                    int k) {
  const Real half = Real(0.5);
  Real XG = half * (X[i + 1] - X[i - 1]);
  Real YE = half * (Y[j + 1] - Y[j - 1]);
  Real ZT = half * (Z[k + 1] - Z[k - 1]);
  Real XGG = X[i + 1] - Real(2) * X[i] + X[i - 1];
  Real YEE = Y[j + 1] - Real(2) * Y[j] + Y[j - 1];
  Real ZTT = Z[k + 1] - Real(2) * Z[k] + Z[k - 1];
  Real YJA = XG * YE * ZT;
  Real YJAI = Real(1) / YJA;
  Real GX = YE * ZT * YJAI;
  Real EY = XG * ZT * YJAI;
  Real TZ = XG * YE * YJAI;
  Real C1 = GX * GX, C2 = EY * EY, C3 = TZ * TZ;
  Real C7 = -XGG * C1 * GX;
  Real C8 = -YEE * C2 * EY;
  Real C9 = -ZTT * C3 * TZ;
  return {C1 + half * C7, C1 - half * C7, C2 + half * C8, C2 - half * C8,
          C3 + half * C9, C3 - half * C9, Real(2) * (C1 + C2 + C3)};
}

template <typename Real>
struct MafCtx {
  std::vector<Real> X, Y, Z;
  explicit MafCtx(int n) : X(make_coords<Real>(n)), Y(X), Z(X) {}
};

// rp = sum(w_nb * p_nb) + bb; dp = (rp/dd - pp)*omg (cz_maf.f90:94-105).
// Note the "+ bb" sign — opposite to the const family's (ss - b); inner RHS
// is zero in this benchmark so both conventions solve the same problem.
template <typename Real>
inline Real maf_dp(const Field<Real>& p, const Field<Real>& b,
                   const MafCtx<Real>& mc, int i, int j, int k, Real omg) {
  MafW<Real> w = maf_point_metrics(mc.X, mc.Y, mc.Z, i, j, k);
  Real rp = w.wxp * p.at(k, i + 1, j) + w.wxm * p.at(k, i - 1, j) +
            w.wyp * p.at(k, i, j + 1) + w.wym * p.at(k, i, j - 1) +
            w.wzp * p.at(k + 1, i, j) + w.wzm * p.at(k - 1, i, j) +
            b.at(k, i, j);
  return (rp / w.dd - p.at(k, i, j)) * omg;
}

template <typename Real>
double psor_maf_sweep(Field<Real>& p, const Field<Real>& b,
                      const MafCtx<Real>& mc, Real omg) {
  // cz_maf.f90:23-114: in-place, serial j,i,k order; res1 is REAL.
  const int n = p.n;
  Real res1 = 0;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) {
        Real dp = maf_dp(p, b, mc, i, j, k, omg);
        p.at(k, i, j) += dp;
        res1 += dp * dp;
      }
  return static_cast<double>(res1);
}

template <typename Real>
double jacobi_maf_sweep(Field<Real>& p, const Field<Real>& b,
                        const MafCtx<Real>& mc, Field<Real>& wk, Real omg) {
  // cz_maf.f90:131-282: write wk2, copy back; res1 REAL (non-SVR build).
  const int n = p.n;
  Real res1 = 0;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) {
        Real dp = maf_dp(p, b, mc, i, j, k, omg);
        wk.at(k, i, j) = p.at(k, i, j) + dp;
        res1 += dp * dp;
      }
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) p.at(k, i, j) = wk.at(k, i, j);
  return static_cast<double>(res1);
}

template <typename Real>
double sor2sma_maf_sweep(Field<Real>& p, const Field<Real>& b,
                         const MafCtx<Real>& mc, Real omg) {
  // psor2sma_core_maf both colors (cz_maf.f90:301-438), serial ip = 0;
  // per-color res1 REAL, accumulated into double between colors.
  const int n = p.n;
  double res = 0.0;
  for (int color = 0; color < 2; ++color) {
    Real res1 = 0;
    for (int j1 = 2; j1 <= n - 1; ++j1)
      for (int i1 = 2; i1 <= n - 1; ++i1) {
        int k1st = 2 + (i1 + j1 + color) % 2;
        for (int k1 = k1st; k1 <= n - 1; k1 += 2) {
          int i = i1 - 1, j = j1 - 1, k = k1 - 1;
          Real dp = maf_dp(p, b, mc, i, j, k, omg);
          p.at(k, i, j) += dp;
          res1 += dp * dp;
        }
      }
    res += static_cast<double>(res1);
  }
  return res;
}

// Variable-tridiagonal line construction for line (i,j)
// (pcr_rb_maf, cz_maf.f90:519-572).  msk == 1 on every inner node of the
// cube problem, so the msk factors reduce to 1 here.
template <typename Real>
void build_line_maf(const Field<Real>& x, const Field<Real>& b,
                    const MafCtx<Real>& mc, int i, int j, std::vector<Real>& a,
                    std::vector<Real>& c, std::vector<Real>& d,
                    std::vector<Real>& c3, std::vector<Real>& c9,
                    std::vector<Real>& w) {
  const int n = x.n, m = n - 2;
  const Real half = Real(0.5);
  const std::vector<Real>& X = mc.X;
  const std::vector<Real>& Y = mc.Y;
  const std::vector<Real>& Z = mc.Z;
  Real GX = Real(2) / (X[i + 1] - X[i - 1]);
  Real EY = Real(2) / (Y[j + 1] - Y[j - 1]);
  Real C1 = GX * GX, C2 = EY * EY;
  Real C7 = -(X[i + 1] - Real(2) * X[i] + X[i - 1]) * C1 * GX;
  Real C8 = -(Y[j + 1] - Real(2) * Y[j] + Y[j - 1]) * C2 * EY;
  Real dd1 = C1 + half * C7;  // weight of x(i+1)
  Real dd2 = C1 - half * C7;
  Real cc1 = C2 + half * C8;  // weight of x(j+1)
  Real cc2 = C2 - half * C8;
  for (int kk = 0; kk < m; ++kk) {  // cz_maf.f90:533-540
    int k = kk + 1;
    Real f1 = Z[k + 1], f2 = Z[k - 1];
    Real TZ = Real(2) / (f1 - f2);
    Real ZTT = f1 - Real(2) * Z[k] + f2;
    Real f3 = TZ * TZ;
    c3[kk] = f3;
    c9[kk] = -ZTT * f3 * TZ;
    w[kk] = half / (C1 + C2 + f3);  // 1/R7 diagonal normalizer
  }
  a[0] = 0;
  c[0] = -(c3[0] + half * c9[0]) * w[0];
  for (int kk = 1; kk < m - 1; ++kk) {
    a[kk] = -(c3[kk] - half * c9[kk]) * w[kk];
    c[kk] = -(c3[kk] + half * c9[kk]) * w[kk];
  }
  a[m - 1] = -(c3[m - 1] - half * c9[m - 1]) * w[m - 1];
  c[m - 1] = 0;
  for (int kk = 0; kk < m; ++kk) {  // source (cz_maf.f90:558-566)
    int k = kk + 1;
    d[kk] = (dd1 * x.at(k, i + 1, j) + dd2 * x.at(k, i - 1, j) +
             cc1 * x.at(k, i, j + 1) + cc2 * x.at(k, i, j - 1) -
             b.at(k, i, j)) * w[kk];
  }
  // BC fold with the true z-weights (cz_maf.f90:571-572)
  d[0] = d[0] + (c3[0] - half * c9[0]) * w[0] * x.at(0, i, j);
  d[m - 1] = d[m - 1] + (c3[m - 1] + half * c9[m - 1]) * w[m - 1] *
                            x.at(n - 1, i, j);
}

template <typename Real>
double line_sweep_maf(Field<Real>& x, const Field<Real>& b,
                      const MafCtx<Real>& mc, Real omg, LineMode mode) {
  // pcr_rb_maf (RB colors) / pcr_maf (lexicographic = line-GS in serial
  // order).  BOTH stop at stage pn-1 with a 2x2 final — unlike const pcr's
  // pn-2 + 4x4 Cramer (cz_maf.f90:577-624, 803-849).  res1 is REAL for both
  // (cz_maf.f90:457,686 declare `real res1`), unlike const pcr_rb's double.
  const int n = x.n, m = n - 2;
  const int pn = num_stage(m);
  std::vector<Real> a(m), c(m), d(m), a1(m), c1(m), d1(m);
  std::vector<Real> c3(m), c9(m), w(m);
  Real res1 = 0;
  if (mode == LineMode::GS) {
    for (int j = 1; j <= n - 2; ++j)
      for (int i = 1; i <= n - 2; ++i) {
        build_line_maf(x, b, mc, i, j, a, c, d, c3, c9, w);
        pcr_line_2x2(a, c, d, a1, c1, d1, m, pn);
        for (int k = 0; k < m; ++k) {
          Real pp = x.at(k + 1, i, j);
          Real dp = (d1[k] - pp) * omg;
          x.at(k + 1, i, j) = pp + dp;
          res1 += dp * dp;
        }
      }
    return static_cast<double>(res1);
  }
  for (int color = 0; color < 2; ++color)
    for (int j1 = 2; j1 <= n - 1; ++j1)
      for (int i1 = 2; i1 <= n - 1; ++i1) {
        if ((i1 + j1) % 2 != color) continue;
        int i = i1 - 1, j = j1 - 1;
        build_line_maf(x, b, mc, i, j, a, c, d, c3, c9, w);
        pcr_line_2x2(a, c, d, a1, c1, d1, m, pn);
        for (int k = 0; k < m; ++k) {
          Real pp = x.at(k + 1, i, j);
          Real dp = (d1[k] - pp) * omg;
          x.at(k + 1, i, j) = pp + dp;
          res1 += dp * dp;
        }
      }
  return static_cast<double>(res1);
}

// pvt = 1/max|row coefficient| on inner nodes (search_pivot,
// cz_blas.f90:947-1039); boundary/halo entries stay 0 (zero-init alloc).
template <typename Real>
void search_pivot(Field<Real>& pvt, const MafCtx<Real>& mc) {
  const int n = pvt.n;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) {
        MafW<Real> wv = maf_point_metrics(mc.X, mc.Y, mc.Z, i, j, k);
        Real ss = std::fabs(wv.wxp);
        ss = std::max(ss, std::fabs(wv.wxm));
        ss = std::max(ss, std::fabs(wv.wyp));
        ss = std::max(ss, std::fabs(wv.wym));
        ss = std::max(ss, std::fabs(wv.wzp));
        ss = std::max(ss, std::fabs(wv.wzm));
        ss = std::max(ss, std::fabs(wv.dd));
        pvt.at(k, i, j) = Real(1) / ss;
      }
}

template <typename Real>
void calc_ax_maf(Field<Real>& ap, const Field<Real>& p, const MafCtx<Real>& mc,
                 const Field<Real>& pvt) {
  // ap = (sum w_nb p_nb - dd p) * pvt (cz_blas.f90:845-936)
  const int n = p.n;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) {
        MafW<Real> w = maf_point_metrics(mc.X, mc.Y, mc.Z, i, j, k);
        ap.at(k, i, j) =
            (w.wxp * p.at(k, i + 1, j) + w.wxm * p.at(k, i - 1, j) +
             w.wyp * p.at(k, i, j + 1) + w.wym * p.at(k, i, j - 1) +
             w.wzp * p.at(k + 1, i, j) + w.wzm * p.at(k - 1, i, j) -
             w.dd * p.at(k, i, j)) *
            pvt.at(k, i, j);
      }
}

template <typename Real>
void calc_rk_maf(Field<Real>& r, const Field<Real>& x, const Field<Real>& b,
                 const MafCtx<Real>& mc, const Field<Real>& pvt) {
  // r = (b + dd x - sum w_nb x_nb) * pvt (cz_blas.f90:738-831)
  const int n = x.n;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) {
        MafW<Real> w = maf_point_metrics(mc.X, mc.Y, mc.Z, i, j, k);
        r.at(k, i, j) =
            (b.at(k, i, j) + w.dd * x.at(k, i, j) -
             w.wxp * x.at(k, i + 1, j) - w.wxm * x.at(k, i - 1, j) -
             w.wyp * x.at(k, i, j + 1) - w.wym * x.at(k, i, j - 1) -
             w.wzp * x.at(k + 1, i, j) - w.wzm * x.at(k - 1, i, j)) *
            pvt.at(k, i, j);
      }
}

template <typename Real>
void precondition(Field<Real>& xx, const Field<Real>& bb, const std::string& pc,
                  Real omg, Field<Real>& wk) {
  // 8 fixed sweeps from xx = 0, no convergence check, no bc_k
  // (cz_Poisson.cpp:273-322; blas_clear before each call, :404-410)
  std::fill(xx.v.begin(), xx.v.end(), Real(0));
  if (pc == "none" || pc == "copy") { xx.v = bb.v; return; }
  for (int it = 0; it < 8; ++it) {
    if (pc == "jacobi") jacobi_sweep(xx, bb, wk, omg);
    else if (pc == "psor") psor_sweep(xx, bb, omg);
    else if (pc == "sor2sma") sor2sma_sweep(xx, bb, omg);
    else if (pc == "pcr") line_sweep(xx, bb, omg, LineMode::GS);
    else if (pc == "pcr_rb") line_sweep(xx, bb, omg, LineMode::RB);
    else if (pc == "pcr_j_esa") line_sweep(xx, bb, omg, LineMode::JACOBI);
    else { std::fprintf(stderr, "unknown precond %s\n", pc.c_str()); std::exit(2); }
  }
}

template <typename Real>
void precondition_maf(Field<Real>& xx, const Field<Real>& bb,
                      const std::string& pc, Real omg, Field<Real>& wk,
                      const MafCtx<Real>& mc) {
  // Preconditioner dispatches MAF types to the MAF sweeps with the same
  // fixed 8 inner iterations (cz_Poisson.cpp:273-322).
  std::fill(xx.v.begin(), xx.v.end(), Real(0));
  if (pc == "none" || pc == "copy") { xx.v = bb.v; return; }
  for (int it = 0; it < 8; ++it) {
    if (pc == "jacobi_maf") jacobi_maf_sweep(xx, bb, mc, wk, omg);
    else if (pc == "psor_maf") psor_maf_sweep(xx, bb, mc, omg);
    else if (pc == "sor2sma_maf") sor2sma_maf_sweep(xx, bb, mc, omg);
    else if (pc == "pcr_maf") line_sweep_maf(xx, bb, mc, omg, LineMode::GS);
    else if (pc == "pcr_rb_maf") line_sweep_maf(xx, bb, mc, omg, LineMode::RB);
    else { std::fprintf(stderr, "unknown maf precond %s\n", pc.c_str()); std::exit(2); }
  }
}

}  // namespace

template <typename Real>
int run(int n, const std::string& solver, int itmax, double omega,
        const std::string& precond, double eps, const std::string& outpath) {
  const double dh = 1.0 / (n - 1);
  const long n_inner = static_cast<long>(n - 2) * (n - 2) * (n - 2);
  const double res_normal = 1.0 / static_cast<double>(n_inner);
  const Real omg = static_cast<Real>(omega);

  Field<Real> p(n), b(n), wk(n);
  apply_bc(p, dh);
  apply_bc(b, dh);  // reference writes the BC profile onto RHS boundary too
                    // (cz_Evaluate.cpp:381-386); inner rhs stays zero.

  std::FILE* fh = std::fopen(outpath.c_str(), "w");
  std::fprintf(fh, "Itration      Residual\n");

  int itr = 0;
  double res = 0.0;

  const bool maf = solver.size() > 4 &&
                   solver.compare(solver.size() - 4, 4, "_maf") == 0;
  MafCtx<Real> mc(maf ? n : 2);  // coords only built/used for MAF runs

  if (solver == "pbicgstab_maf") {
    // PBiCGSTAB with calc_rk_maf/calc_ax_maf + pvt row scaling
    // (cz_Poisson.cpp:348-358, 412-423, 448-459); identical loop otherwise.
    Field<Real> pvt(n);
    search_pivot(pvt, mc);
    Field<Real> r(n), r0(n), pv(n), p_(n), q(n), s(n), s_(n), t_(n);
    calc_rk_maf(r, p, b, mc, pvt);
    r0.v = r.v;
    Real rho_old = 1, alpha = 0, om = 1;
    for (itr = 1; itr < itmax; ++itr) {
      Real rho = dot2(r, r0);
      if (std::fabs(static_cast<double>(rho)) < 1.17549435e-38) { itr = 0; break; }
      if (itr == 1) {
        pv.v = r.v;
      } else {
        Real beta = rho / rho_old * alpha / om;
        for (int j = 1; j <= n - 2; ++j)
          for (int i = 1; i <= n - 2; ++i)
            for (int k = 1; k <= n - 2; ++k)
              pv.at(k, i, j) = r.at(k, i, j) +
                               beta * (pv.at(k, i, j) - om * q.at(k, i, j));
      }
      precondition_maf(p_, pv, precond, omg, wk, mc);
      calc_ax_maf(q, p_, mc, pvt);
      alpha = rho / dot2(q, r0);
      for (int j = 1; j <= n - 2; ++j)
        for (int i = 1; i <= n - 2; ++i)
          for (int k = 1; k <= n - 2; ++k)
            s.at(k, i, j) = -alpha * q.at(k, i, j) + r.at(k, i, j);
      precondition_maf(s_, s, precond, omg, wk, mc);
      calc_ax_maf(t_, s_, mc, pvt);
      om = dot2(t_, s) / dot1(t_);
      for (int j = 1; j <= n - 2; ++j)
        for (int i = 1; i <= n - 2; ++i)
          for (int k = 1; k <= n - 2; ++k) {
            p.at(k, i, j) += alpha * p_.at(k, i, j) + om * s_.at(k, i, j);
            r.at(k, i, j) = -om * t_.at(k, i, j) + s.at(k, i, j);
          }
      res = static_cast<double>(dot1(r));
      res = std::sqrt(res * res_normal);
      std::fprintf(fh, "%6d, %13.6e\n", itr, res);
      apply_bc(p, dh);
      if (res < eps) break;
      rho_old = rho;
    }
  } else if (solver == "pbicgstab") {
    Field<Real> r(n), r0(n), pv(n), p_(n), q(n), s(n), s_(n), t_(n);
    calc_rk(r, p, b);
    r0.v = r.v;
    Real rho_old = 1, alpha = 0, om = 1;
    for (itr = 1; itr < itmax; ++itr) {
      Real rho = dot2(r, r0);
      if (std::fabs(static_cast<double>(rho)) < 1.17549435e-38) { itr = 0; break; }
      if (itr == 1) {
        pv.v = r.v;
      } else {
        Real beta = rho / rho_old * alpha / om;
        for (int j = 1; j <= n - 2; ++j)
          for (int i = 1; i <= n - 2; ++i)
            for (int k = 1; k <= n - 2; ++k)
              pv.at(k, i, j) = r.at(k, i, j) +
                               beta * (pv.at(k, i, j) - om * q.at(k, i, j));
      }
      precondition(p_, pv, precond, omg, wk);
      calc_ax(q, p_);
      alpha = rho / dot2(q, r0);
      for (int j = 1; j <= n - 2; ++j)
        for (int i = 1; i <= n - 2; ++i)
          for (int k = 1; k <= n - 2; ++k)
            s.at(k, i, j) = -alpha * q.at(k, i, j) + r.at(k, i, j);
      precondition(s_, s, precond, omg, wk);
      calc_ax(t_, s_);
      om = dot2(t_, s) / dot1(t_);
      for (int j = 1; j <= n - 2; ++j)
        for (int i = 1; i <= n - 2; ++i)
          for (int k = 1; k <= n - 2; ++k) {
            p.at(k, i, j) += alpha * p_.at(k, i, j) + om * s_.at(k, i, j);
            r.at(k, i, j) = -om * t_.at(k, i, j) + s.at(k, i, j);
          }
      res = static_cast<double>(dot1(r));
      res = std::sqrt(res * res_normal);
      std::fprintf(fh, "%6d, %13.6e\n", itr, res);
      apply_bc(p, dh);
      if (res < eps) break;
      rho_old = rho;
    }
  } else {
    for (itr = 1; itr <= itmax; ++itr) {
      double r2;
      if (solver == "jacobi") r2 = jacobi_sweep(p, b, wk, omg);
      else if (solver == "psor") r2 = psor_sweep(p, b, omg);
      else if (solver == "sor2sma") r2 = sor2sma_sweep(p, b, omg);
      else if (solver == "pcr") r2 = line_sweep(p, b, omg, LineMode::GS);
      else if (solver == "pcr_rb") r2 = line_sweep(p, b, omg, LineMode::RB);
      else if (solver == "pcr_j_esa") r2 = line_sweep(p, b, omg, LineMode::JACOBI);
      else if (solver == "psor_maf") r2 = psor_maf_sweep(p, b, mc, omg);
      else if (solver == "jacobi_maf") r2 = jacobi_maf_sweep(p, b, mc, wk, omg);
      else if (solver == "sor2sma_maf") r2 = sor2sma_maf_sweep(p, b, mc, omg);
      else if (solver == "pcr_maf") r2 = line_sweep_maf(p, b, mc, omg, LineMode::GS);
      else if (solver == "pcr_rb_maf") r2 = line_sweep_maf(p, b, mc, omg, LineMode::RB);
      else { std::fprintf(stderr, "unknown solver %s\n", solver.c_str()); return 2; }
      res = std::sqrt(r2 * res_normal);
      std::fprintf(fh, "%6d, %13.6e\n", itr, res);
      apply_bc(p, dh);
      if (res < eps) break;
    }
    if (itr > itmax) itr = itmax;
  }
  std::fclose(fh);

  // analytic max error (exact_t/err_t, cz_utility.f90:52-129)
  const double pi = 2.0 * std::asin(1.0);
  const double s2 = std::sqrt(2.0) * pi;
  double errmax = 0.0;
  for (int j = 1; j <= n - 2; ++j)
    for (int i = 1; i <= n - 2; ++i)
      for (int k = 1; k <= n - 2; ++k) {
        double x = dh * i, y = dh * j, z = dh * k;
        double ex = std::sin(pi * x) * std::sin(pi * y) / std::sinh(s2) *
                    (std::sinh(s2 * z) - std::sinh(s2 * (z - 1.0)));
        double e = std::fabs(static_cast<double>(p.at(k, i, j)) - ex);
        if (e > errmax) errmax = e;
      }

  std::printf("iters=%d res=%.6e errmax=%.6e\n", itr, res, errmax);
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: %s N solver itmax omega [precond] [--fp64] [--eps E] "
                 "[--out F] [--plane-partials]\n", argv[0]);
    return 2;
  }
  int n = std::atoi(argv[1]);
  std::string solver = argv[2];
  int itmax = std::atoi(argv[3]);
  double omega = std::atof(argv[4]);
  std::string precond = "none";
  bool fp64 = false;
  double eps = 1.0e-5;  // cz.h:162
  std::string outpath = solver + ".txt";
  for (int a = 5; a < argc; ++a) {
    std::string s = argv[a];
    if (s == "--fp64") fp64 = true;
    else if (s == "--eps" && a + 1 < argc) eps = std::atof(argv[++a]);
    else if (s == "--out" && a + 1 < argc) outpath = argv[++a];
    else if (s == "--plane-partials") g_plane_partials = true;
    else precond = s;
  }
  return fp64 ? run<double>(n, solver, itmax, omega, precond, eps, outpath)
              : run<float>(n, solver, itmax, omega, precond, eps, outpath);
}
