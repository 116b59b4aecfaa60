// The short-range P3M pair weight, float32 device code shared by the pair
// kernels: K1 (p3m_short.cu), K3 (pm_supercell.cu), K4 and K5
// (p3m_columns.cu) and K6 (p3m_cells.cu).
//
// w(r^2) is the force split (SPLIT 0: Gaussian / Ewald erfc, nbody
// _short_weight; SPLIT 1: polynomial spline, nbody _spline_short_weight)
// times the softened Newton factor (SOFT 0: Plummer, nbody _soft_newton;
// SOFT 1: cubic spline, nbody _soft_newton_spline), with the constants and
// the order of operations of nbody/forces/p3m.py.  The caller applies the
// cutoff mask max(r^2, 1e-30) < r_cut^2.
//
// APPROX (K1 and K6; K3-K5 take the default, false, and compile as before)
// swaps three library calls for one instruction each: rsqrtf for
// rsqrt.approx.ftz.f32 (the same MUFU.RSQ without rsqrtf's three-instruction
// denormal guard; every argument is at least 1e-30, a normal float, so the
// result is the same), the IEEE division 1 / (1 + 0.3275911 x) of the
// Gaussian split for rcp.approx.ftz.f32 (one MUFU.RCP, within 1 ulp) and
// expf for __expf (ex2.approx of x log2(e): ~2 ulp plus the rounding of the
// product, ~3e-6 relative at the cutoff of the Ewald split).

#pragma once

#include <cuda_runtime.h>

namespace nbody_kernels {

constexpr float kInvSqrtPi = 0.56418958354775628695f;

struct Params {
  float box;        // periodic box side
  float inv_box;    // 1 / box
  float eps2;       // Plummer-equivalent softening length squared
  float r_cut2;     // cutoff radius squared
  float inv_rcut2;  // 1 / r_cut^2 (spline split)
  float inv_rcut3;  // 1 / r_cut^3 (spline split)
  float inv_2rs;    // 1 / (2 r_s) (Gaussian split)
  float inv_rs;     // 1 / r_s (Gaussian split)
  float h;          // cubic-spline softening support 2.8 eps (0: none)
  float inv_h;      // 1 / h
  float h3_inv;     // 1 / h^3
};

// The float32 constants of one (box, eps, r_s, r_cut), from doubles.
inline Params make_params(double box, double eps, double r_s, double r_cut) {
  Params p;
  const double h = eps > 0.0 ? 2.8 * eps : 0.0;
  p.box = static_cast<float>(box);
  p.inv_box = static_cast<float>(1.0 / box);
  p.eps2 = static_cast<float>(eps * eps);
  p.r_cut2 = static_cast<float>(r_cut * r_cut);
  p.inv_rcut2 = static_cast<float>(1.0 / (r_cut * r_cut));
  p.inv_rcut3 = static_cast<float>(1.0 / (r_cut * r_cut * r_cut));
  p.inv_2rs = static_cast<float>(1.0 / (2.0 * r_s));
  p.inv_rs = static_cast<float>(1.0 / r_s);
  p.h = static_cast<float>(h);
  p.inv_h = h > 0.0 ? static_cast<float>(1.0 / h) : 0.0f;
  p.h3_inv = h > 0.0 ? static_cast<float>(1.0 / (h * h * h)) : 0.0f;
  return p;
}

// 1 / sqrt(x) and 1 / x for x >= 1e-30 (see APPROX above).
template <bool APPROX>
__device__ __forceinline__ float rsqrt_w(float x) {
  if constexpr (APPROX) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
  } else {
    return rsqrtf(x);
  }
}

template <bool APPROX>
__device__ __forceinline__ float rcp_w(float x) {
  if constexpr (APPROX) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
  } else {
    return 1.0f / x;
  }
}

// erfc(x) for x >= 0, Abramowitz & Stegun 7.1.26 (nbody _erfc_pos).
template <bool APPROX = false>
__device__ __forceinline__ float erfc_pos(float x, float expmx2) {
  const float t = rcp_w<APPROX>(1.0f + 0.3275911f * x);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return poly * expmx2;
}

// Softened Newton weight F / (G m r); r2 excludes eps^2.
// SOFT 0, Plummer: 1 / (r^2 + eps^2)^(3/2)   (nbody _soft_newton);
// SOFT 1, cubic spline, exact Newton beyond h   (nbody _soft_newton_spline).
template <int SOFT, bool APPROX = false>
__device__ __forceinline__ float soft_newton(float r2, const Params& p) {
  if constexpr (SOFT == 0) {
    const float inv_r = rsqrt_w<APPROX>(fmaxf(r2 + p.eps2, 1e-30f));
    return inv_r * inv_r * inv_r;
  } else {
    const float r2c = fmaxf(r2, 1e-30f);
    const float inv_r = rsqrt_w<APPROX>(r2c);
    const float newton = inv_r * inv_r * inv_r;
    if (p.h == 0.0f) return newton;
    const float u = r2c * inv_r * p.inv_h;  // r / h
    const float fac_lo =
        p.h3_inv * (32.0f / 3.0f + u * u * (32.0f * u - 38.4f));
    const float fac_hi =
        p.h3_inv *
            (64.0f / 3.0f + u * (-48.0f + u * (38.4f - (32.0f / 3.0f) * u))) -
        (1.0f / 15.0f) * newton;
    return u < 0.5f ? fac_lo : (u < 1.0f ? fac_hi : newton);
  }
}

// Short-range weight inside the cutoff (the caller applies the mask).
// SPLIT 0: Gaussian split (nbody _short_weight);
// SPLIT 1: polynomial spline split (nbody _spline_short_weight).
template <int SPLIT, int SOFT, bool APPROX = false>
__device__ __forceinline__ float short_weight(float r2, const Params& p) {
  const float r2f = fmaxf(r2, 1e-30f);
  if constexpr (SPLIT == 0) {
    const float inv_r = rsqrt_w<APPROX>(r2f);
    const float r = r2f * inv_r;
    const float x = r * p.inv_2rs;
    const float expmx2 = APPROX ? __expf(-x * x) : expf(-x * x);
    const float corr =
        erfc_pos<APPROX>(x, expmx2) + (r * p.inv_rs) * kInvSqrtPi * expmx2;
    return corr * soft_newton<SOFT, APPROX>(r2, p);
  } else {
    const float u2 = r2f * p.inv_rcut2;
    const float g = (-70.0f + u2 * (84.0f - u2 * 30.0f)) * (1.0f / 16.0f);
    return soft_newton<SOFT, APPROX>(r2, p) + g * p.inv_rcut3;
  }
}

}  // namespace nbody_kernels
