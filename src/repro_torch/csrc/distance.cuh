// Device-side distance forms shared by the objective (K1) and pair-gain
// (K2) kernels: the in-register tree oracle, the k-ary n-cube ring
// distance, and the explicit-matrix gather (float32 or a lossless
// int8/int16 packing).  Each mirrors its plain PyTorch twin in
// repro_torch/kernels/qap_objective.py (_hier_distance, _torus_distance)
// and pair_gain.py (distance_form) operation for operation; products and
// sums use the _rn intrinsics and the library is built with --fmad=false,
// so no multiply-add is contracted behind the twin's back.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace viem {

constexpr int kMaxLevels = 16;

enum Form : int {
  kTree = 0,     // hierarchy: ip = strides[0..k], fp = dists[0..k-1]
  kTorus = 1,    // k-ary n-cube: ip = dims, fp = per-axis weights
  kMatF32 = 2,   // explicit float32 table, row stride n_pe
  kMatI8 = 3,    // lossless int8 packing of the table
  kMatI16 = 4,   // lossless int16 packing of the table
};

// Small static parameters, passed by value as a kernel argument.
struct FormParams {
  int nlev;                   // tree levels k, or torus axes
  int n_pe;                   // matrix row stride
  int ip[kMaxLevels + 1];
  float fp[kMaxLevels];
};

// d = dists[lca_level - 1], 0 when p == q (the tree oracle: the lowest
// level whose subtree holds both PEs).
__device__ __forceinline__ float tree_distance(const FormParams& f, int p,
                                               int q) {
  if (p == q) return 0.0f;
  float out = f.fp[f.nlev - 1];
#pragma unroll
  for (int lvl = kMaxLevels - 1; lvl >= 1; --lvl) {
    if (lvl < f.nlev && p / f.ip[lvl] == q / f.ip[lvl]) out = f.fp[lvl - 1];
  }
  return out;
}

// Σ_a w_a · min(|x_a − y_a|, k_a − |x_a − y_a|), axis 0 innermost.
__device__ __forceinline__ float torus_distance(const FormParams& f, int p,
                                                int q) {
  float out = 0.0f;
  int stride = 1;
#pragma unroll
  for (int a = 0; a < kMaxLevels; ++a) {
    if (a < f.nlev) {
      const int d = f.ip[a];
      const int delta = abs((p / stride) % d - (q / stride) % d);
      const int ring = min(delta, d - delta);
      out = __fadd_rn(out, __fmul_rn(f.fp[a], static_cast<float>(ring)));
      stride *= d;
    }
  }
  return out;
}

template <int FORM>
__device__ __forceinline__ float distance(const FormParams& f,
                                          const void* __restrict__ D, int p,
                                          int q) {
  if constexpr (FORM == kTree) {
    return tree_distance(f, p, q);
  } else if constexpr (FORM == kTorus) {
    return torus_distance(f, p, q);
  } else {
    const size_t at = static_cast<size_t>(p) * f.n_pe + q;
    if constexpr (FORM == kMatF32) {
      return static_cast<const float*>(D)[at];
    } else if constexpr (FORM == kMatI8) {
      return static_cast<float>(static_cast<const int8_t*>(D)[at]);
    } else {
      return static_cast<float>(static_cast<const int16_t*>(D)[at]);
    }
  }
}

// d(pa, t) − d(pb, t).  Packed tables take the exact int32 difference
// before the (exact) conversion to float32, as the reference does.
template <int FORM>
__device__ __forceinline__ float distance_delta(const FormParams& f,
                                                const void* __restrict__ D,
                                                int pa, int pb, int t) {
  if constexpr (FORM == kMatI8 || FORM == kMatI16) {
    using T = typename std::conditional<FORM == kMatI8, int8_t, int16_t>::type;
    const T* M = static_cast<const T*>(D);
    const int da = M[static_cast<size_t>(pa) * f.n_pe + t];
    const int db = M[static_cast<size_t>(pb) * f.n_pe + t];
    return static_cast<float>(da - db);
  } else {
    return __fsub_rn(distance<FORM>(f, D, pa, t), distance<FORM>(f, D, pb, t));
  }
}

// Copy the host-side static parameters into the by-value struct; false
// when they do not fit.
inline bool make_form_params(int nlev, int n_pe, const int* ip, int n_ip,
                             const float* fp, int n_fp, FormParams* out) {
  if (nlev < 0 || nlev > kMaxLevels || n_ip > kMaxLevels + 1 ||
      n_fp > kMaxLevels)
    return false;
  out->nlev = nlev;
  out->n_pe = n_pe;
  for (int i = 0; i < kMaxLevels + 1; ++i) out->ip[i] = i < n_ip ? ip[i] : 1;
  for (int i = 0; i < kMaxLevels; ++i) out->fp[i] = i < n_fp ? fp[i] : 0.0f;
  return true;
}

}  // namespace viem
