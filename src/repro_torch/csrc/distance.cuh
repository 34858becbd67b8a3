// Device-side distance forms shared by the objective (K1) and pair-gain
// (K2) kernels: the tree oracle, the k-ary n-cube ring distance, and the
// explicit-matrix gather (float32 or a lossless int8/int16 packing).
// Each mirrors its plain PyTorch twin in repro_torch/kernels/
// qap_objective.py (_hier_distance, _torus_distance) and pair_gain.py
// (distance_form); products and sums use the _rn intrinsics and the
// library is built with --fmad=false, so no multiply-add is contracted
// behind the twin's back.
//
// No division.  sm_90 has no integer divide instruction: a `/` or `%` by
// a runtime value is a ~20-instruction sequence.  Every divisor here is
// a static parameter of the form (a tree stride, a torus axis' stride),
// so the host gives each one a fixed-point reciprocal (Granlund and
// Montgomery, "Division by invariant integers using multiplication",
// PLDI 1994): p / s == (p · mul) >> shift for every 0 <= p < 2^31, with
// mul < 2^32 (kernels/qap_objective.py:reciprocal, which also checks the
// bound).  A quotient is then one 32×32→64-bit multiply and a shift, and
// p % d is a multiply-subtract on the next quotient.
//
// Keys.  Both closed forms compare per-level keys of the two PEs: a
// tree's ancestors p / strides[l] (l = 1 .. nlev-1), a torus' coordinates
// (p / stride_a) % dims_a.  keys_of computes one PE's keys once, so a
// caller that holds one PE fixed (K2: π_u and π_v of a pair, against
// each neighbor's target) computes only the moving PE's keys per call.
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

// p / s == (p · mul) >> shift for 0 <= p < 2^31.
struct Recip {
  uint32_t mul;
  uint32_t shift;
};

// Static parameters, built on the host (kernels/qap_objective.py:
// FormParams, the same layout) and passed by value as a kernel argument.
struct FormParams {
  int nlev;                   // tree levels k, or torus axes
  int n_pe;                   // matrix row stride
  int ip[kMaxLevels + 1];     // tree strides, or torus dims
  // tree: rc[l] divides by strides[l] (l = 1 .. nlev-1); torus: rc[a]
  // divides by stride_a = dims[0] · … · dims[a-1] (a = 1 .. nlev)
  Recip rc[kMaxLevels + 1];
  float fp[kMaxLevels];       // tree dists, or torus axis weights
};

__device__ __forceinline__ int div_by(int p, Recip r) {
  return static_cast<int>(
      (static_cast<uint64_t>(static_cast<uint32_t>(p)) * r.mul) >> r.shift);
}

// One PE's keys: tree — k[l] = p / strides[l], l = 1 .. nlev-1;
// torus — k[a] = (p / stride_a) % dims[a], a = 0 .. nlev-1 (axis 0
// innermost).  Matrix forms have none.
// L bounds the unrolled loops: a form of nlev <= L levels may take the
// instance of L, whose key arrays hold L registers.
template <int FORM, int L = kMaxLevels>
__device__ __forceinline__ void keys_of(const FormParams& f, int p, int* k) {
  if constexpr (FORM == kTree) {
#pragma unroll
    for (int l = 1; l < L; ++l) {
      if (l >= f.nlev) break;
      k[l] = div_by(p, f.rc[l]);
    }
  } else if constexpr (FORM == kTorus) {
    int q = p;                                   // p / stride_a
#pragma unroll
    for (int a = 0; a < L; ++a) {
      if (a >= f.nlev) break;
      const int next = div_by(p, f.rc[a + 1]);   // p / stride_{a+1}
      k[a] = q - next * f.ip[a];
      q = next;
    }
  }
}

// d(pa, t) − d(pb, t) for a target t, given both PEs' keys.
//
// Tree: d(p, t) is 0 when p == t, else dists[l-1] for the lowest level
// l (1 <= l < nlev) at which p's and t's ancestors agree, dists[nlev-1]
// (``top``, which the caller reads once) when none does: the
// reference's top-down overwrite.  The level index is a compile-time
// constant in each unrolled step, so every dists[l-1] is a constant
// operand of the select.
template <int FORM, int L = kMaxLevels>
__device__ __forceinline__ float delta_keyed(const FormParams& f, float top,
                                             const void* __restrict__ D,
                                             int pa, const int* ka, int pb,
                                             const int* kb, int t) {
  if constexpr (FORM == kTree) {
    float da = top, db = top;
#pragma unroll
    for (int l = L - 1; l >= 1; --l) {
      if (l < f.nlev) {
        const int kt = div_by(t, f.rc[l]);
        if (kt == ka[l]) da = f.fp[l - 1];
        if (kt == kb[l]) db = f.fp[l - 1];
      }
    }
    if (t == pa) da = 0.0f;
    if (t == pb) db = 0.0f;
    return __fsub_rn(da, db);
  } else if constexpr (FORM == kTorus) {
    float da = 0.0f, db = 0.0f;
    int q = t;
#pragma unroll
    for (int a = 0; a < L; ++a) {
      if (a >= f.nlev) break;
      const int d = f.ip[a];
      const int next = div_by(t, f.rc[a + 1]);
      const int xt = q - next * d;
      q = next;
      const int ea = abs(xt - ka[a]);
      const int eb = abs(xt - kb[a]);
      da = __fadd_rn(da, __fmul_rn(f.fp[a], static_cast<float>(min(ea, d - ea))));
      db = __fadd_rn(db, __fmul_rn(f.fp[a], static_cast<float>(min(eb, d - eb))));
    }
    return __fsub_rn(da, db);
  } else {
    // Packed tables take the exact int32 difference before the (exact)
    // conversion to float32, as the reference does.
    const size_t t_at = static_cast<size_t>(t);
    const size_t ra = static_cast<size_t>(pa) * f.n_pe;
    const size_t rb = static_cast<size_t>(pb) * f.n_pe;
    if constexpr (FORM == kMatF32) {
      const float* M = static_cast<const float*>(D);
      return __fsub_rn(__ldg(M + ra + t_at), __ldg(M + rb + t_at));
    } else {
      using T = typename std::conditional<FORM == kMatI8, int8_t, int16_t>::type;
      const T* M = static_cast<const T*>(D);
      const int da = __ldg(M + ra + t_at);
      const int db = __ldg(M + rb + t_at);
      return static_cast<float>(da - db);
    }
  }
}

// d(p, q), keys of neither known (K1: every edge has its own PEs).
template <int FORM>
__device__ __forceinline__ float distance(const FormParams& f, float top,
                                          const void* __restrict__ D, int p,
                                          int q) {
  if constexpr (FORM == kTree) {
    float d = top;
#pragma unroll
    for (int l = kMaxLevels - 1; l >= 1; --l) {
      if (l < f.nlev && div_by(p, f.rc[l]) == div_by(q, f.rc[l]))
        d = f.fp[l - 1];
    }
    return p == q ? 0.0f : d;
  } else if constexpr (FORM == kTorus) {
    float out = 0.0f;
    int qp = p, qq = q;
#pragma unroll
    for (int a = 0; a < kMaxLevels; ++a) {
      if (a >= f.nlev) break;
      const int d = f.ip[a];
      const int np = div_by(p, f.rc[a + 1]);
      const int nq = div_by(q, f.rc[a + 1]);
      const int e = abs((qp - np * d) - (qq - nq * d));
      qp = np;
      qq = nq;
      out = __fadd_rn(out, __fmul_rn(f.fp[a], static_cast<float>(min(e, d - e))));
    }
    return out;
  } else {
    const size_t at = static_cast<size_t>(p) * f.n_pe + q;
    if constexpr (FORM == kMatF32) {
      return __ldg(static_cast<const float*>(D) + at);
    } else if constexpr (FORM == kMatI8) {
      return static_cast<float>(__ldg(static_cast<const int8_t*>(D) + at));
    } else {
      return static_cast<float>(__ldg(static_cast<const int16_t*>(D) + at));
    }
  }
}

// A lane's base pointer, ``p + offset``, made opaque to the compiler, so
// a gather at p[k] stays one multiply-add on that base.  Left visible,
// the compiler reassociates each gather into (offset + k)·size + p, four
// instructions where one does: K2's tree form, the gathers' heaviest
// user, lost that much time to it (PERF.md §6).
template <typename T>
__device__ __forceinline__ const T* lane_base(const T* p, size_t offset) {
  p += offset;
  asm("" : "+l"(p));
  return p;
}

// dists[nlev-1], the tree's distance between PEs with no common
// ancestor below the root (0 for the other forms, which do not use it).
__device__ __forceinline__ float top_distance(const FormParams& f) {
  return f.nlev > 0 ? f.fp[f.nlev - 1] : 0.0f;
}

}  // namespace viem
