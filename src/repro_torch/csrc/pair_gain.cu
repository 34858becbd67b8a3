// K2 — sparse swap gains of P candidate pairs over ELL neighbor rows:
//
//   gain(u, v) = Σ_{k∈N(u)\{v}} w_uk · (D(π_u, π_k) − D(π_v, π_k))
//              + Σ_{k∈N(v)\{u}} w_vk · (D(π_v, π_k) − D(π_u, π_k))
//
// Replaces: src/repro/kernels/pair_gain.py — pair_gains_pallas via
// _pallas_side (three pallas_calls: _side_kernel for tree/torus,
// _diff_kernel for a float32 table, _wdelta_kernel for int8/int16
// tables).  The TPU version gathers π, the neighbor rows and (matrix
// form) both distance rows into (P, K) arrays in its wrapper and runs
// one pallas_call per side.
//
// Bound on the H100: memory.  At the main path's P = 1,824,720 and
// K = 8 the kernel must read us and vs (14.6 MB) and write the gains
// (7.3 MB); nbr, wgt and π are 0.28 MB and stay in L2.  ~22 MB at
// 3.35 TB/s is ~6.6 µs; the arithmetic (≤ 2·2·K oracle evaluations per
// pair) is negligible next to it.
//
// Design: one thread per pair does every gather itself — us/vs (the
// only streamed bytes, coalesced), π, both neighbor rows and the
// distances — so none of the (P, K) intermediates the TPU wrapper
// materialized ever reaches device memory.  The `k != other` exclusion
// is folded into the weight.  Each side is reduced over its K slots in
// order, then the two sides are added, the reference's order.  Padding
// pairs (u, u) give exactly 0: every term is w · (d − d).
#include "distance.cuh"

namespace viem {
namespace {

constexpr int kBlock = 256;

template <int FORM>
__device__ __forceinline__ float side_gain(const int* __restrict__ row,
                                           const float* __restrict__ wrow,
                                           int K, int other,
                                           const int* __restrict__ perm,
                                           int pa, int pb,
                                           const void* __restrict__ D,
                                           const FormParams& f) {
  float s = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int node = row[k];
    const float w = node == other ? 0.0f : wrow[k];
    const float delta = distance_delta<FORM>(f, D, pa, pb, perm[node]);
    s = __fadd_rn(s, __fmul_rn(w, delta));
  }
  return s;
}

template <int FORM>
__global__ void __launch_bounds__(kBlock)
pair_gains(const int* __restrict__ nbr, const float* __restrict__ wgt, int K,
           const int* __restrict__ perm, const int* __restrict__ us,
           const int* __restrict__ vs, int P, const void* __restrict__ D,
           FormParams f, float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= P) return;
  const int u = us[i];
  const int v = vs[i];
  const int pu = perm[u];
  const int pv = perm[v];
  const size_t ru = static_cast<size_t>(u) * K;
  const size_t rv = static_cast<size_t>(v) * K;
  const float sa = side_gain<FORM>(nbr + ru, wgt + ru, K, v, perm, pu, pv, D, f);
  const float sb = side_gain<FORM>(nbr + rv, wgt + rv, K, u, perm, pv, pu, D, f);
  out[i] = __fadd_rn(sa, sb);
}

template <int FORM>
void launch(const int* nbr, const float* wgt, int K, const int* perm,
            const int* us, const int* vs, int P, const void* D,
            const FormParams& f, float* out, cudaStream_t stream) {
  const int grid = (P + kBlock - 1) / kBlock;
  pair_gains<FORM><<<grid, kBlock, 0, stream>>>(nbr, wgt, K, perm, us, vs, P,
                                                D, f, out);
}

}  // namespace
}  // namespace viem

extern "C" {

// out[i] = gain of swapping us[i] and vs[i] under perm.  Returns a
// cudaError_t code.
int viem_pair_gains(const int* nbr, const float* wgt, int K, const int* perm,
                    const int* us, const int* vs, int P, const void* D,
                    int form, int nlev, int n_pe, const int* ip, int n_ip,
                    const float* fp, int n_fp, float* out, void* stream) {
  viem::FormParams f;
  if (P < 0 || K < 0 || !viem::make_form_params(nlev, n_pe, ip, n_ip, fp,
                                                n_fp, &f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case viem::kTree:
      viem::launch<viem::kTree>(nbr, wgt, K, perm, us, vs, P, D, f, out, s);
      break;
    case viem::kTorus:
      viem::launch<viem::kTorus>(nbr, wgt, K, perm, us, vs, P, D, f, out, s);
      break;
    case viem::kMatF32:
      viem::launch<viem::kMatF32>(nbr, wgt, K, perm, us, vs, P, D, f, out, s);
      break;
    case viem::kMatI8:
      viem::launch<viem::kMatI8>(nbr, wgt, K, perm, us, vs, P, D, f, out, s);
      break;
    case viem::kMatI16:
      viem::launch<viem::kMatI16>(nbr, wgt, K, perm, us, vs, P, D, f, out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* viem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
