// K1 — the sparse QAP objective J = Σ_e w_e · D(π(u_e), π(v_e)).
//
// Replaces: src/repro/kernels/qap_objective.py — qap_objective_edges
// (_qap_obj_kernel), qap_objective_edges_torus (_qap_obj_torus_kernel)
// and qap_objective_edges_matrix (_weighted_sum_kernel), all through
// _reduce_call's pallas_call.  The TPU version walks a sequential grid
// with one scalar SMEM accumulator and gathers π in its jit'd wrapper.
//
// Bound on the H100: memory.  Per edge it reads eu, ev, ew (12 B) plus
// two π entries and, for the matrix forms, one table entry; at the main
// path's E = 11,520 that is ~0.15 MB, far below what a launch costs, so
// at that size the kernel is bound by launch latency, not by bytes or
// arithmetic (the tree and torus oracles are a handful of integer ops).
//
// Design: the π gather and the distance are fused into one pass, so
// nothing per-edge is written back to memory.  Blocks grid-stride over
// the edges; each thread sums its edges in order, the block reduces in a
// fixed tree, and a second one-block pass adds the per-block partials in
// a fixed order.  The grid size depends only on E, so the result is
// deterministic run to run; no float atomics.  Padding edges
// (0, 0, w = 0) add exactly 0.
#include "distance.cuh"

namespace viem {
namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float block_sum(float v, float* sm) {
  sm[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sm[threadIdx.x] = __fadd_rn(sm[threadIdx.x],
                                                     sm[threadIdx.x + s]);
    __syncthreads();
  }
  return sm[0];
}

template <int FORM>
__global__ void __launch_bounds__(kBlock)
objective_partials(const int* __restrict__ eu, const int* __restrict__ ev,
                   const float* __restrict__ ew, int E,
                   const int* __restrict__ perm, const void* __restrict__ D,
                   FormParams f, float* __restrict__ partials) {
  __shared__ float sm[kBlock];
  float acc = 0.0f;
  for (int i = blockIdx.x * kBlock + threadIdx.x; i < E;
       i += gridDim.x * kBlock) {
    const float d = distance<FORM>(f, D, perm[eu[i]], perm[ev[i]]);
    acc = __fadd_rn(acc, __fmul_rn(ew[i], d));
  }
  const float total = block_sum(acc, sm);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kBlock)
sum_partials(const float* __restrict__ partials, int nb,
             float* __restrict__ out) {
  __shared__ float sm[kBlock];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nb; i += kBlock)
    acc = __fadd_rn(acc, partials[i]);
  const float total = block_sum(acc, sm);
  if (threadIdx.x == 0) out[0] = total;
}

template <int FORM>
void launch(const int* eu, const int* ev, const float* ew, int E,
            const int* perm, const void* D, const FormParams& f,
            float* partials, int nb, float* out, cudaStream_t stream) {
  objective_partials<FORM><<<nb, kBlock, 0, stream>>>(eu, ev, ew, E, perm, D,
                                                      f, partials);
  sum_partials<<<1, kBlock, 0, stream>>>(partials, nb, out);
}

}  // namespace
}  // namespace viem

extern "C" {

// Threads per block; the wrapper sizes the partials buffer from it.
int viem_objective_block() { return viem::kBlock; }

// out[0] = Σ_e ew[e] · D(perm[eu[e]], perm[ev[e]]).  ``partials`` holds
// ``nb`` floats of scratch (nb >= 1).  Returns a cudaError_t code.
int viem_qap_objective(const int* eu, const int* ev, const float* ew, int E,
                       const int* perm, const void* D, int form, int nlev,
                       int n_pe, const int* ip, int n_ip, const float* fp,
                       int n_fp, float* partials, int nb, float* out,
                       void* stream) {
  viem::FormParams f;
  if (E < 0 || nb < 1 || !viem::make_form_params(nlev, n_pe, ip, n_ip, fp,
                                                 n_fp, &f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case viem::kTree:
      viem::launch<viem::kTree>(eu, ev, ew, E, perm, D, f, partials, nb, out, s);
      break;
    case viem::kTorus:
      viem::launch<viem::kTorus>(eu, ev, ew, E, perm, D, f, partials, nb, out, s);
      break;
    case viem::kMatF32:
      viem::launch<viem::kMatF32>(eu, ev, ew, E, perm, D, f, partials, nb, out, s);
      break;
    case viem::kMatI8:
      viem::launch<viem::kMatI8>(eu, ev, ew, E, perm, D, f, partials, nb, out, s);
      break;
    case viem::kMatI16:
      viem::launch<viem::kMatI16>(eu, ev, ew, E, perm, D, f, partials, nb, out, s);
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
