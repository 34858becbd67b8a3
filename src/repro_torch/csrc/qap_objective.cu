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
// path's E = 11,520 that is ~0.15 MB, ~0.05 µs at 3.35 TB/s — far below
// what a launch costs, so at that size the kernel is bound by launch
// latency and by its wrapper's host work, not by bytes or arithmetic.
//
// Design: one launch a call.  The π gather and the distance (division-
// free, distance.cuh) are fused into one pass, so nothing per-edge is
// written back to memory.  Blocks grid-stride over the edges; each
// thread sums its edges in order and the block reduces in a fixed tree
// into its partial.  The last block to finish — each block takes a
// ticket from an atomic counter after a __threadfence() that publishes
// its partial — adds the partials in a fixed order, writes J and resets
// the counter to 0 for the next launch.  The grid size depends only on
// E, so the result is deterministic run to run, and equal to that of a
// second launch summing the partials the same way; no float atomics.
// Padding edges (0, 0, w = 0) add exactly 0, and the result is the
// same bits under more padding while E stays at or below 256 · kMaxBlocks
// (every thread then holds at most one edge; the extra blocks' partials
// are 0 and land after the live ones in each thread's sum).
//
// Lanes: one launch takes B sums, gridDim.y = B.  Lane b reads eu, ev, ew
// at b·E and π at b·n, writes out[b], and has its own kMaxBlocks partials
// and its own ticket, so lane b's last block sums lane b's partials only.
// The grid still depends only on E, so each lane's bits equal a single
// launch on that lane's arrays; a single call is B = 1.  In the shared-
// graph instance (the portfolio's restart lanes of one graph) every lane
// reads the one edge list at offset 0 and only π (at b·n), the output,
// the partials and the ticket keep a lane offset.
//
// Where it stands (H100, main shape): one launch of ~4.7 µs on the
// device against ~37 µs of host time in its wrapper (PERF.md); a call
// costs what the host spends on it.
#include "distance.cuh"

namespace viem {
namespace {

// kernels/qap_objective.py sizes the grid and the scratch by these two
constexpr int kBlock = 256;
constexpr int kMaxBlocks = 1024;

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

// ``scratch`` holds, for each lane, kMaxBlocks partials, then the
// lane's ticket counter (0 between launches).  SHARED: the edge list has
// lane stride 0.
template <int FORM, bool SHARED>
__global__ void __launch_bounds__(kBlock)
objective(const int* __restrict__ eu, const int* __restrict__ ev,
          const float* __restrict__ ew, int E, const int* __restrict__ perm,
          int n, const void* __restrict__ D,
          const __grid_constant__ FormParams f, float* __restrict__ scratch,
          float* __restrict__ out) {
  __shared__ float sm[kBlock];
  __shared__ bool last;
  const size_t lane = blockIdx.y;
  if constexpr (!SHARED) {
    eu += lane * E;
    ev += lane * E;
    ew += lane * E;
  }
  perm = lane_base(perm, lane * n);
  scratch += lane * (kMaxBlocks + 1);
  out += lane;
  const float top = top_distance(f);
  float acc = 0.0f;
  for (int i = blockIdx.x * kBlock + threadIdx.x; i < E;
       i += gridDim.x * kBlock) {
    const float d = distance<FORM>(f, top, D, __ldg(perm + eu[i]),
                                   __ldg(perm + ev[i]));
    acc = __fadd_rn(acc, __fmul_rn(ew[i], d));
  }
  const float total = block_sum(acc, sm);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + kMaxBlocks);
  if (threadIdx.x == 0) {
    scratch[blockIdx.x] = total;
    __threadfence();                 // the partial is visible before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) __threadfence();       // and the partials' reads after it
  }
  __syncthreads();
  if (!last) return;
  // Every other block's partial is in L2 (fenced before its ticket);
  // __ldcg reads there, past this SM's L1.
  float sum = 0.0f;
  for (int b = threadIdx.x; b < gridDim.x; b += kBlock)
    sum = __fadd_rn(sum, __ldcg(scratch + b));
  const float j = block_sum(sum, sm);
  if (threadIdx.x == 0) {
    out[0] = j;
    *ticket = 0u;
  }
}

template <int FORM>
void launch(const int* eu, const int* ev, const float* ew, int E,
            const int* perm, int n, int B, bool shared, const void* D,
            const FormParams& f, float* scratch, int nb, float* out,
            cudaStream_t stream) {
  if (shared)
    objective<FORM, true><<<dim3(nb, B), kBlock, 0, stream>>>(
        eu, ev, ew, E, perm, n, D, f, scratch, out);
  else
    objective<FORM, false><<<dim3(nb, B), kBlock, 0, stream>>>(
        eu, ev, ew, E, perm, n, D, f, scratch, out);
}

}  // namespace
}  // namespace viem

extern "C" {

// out[b] = Σ_e ew[b·E + e] · D(π_b(eu[b·E + e]), π_b(ev[b·E + e])), π_b
// the n entries of perm at b·n, for B lanes in one launch of ``nb``
// blocks a lane (1 <= nb <= kMaxBlocks); with ``shared`` = 1 every lane
// reads the one edge list eu, ev, ew at offset 0.  ``scratch`` holds B ·
// (kMaxBlocks + 1) floats, each lane's counter 0 (zero-filled before the
// first launch; each launch leaves them 0), and is used by one stream at
// a time.  ``f`` points at the host's FormParams of ``f_bytes`` bytes.
// Returns a cudaError_t code.
int viem_qap_objective(const int* eu, const int* ev, const float* ew, int E,
                       const int* perm, int n, int B, int shared,
                       const void* D, int form, const viem::FormParams* f,
                       int f_bytes, float* scratch, int nb, float* out,
                       void* stream) {
  if (E < 0 || n < 0 || B < 1 || B > 65535 || nb < 1 ||
      (shared != 0 && shared != 1) ||
      nb > viem::kMaxBlocks ||
      f_bytes != static_cast<int>(sizeof(viem::FormParams)) ||
      f->nlev < 0 || f->nlev > viem::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VIEM_LAUNCH(FORM) \
  viem::launch<FORM>(eu, ev, ew, E, perm, n, B, shared != 0, D, *f, \
                     scratch, nb, out, s)
  switch (form) {
    case viem::kTree: VIEM_LAUNCH(viem::kTree); break;
    case viem::kTorus: VIEM_LAUNCH(viem::kTorus); break;
    case viem::kMatF32: VIEM_LAUNCH(viem::kMatF32); break;
    case viem::kMatI8: VIEM_LAUNCH(viem::kMatI8); break;
    case viem::kMatI16: VIEM_LAUNCH(viem::kMatI16); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VIEM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

const char* viem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
