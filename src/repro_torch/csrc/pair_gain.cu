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
// 3.35 TB/s is ~6.6 µs.  What it costs instead is instructions and
// dependent gathers: 2 sides × K slots, each a π gather behind a row
// load, then two distances.
//
// Design.  One thread per pair does every gather itself — us/vs (the
// only streamed bytes, coalesced), π, both neighbor rows and the
// distances — so none of the (P, K) intermediates the TPU wrapper
// materialized ever reaches device memory.
//   - No division: the closed forms take quotients through the host's
//     fixed-point reciprocals (distance.cuh).  Dividing by the runtime
//     strides in every oracle call, as the first version of this kernel
//     did, costs up to 128 divisions a pair in the main cell, ~60 % of
//     that version's time in the tree form (PERF.md).
//   - The pair's own keys (π_u's and π_v's ancestors, or torus
//     coordinates) are computed once, before the slot loops, into
//     registers; each slot computes only its target's keys and compares
//     them with both.
//   - Rows are read four slots at a time, 16-byte loads through the
//     read-only path, and the four π gathers of a group are issued
//     together.  The wrapper pads rows to K % 4 == 0 with inert
//     zero-weight slots.
// Pairs arrive in (u, v) order with ~445 pairs per u, so a warp's u
// side reads one row: those loads are broadcasts.
//
// Where it stands (H100, main shape): 0.053 ms in the tree form, ~12 %
// of the bound (how the rest splits between the remaining instructions
// and the gathers' latency is not measured); the int8 table form 0.23
// ms, which divides by nothing: its two table gathers a slot, into a
// 16 MiB table that lives in L2, hold it.
//
// Lanes: one launch covers B independent instances, gridDim.y = B, in
// one of two layouts.  Stacked lanes (a batch of graphs under one
// machine): lane b reads nbr/wgt at b·n·K, π at b·n and us/vs at b·P.
// A shared graph (the portfolio's restart lanes of one graph): nbr, wgt,
// us and vs are read by every lane at offset 0, and only π (at b·n)
// differs.  Either way lane b writes out at b·P, and the machine's D is
// shared.  A single call is B = 1, in the instance whose lane offsets are
// a compile-time 0 (the offsets cost the tree form 3 % a launch).  This
// is the port's counterpart of jax.vmap over the Pallas call
// (engine/sweep.py), which adds a grid axis on the TPU, with in_axes=None
// for the shared arrays; each lane's bits equal a launch of that lane
// alone, since a pair's arithmetic never looks outside its own lane.
//
// Order: each side is reduced over its K slots in order, then the two
// sides are added — the reference's order.  The `k != other` exclusion
// is folded into the weight.  Padding pairs (u, u) give exactly 0:
// every term is w · (d − d).
#include "distance.cuh"

namespace viem {
namespace {

constexpr int kBlock = 256;

template <int FORM, int L>
__device__ __forceinline__ float side_gain(
    const int* __restrict__ row, const float* __restrict__ wrow, int K,
    int other, const int* __restrict__ perm, int pa, const int* ka, int pb,
    const int* kb, const void* __restrict__ D, const FormParams& f,
    float top) {
  float s = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 4) {
    const int4 nb = __ldg(reinterpret_cast<const int4*>(row + k0));
    const float4 wv = __ldg(reinterpret_cast<const float4*>(wrow + k0));
    const int node[4] = {nb.x, nb.y, nb.z, nb.w};
    const float w[4] = {wv.x, wv.y, wv.z, wv.w};
    int t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = __ldg(perm + node[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float wj = node[j] == other ? 0.0f : w[j];
      const float d = delta_keyed<FORM, L>(f, top, D, pa, ka, pb, kb, t[j]);
      s = __fadd_rn(s, __fmul_rn(wj, d));
    }
  }
  return s;
}

// The lane layouts.  kOneLane is a launch of one lane (B = 1, every
// single call): its lane offsets are a compile-time 0 and the pointers
// are used as given, which keeps the lane axis out of the single call's
// time.  kStacked offsets every per-graph array by its lane; kShared
// only π and the output.
enum Lanes { kOneLane, kStacked, kShared };

template <int FORM, int L, int LANES>
__global__ void __launch_bounds__(kBlock)
pair_gains(const int* __restrict__ nbr, const float* __restrict__ wgt, int K,
           int n, const int* __restrict__ perm, const int* __restrict__ us,
           const int* __restrict__ vs, int P, const void* __restrict__ D,
           const __grid_constant__ FormParams f, float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= P) return;
  if constexpr (LANES == kStacked) {
    const size_t lane = blockIdx.y;
    nbr = lane_base(nbr, lane * n * K);
    wgt = lane_base(wgt, lane * n * K);
    perm = lane_base(perm, lane * n);
    us += lane * P;
    vs += lane * P;
    out += lane * P;
  } else if constexpr (LANES == kShared) {
    const size_t lane = blockIdx.y;
    perm = lane_base(perm, lane * n);
    out += lane * P;
  }
  const int u = us[i];
  const int v = vs[i];
  const int pu = __ldg(perm + u);
  const int pv = __ldg(perm + v);
  int ku[L], kv[L];
  keys_of<FORM, L>(f, pu, ku);
  keys_of<FORM, L>(f, pv, kv);
  const size_t ru = static_cast<size_t>(u) * K;
  const size_t rv = static_cast<size_t>(v) * K;
  const float top = top_distance(f);
  const float sa = side_gain<FORM, L>(nbr + ru, wgt + ru, K, v, perm, pu, ku,
                                      pv, kv, D, f, top);
  const float sb = side_gain<FORM, L>(nbr + rv, wgt + rv, K, u, perm, pv, kv,
                                      pu, ku, D, f, top);
  out[i] = __fadd_rn(sa, sb);
}

// A closed form of at most 4 levels (every preset machine) takes the
// instance whose key arrays hold 4 registers, not 16: 39–40 registers a
// thread against 64, and less time at the main shape (PERF.md).  Matrix
// forms have no keys.
constexpr int kFewLevels = 4;

template <int FORM, int LANES>
void launch(const int* nbr, const float* wgt, int K, int n, const int* perm,
            const int* us, const int* vs, int P, int B, const void* D,
            const FormParams& f, float* out, cudaStream_t stream) {
  const dim3 grid((P + kBlock - 1) / kBlock, B);
  if (FORM >= kMatF32 || f.nlev <= kFewLevels)
    pair_gains<FORM, kFewLevels, LANES><<<grid, kBlock, 0, stream>>>(
        nbr, wgt, K, n, perm, us, vs, P, D, f, out);
  else if constexpr (FORM < kMatF32)
    pair_gains<FORM, kMaxLevels, LANES><<<grid, kBlock, 0, stream>>>(
        nbr, wgt, K, n, perm, us, vs, P, D, f, out);
}

template <int FORM>
void launch(const int* nbr, const float* wgt, int K, int n, const int* perm,
            const int* us, const int* vs, int P, int B, bool shared,
            const void* D, const FormParams& f, float* out,
            cudaStream_t stream) {
  if (B == 1)
    launch<FORM, kOneLane>(nbr, wgt, K, n, perm, us, vs, P, B, D, f, out,
                           stream);
  else if (shared)
    launch<FORM, kShared>(nbr, wgt, K, n, perm, us, vs, P, B, D, f, out,
                          stream);
  else
    launch<FORM, kStacked>(nbr, wgt, K, n, perm, us, vs, P, B, D, f, out,
                           stream);
}

}  // namespace
}  // namespace viem

extern "C" {

// out[b·P + i] = gain of swapping us[b·P + i] and vs[b·P + i] under lane
// b's π, for B lanes of n vertices, P pairs and K slots each; with
// ``shared`` = 1 every lane reads the one graph (nbr, wgt) and pair list
// (us, vs) at offset 0.  K % 4 == 0 and nbr, wgt 16-byte aligned; ``f``
// points at the host's FormParams of ``f_bytes`` bytes.  Returns a
// cudaError_t code.
int viem_pair_gains(const int* nbr, const float* wgt, int K, int n,
                    const int* perm, const int* us, const int* vs, int P,
                    int B, int shared, const void* D, int form,
                    const viem::FormParams* f, int f_bytes, float* out,
                    void* stream) {
  if (P < 0 || K < 0 || K % 4 != 0 || n < 0 || B < 1 || B > 65535 ||
      (shared != 0 && shared != 1) ||
      reinterpret_cast<uintptr_t>(nbr) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wgt) % 16 != 0 ||
      f_bytes != static_cast<int>(sizeof(viem::FormParams)) ||
      f->nlev < 0 || f->nlev > viem::kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VIEM_LAUNCH(FORM) \
  viem::launch<FORM>(nbr, wgt, K, n, perm, us, vs, P, B, shared != 0, D, \
                     *f, out, s)
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
