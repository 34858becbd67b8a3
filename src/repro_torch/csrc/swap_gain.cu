// K3 — the dense pair-exchange gain matrix of the QAP:
//
//   G[u,v] = d[u] + d[v] − (M[u,v] + M[v,u]) − 2·C[u,v]·B[u,v],  G[u,u] = 0
//
// with B[u,v] = D[π(u), π(v)], M = C·Bᵀ and d = rowsum(C∘B) = diag(M).
// G[u,v] > 0 ⇔ swapping the PEs of u and v lowers the objective by it.
//
// Replaces: src/repro/kernels/swap_gain.py — swap_gain_matrix, body
// _swap_gain_kernel.  The TPU version pads n to a tile multiple and runs
// a sequential (i, j, k) grid of 128×128 tiles, accumulating both
// products, both row dots and the k == j correction tile in VMEM scratch
// across k.
//
// Bound on the H100: operations.  The least work for G is one n×n×n
// product (M[v,u] = Mᵀ[u,v]): 2n³ flop, 2.05 ms at n = 4096 on the
// 67 TFLOP/s fp32 CUDA cores; C, B and G are 3·n²·4 bytes (0.06 ms at
// 3.35 TB/s).  This kernel does the reference's two products, 4n³.
//
// Design (simple and correct first):
//   * row_dot — d[i] = Σ_k C[i,k]·B[i,k], one warp per row, lanes
//     striding k, then a fixed shuffle tree (deterministic).
//   * gain_tile — one block of 256 threads owns one 64×64 tile of G
//     and loops over k inside the block (blocks run in no order, so
//     nothing is carried between them).  Per 16-wide k-slab it stages the
//     C and B rows of the i-tile and of the j-tile in shared memory, k-major
//     so a thread reads its 4 rows and 4 columns as float4s; each thread
//     accumulates a 4×4 micro-tile of M[i,j] + M[j,i] in registers with
//     explicit __fmaf_rn (the library is built with --fmad=false, which
//     would otherwise split every multiply-add).  fp32 CUDA-core FMA only:
//     no tensor cores, no TF32, so G stays a float32 sum like the
//     reference's.  The ragged edge is masked (zero-filled loads, guarded
//     stores) instead of padding n; row offsets are 64-bit.
//   * Epilogue: G = d_i + d_j − acc − 2·C[i,j]·B[i,j], diagonal 0.
// Integer C and B (every product and partial sum an integer below 2²⁴)
// give the exact result in any order.
//
// Later work, not done here: one product instead of two (M[j,i] from the
// transposed tile of the same M), only the upper triangle (G is
// symmetric), 3xTF32 wgmma with a stated tolerance, TMA-fed multi-stage
// shared-memory rings, and fusing the B gather from D and π.
#include <cuda_runtime.h>

#include <cstddef>

namespace viem {
namespace {

constexpr int kTile = 64;               // output tile edge
constexpr int kSlab = 16;               // k-slab depth per stage
constexpr int kThreads = 256;           // 16×16 threads, 4×4 outputs each
constexpr int kMicro = 4;
constexpr int kPad = kTile + 4;         // row stride of a staged slab:
                                        // keeps float4 reads aligned and
                                        // spreads the transposing stores
constexpr int kRowWarps = 8;            // rows per row_dot block

__global__ void __launch_bounds__(kRowWarps * 32)
row_dot(const float* __restrict__ C, const float* __restrict__ B, int n,
        float* __restrict__ d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const size_t base = static_cast<size_t>(row) * n;
  float s = 0.0f;
  for (int k = lane; k < n; k += 32)
    s = __fmaf_rn(C[base + k], B[base + k], s);
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if (lane == 0) d[row] = s;
}

// Stage rows [r0, r0 + 64) × columns [k0, k0 + 16) of X into dst[k][r]
// (k-major), zero outside the n×n matrix.
__device__ __forceinline__ void stage(const float* __restrict__ X, int n,
                                      int r0, int k0,
                                      float (*dst)[kPad]) {
#pragma unroll
  for (int s = 0; s < (kTile * kSlab) / kThreads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int r = e / kSlab;
    const int k = e % kSlab;
    const int gr = r0 + r;
    const int gk = k0 + k;
    dst[k][r] = (gr < n && gk < n)
                    ? X[static_cast<size_t>(gr) * n + gk] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
gain_tile(const float* __restrict__ C, const float* __restrict__ B, int n,
          const float* __restrict__ d, float* __restrict__ G) {
  __shared__ __align__(16) float ci[kSlab][kPad];
  __shared__ __align__(16) float bi[kSlab][kPad];
  __shared__ __align__(16) float cj[kSlab][kPad];
  __shared__ __align__(16) float bj[kSlab][kPad];

  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;        // column group
  const int ty = threadIdx.x / 16;        // row group

  float acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += kSlab) {
    stage(C, n, i0, k0, ci);
    stage(B, n, i0, k0, bi);
    stage(C, n, j0, k0, cj);
    stage(B, n, j0, k0, bj);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlab; ++k) {
      const float4 cr = *reinterpret_cast<const float4*>(&ci[k][ty * kMicro]);
      const float4 br = *reinterpret_cast<const float4*>(&bi[k][ty * kMicro]);
      const float4 cc = *reinterpret_cast<const float4*>(&cj[k][tx * kMicro]);
      const float4 bc = *reinterpret_cast<const float4*>(&bj[k][tx * kMicro]);
      const float c_row[kMicro] = {cr.x, cr.y, cr.z, cr.w};
      const float b_row[kMicro] = {br.x, br.y, br.z, br.w};
      const float c_col[kMicro] = {cc.x, cc.y, cc.z, cc.w};
      const float b_col[kMicro] = {bc.x, bc.y, bc.z, bc.w};
#pragma unroll
      for (int a = 0; a < kMicro; ++a)
#pragma unroll
        for (int b = 0; b < kMicro; ++b) {
          acc[a][b] = __fmaf_rn(c_row[a], b_col[b], acc[a][b]);
          acc[a][b] = __fmaf_rn(b_row[a], c_col[b], acc[a][b]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty * kMicro + a;
    if (i >= n) continue;
    const size_t row = static_cast<size_t>(i) * n;
    const float di = d[i];
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int j = j0 + tx * kMicro + b;
      if (j >= n) continue;
      const float corr = __fmul_rn(2.0f, __fmul_rn(C[row + j], B[row + j]));
      const float g = __fsub_rn(__fsub_rn(__fadd_rn(di, d[j]), acc[a][b]),
                                corr);
      G[row + j] = i == j ? 0.0f : g;
    }
  }
}

}  // namespace
}  // namespace viem

extern "C" {

// G (n×n, row-major float32) from C and B (n×n, row-major float32);
// d is an n-float scratch the caller allocates.  Two launches on
// `stream`.  Returns a cudaError_t code.
int viem_swap_gain_matrix(const float* C, const float* B, int n, float* d,
                          float* G, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (n + viem::kRowWarps - 1) / viem::kRowWarps;
  viem::row_dot<<<row_blocks, viem::kRowWarps * 32, 0, s>>>(C, B, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + viem::kTile - 1) / viem::kTile;
  viem::gain_tile<<<dim3(tiles, tiles), viem::kThreads, 0, s>>>(C, B, n, d,
                                                                 G);
  return static_cast<int>(cudaGetLastError());
}

const char* viem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
