// K3 — the dense pair-exchange gain matrix of the QAP, on Hopper's tensor
// cores (sm_90a):
//
//   G[u,v] = d[u] + d[v] − S[u,v] − 2·C[u,v]·B[u,v],  G[u,u] = 0
//
// with B[u,v] = D[π(u), π(v)], M = C·Bᵀ, S = M + Mᵀ and d = rowsum(C∘B)
// = diag(M).  G[u,v] > 0 ⇔ swapping the PEs of u and v lowers the
// objective by it.
//
// Replaces: src/repro/kernels/swap_gain.py — swap_gain_matrix, body
// _swap_gain_kernel.  The TPU version pads n to a tile multiple and runs
// a sequential (i, j, k) grid of 128×128 tiles over all (i, j),
// accumulating both products, both row dots and the k == j correction
// tile in VMEM scratch across k: 4n³ flop.
//
// Bound on the H100: operations.  The useful work is one n×n×n product,
// 2n³ flop: S[I,J] = C_I·B_Jᵀ + B_I·C_Jᵀ needs both products only for the
// upper triangle of tiles, whose transposes give the rest.  On the
// tensor cores at their 495 TFLOP/s TF32 peak that is 0.278 ms at n =
// 4096, the least any tensor-core scheme needs.  The 3xTF32 split this
// kernel uses issues three TF32 products per product, 3·2n³ flop: 0.833
// ms at the same peak, the floor of this design (the same 2n³ on the 67
// TFLOP/s fp32 CUDA cores: 2.05 ms).  C, B and G are 3·n²·4 bytes, 0.06
// ms at 3.35 TB/s.
//
// Tolerance contract.  Every operand value x is split into big =
// rna_tf32(x) and small = rna_tf32(x − big), and each product c·b is
// taken as big·big + big·small + small·big on the tensor cores, summed
// in float32 (a pair of steps at a time there, the pairs with
// __fadd_rn).  G is exact (equal to the float64 formula) whenever every B
// entry fits TF32 (≤ 11 significant bits), every C entry is an integer
// below 2²², and every |C|·|B|ᵀ sum is below 2²⁴: then small_b = 0, c =
// big_c + small_c exactly with both parts in TF32, so every product is
// kept whole and every partial sum is an integer float32 holds.  All
// integer instances the repository holds K3 to are of that kind.  On real
// data each entry stays within 2⁻¹⁸·S(u,v) of the exact G, with S(u,v) =
// (|C|·|B|ᵀ)_uu + (..)_vv + (..)_uv + (..)_vu + 2·|C_uv·B_uv|
// (kernels/ref.py:swap_gain_limits): the dropped small·small term and
// the split's own rounding are ~2⁻²² relative, the float32 sums a few
// 2⁻²⁴.  G is bit-symmetric whenever C and B are symmetric: G[u,v] and
// G[v,u] come from the same S entry.
//
// Design:
//   * row_dot — d[i] = Σ_k C[i,k]·B[i,k], one warp per row, lanes
//     striding k, then a fixed shuffle tree: exact float32 FMAs on the
//     CUDA cores, so d keeps the plain version's kind of rounding.
//   * gain_tile — one block of 256 threads (two warpgroups of 64 rows of
//     I each) per output tile (I, J), I ≤ J, 128×128; the linear block
//     index walks the upper triangle row by row, so neighbouring blocks
//     share the I rows (and, within a wave, every block streams the same
//     k-slab of the J rows) through L2.  No producer warp: a ninth warp
//     would put three warps on one of the SM's four register files and
//     cap every thread at 168 registers (ptxas then spills this loop);
//     at eight warps the loop keeps 223 without spills.
//   * One K-loop of depth 2n over the stacked operands [C_I | B_I] and
//     [B_J | C_J]: S[I,J] = C_I·B_Jᵀ + B_I·C_Jᵀ in one float32 total (64
//     floats a thread).  Rows of C and B are K-major already, as wgmma's
//     tf32 form requires for both operands.
//   * TMA: two 2-D tensor maps over C and B (n columns × n rows, row
//     stride ld·4 bytes, ld a multiple of 4), boxes of 32 columns (one
//     128-byte swizzle row) × 128 rows; columns and rows past n come in
//     as zeros, which add zero to every term.  A ring of kStages steps,
//     each the A box (C_I or B_I) and the B box (B_J or C_J) with a full
//     barrier (TMA transaction bytes).  Thread 0 refills a stage right
//     after the block barrier that ends its use.
//   * The split, two ways.  A (this warpgroup's 64 rows) is read from the
//     swizzled tile straight into wgmma's tf32 register fragment (rows r
//     and r + 8, columns c and c + 4 of each k8 step; conflict-free) and
//     split in registers, so wgmma takes A from registers.  B (the 128
//     shared rows) is split in shared memory: each warpgroup overwrites
//     its half of the landed fp32 values with big in place and writes
//     small to a buffer with the same swizzled layout (one descriptor
//     offset serves both; the hardware would truncate fp32 to TF32, not
//     round it, so both parts must exist as their own values), then
//     fences the writes to the async proxy.  The split rounds in integer
//     arithmetic, (bits + 2¹²) & ~(2¹³ − 1): cvt.rna.tf32.f32 for every
//     finite value, at a fraction of the conversion's cost.
//   * wgmma m64n128k8 tf32: per k8 step big·big, big·small, small·big.
//     A k8 step is 32 bytes inside the 128-byte swizzled row of B; SBO
//     1024 bytes between 8-row groups; all tiles on 1024-byte boundaries.
//   * Steps go in pairs: the odd step's products queue behind the even
//     one's in one accumulator, so the tensor cores drain once a pair;
//     each step's operands are split while the previous step's products
//     run, and the block meets once a step.
//   * The tensor cores' float32 accumulation is not round-to-nearest: an
//     accumulator carried through the whole K-loop drifts toward zero,
//     past twice the per-element limit at n = 1000 on an H100, as a
//     model that truncates after every wgmma predicts.  So each pair's
//     24 products start a fresh accumulator, and the warpgroup adds it
//     into the float32 total with __fadd_rn once they have completed (as
//     FP8 GEMMs promote partial sums): the drift is then that of one
//     pair's sum.
//   * Epilogue: S goes through shared memory (row stride 129 floats, so
//     row and column reads are both free of bank conflicts), then all 256
//     threads write G[I,J] and, when I ≠ J, G[J,I] = its transpose from
//     the same S, each row by consecutive threads: both stores coalesced.
//     A diagonal tile reads S[min, max] for both of its halves.  G =
//     ((d_u + d_v) − S) − 2·(C·B) with _rn intrinsics (the library is
//     built with --fmad=false), diagonal 0.
//   * No atomics and a fixed order of every sum: two runs give equal bits.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace viem {
namespace {

constexpr int kTile = 128;              // output tile edge (rows of I, J)
constexpr int kSlab = 32;               // fp32 k-columns per step
constexpr int kStages = 4;              // TMA ring depth
constexpr int kThreads = 256;           // two consumer warpgroups
constexpr uint32_t kBoxBytes = kTile * kSlab * 4;    // 128 rows × 128 B
constexpr uint32_t kHalfBox = kBoxBytes / 2;         // 64 rows
constexpr int kEpiStride = kTile + 1;   // floats per staged row of S
constexpr int kRowWarps = 8;            // rows per row_dot block
// the ring (a stage: the A box, C_I or B_I, then the B box, B_J or C_J),
// three buffers of the B box's small parts, the barriers, and slack to
// align the tiles to the 1024 bytes the swizzle repeats over
constexpr uint32_t kRingBytes = kStages * 2 * kBoxBytes;
constexpr int kSmallBufs = 3;           // steps whose B small parts live:
                                        // a pair in use, the next being split
constexpr uint32_t kSmallBytes = kSmallBufs * kBoxBytes;
constexpr size_t kSmem = kRingBytes + kSmallBytes + kStages * 8 + 1024;
static_assert(kTile * kEpiStride * 4 <= kRingBytes,
              "the epilogue's staged S reuses the ring");

__global__ void __launch_bounds__(kRowWarps * 32)
row_dot(const float* __restrict__ C, const float* __restrict__ B, int n,
        int ld, float* __restrict__ d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const size_t base = static_cast<size_t>(row) * ld;
  float s = 0.0f;
  for (int k = lane; k < n; k += 32)
    s = __fmaf_rn(C[base + k], B[base + k], s);
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if (lane == 0) d[row] = s;
}

// ---------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// ------------------------------------------------------------ 3xTF32
// cvt.rna.tf32.f32 in integer arithmetic: the TF32 value nearest to x,
// ties away from zero, low 13 bits clear (half a TF32 ulp added to the
// magnitude, then truncated; exact for every finite x)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x → big = rna(x), small = rna(x − big)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(__fsub_rn(x, __uint_as_float(big)));
}

// four fp32 values at `at` become their big parts in place; their small
// parts go to `small`
__device__ __forceinline__ void split4(float4* at, float4* small) {
  const float4 x = *at;
  uint4 b, s;
  split(x.x, b.x, s.x);
  split(x.y, b.y, s.y);
  split(x.z, b.z, s.z);
  split(x.w, b.w, s.w);
  *reinterpret_cast<uint4*>(at) = b;
  *reinterpret_cast<uint4*>(small) = s;
}

// d (64×128) (+)= A·Bᵀ, A (64×8 tf32) in registers, B (128×8 tf32)
// K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t* a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" VIEM_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : VIEM_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
gain_tile(const __grid_constant__ CUtensorMap tc,
          const __grid_constant__ CUtensorMap tb,
          const float* __restrict__ C, const float* __restrict__ B, int n,
          int ld, int tiles, const float* __restrict__ d,
          float* __restrict__ G) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* const base_ptr = smem_raw + pad;
  // stage s: A box at ring + 2s·box, B box right after it; the small
  // parts of step i's B box in small buffer i % kSmallBufs
  const uint32_t ring = raw + pad;
  const uint32_t small = ring + kRingBytes;
  const uint32_t bars = small + kSmallBytes;
  const auto full = [&](int s) { return bars + 8u * s; };

  // the upper triangle, row by row: block → (I, J), I ≤ J
  int I = 0, rem = blockIdx.x;
  while (rem >= tiles - I) {
    rem -= tiles - I;
    ++I;
  }
  const int J = I + rem;
  const int slabs = (n + kSlab - 1) / kSlab;    // per half of the K-loop
  const int steps = 2 * slabs;

  // thread 0 loads step i into stage i % kStages (which is free: the
  // block has finished step i − kStages)
  const auto load = [&](int i) {
    const int s = i % kStages;
    const bool first = i < slabs;       // C_I·B_Jᵀ, then B_I·C_Jᵀ
    const int col = (first ? i : i - slabs) * kSlab;
    const uint32_t a_box = ring + 2 * s * kBoxBytes;
    mbar_expect_tx(full(s), 2 * kBoxBytes);
    tma_load_2d(a_box, first ? &tc : &tb, full(s), col, I * kTile);
    tma_load_2d(a_box + kBoxBytes, first ? &tb : &tc, full(s), col,
                J * kTile);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages && i < steps; ++i) load(i);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  // A fragment of a k8 step (wgmma's tf32 register layout): rows r0 and
  // r0 + 8 of this warpgroup's 64, columns 8kk + lane % 4 (+ 4); in the
  // 128-byte swizzle, the 16-byte chunk c of row r sits at c ^ (r % 8)
  const uint32_t a_row = static_cast<uint32_t>(
      (64 * wg + 16 * (tid / 32) + lane / 4) * 128 + (lane % 4) * 4);
  const uint32_t a_xor = static_cast<uint32_t>(lane / 4);

  // wait for stage i and split this warpgroup's half of its B box in
  // shared memory (the other half is the other warpgroup's)
  const auto split_b = [&](int i) {
    const int s = i % kStages;
    mbar_wait(full(s), (i / kStages) & 1);
    uint8_t* const b_box = base_ptr + (2 * s + 1) * kBoxBytes + wg * kHalfBox;
    uint8_t* const b_small = base_ptr + kRingBytes +
                             (i % kSmallBufs) * kBoxBytes + wg * kHalfBox;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int off = (tid + 128 * r) * 16;
      split4(reinterpret_cast<float4*>(b_box + off),
             reinterpret_cast<float4*>(b_small + off));
    }
    fence_async_smem();                 // visible to wgmma's reads
  };
  // this thread's 16 fp32 A values of stage i (stage i has landed)
  const auto load_a = [&](int i, float (&x)[16]) {
    const uint8_t* const a_box = base_ptr + 2 * (i % kStages) * kBoxBytes;
#pragma unroll
    for (int kk = 0; kk < kSlab / 8; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {     // column 8kk + lane % 4 (+ 4)
        const uint32_t off = a_row + ((2 * kk + h) ^ a_xor) * 16;
        x[4 * kk + 2 * h] = *reinterpret_cast<const float*>(a_box + off);
        x[4 * kk + 2 * h + 1] =
            *reinterpret_cast<const float*>(a_box + off + 8 * 128);
      }
  };
  // x holds a0..a3 of each k8 step in order: (r0, c), (r0 + 8, c),
  // (r0, c + 4), (r0 + 8, c + 4)
  const auto split_a = [&](const float (&x)[16], uint32_t (&big)[16],
                           uint32_t (&sm)[16]) {
#pragma unroll
    for (int kk = 0; kk < kSlab / 8; ++kk) {
      split(x[4 * kk + 0], big[4 * kk + 0], sm[4 * kk + 0]);
      split(x[4 * kk + 1], big[4 * kk + 1], sm[4 * kk + 1]);
      split(x[4 * kk + 2], big[4 * kk + 2], sm[4 * kk + 2]);
      split(x[4 * kk + 3], big[4 * kk + 3], sm[4 * kk + 3]);
    }
  };

  // this warpgroup's products of step i (A fragments in registers)
  const auto mma = [&](int i, float (&acc)[64], const uint32_t (&big)[16],
                       const uint32_t (&sm)[16], bool fresh) {
    const uint32_t b_big = ring + (2 * (i % kStages) + 1) * kBoxBytes;
    const uint32_t b_sm = small + (i % kSmallBufs) * kBoxBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlab / 8; ++kk) {
      const uint64_t bb = sw128_desc(b_big + kk * 32, 16, 1024);
      wgmma_tf32(acc, &big[4 * kk], bb, !fresh || kk > 0);
      wgmma_tf32(acc, &big[4 * kk], sw128_desc(b_sm + kk * 32, 16, 1024),
                 1);
      wgmma_tf32(acc, &sm[4 * kk], bb, 1);
    }
    wgmma_commit();
  };

  // acc: a pair of steps' products on the tensor cores; total: their sum
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = 0.0f;
  float x[16];
  uint32_t big0[16], sm0[16], big1[16], sm1[16];

  split_b(0);
  load_a(0, x);
  split_a(x, big0, sm0);
  __syncthreads();
  // steps in pairs (steps is even): the products of the odd step queue
  // behind the even one's, so the tensor cores drain once a pair
  for (int i = 0; i < steps; i += 2) {
    mma(i, acc, big0, sm0, true);       // a fresh sum for each pair
    split_b(i + 1);                     // overlaps the products of i
    load_a(i + 1, x);
    split_a(x, big1, sm1);
    __syncthreads();                    // both halves of B(i + 1) split
    mma(i + 1, acc, big1, sm1, false);
    if (i + 2 < steps) {                // overlaps the products of i + 1
      split_b(i + 2);
      load_a(i + 2, x);
    }
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(big0);
    fence_regs(sm0);
    fence_regs(big1);
    fence_regs(sm1);
#pragma unroll
    for (int j = 0; j < 64; ++j) total[j] = __fadd_rn(total[j], acc[j]);
    if (i + 2 < steps) split_a(x, big0, sm0);
    // both warpgroups: B(i + 2) split, the products of i and i + 1 done
    // (so stages i and i + 1 may be refilled)
    __syncthreads();
    if (threadIdx.x == 0) {
      if (i + kStages < steps) load(i + kStages);
      if (i + 1 + kStages < steps) load(i + 1 + kStages);
    }
  }

  // ---------------------------------------------------------- epilogue
  // S through shared memory, in the ring (every stage of it has been
  // consumed, and no load is in flight): element j of total is
  // row 16·warp + lane / 4 (+ 8 when j & 2), column 8·(j / 4) +
  // 2·(lane % 4) + (j & 1) of this warpgroup's 64×128 tile
  float* const st = reinterpret_cast<float*>(base_ptr);
  {
    const int lane = tid % 32;
    const int r0 = 64 * wg + 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int r = r0 + ((j & 2) ? 8 : 0);
      const int c = c0 + 8 * (j / 4) + (j & 1);
      st[r * kEpiStride + c] = total[j];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;            // 0..255
  const int i0 = I * kTile;
  const int j0 = J * kTile;
  // G[I,J] (a diagonal tile reads S[min, max] for both halves)
  for (int e = t; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile;
    const int c = e % kTile;
    const int i = i0 + r;
    const int j = j0 + c;
    if (i >= n || j >= n) continue;
    const float s = (I == J && r > c) ? st[c * kEpiStride + r]
                                      : st[r * kEpiStride + c];
    const size_t at = static_cast<size_t>(i) * ld + j;
    const float corr = __fmul_rn(2.0f, __fmul_rn(C[at], B[at]));
    const float g = __fsub_rn(__fsub_rn(__fadd_rn(d[i], d[j]), s), corr);
    G[static_cast<size_t>(i) * n + j] = i == j ? 0.0f : g;
  }
  if (I == J) return;
  // G[J,I] from the same S
  for (int e = t; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile;            // row of the J tile
    const int c = e % kTile;            // column of the I tile
    const int j = j0 + r;
    const int i = i0 + c;
    if (i >= n || j >= n) continue;
    const float s = st[c * kEpiStride + r];
    const size_t at = static_cast<size_t>(j) * ld + i;
    const float corr = __fmul_rn(2.0f, __fmul_rn(C[at], B[at]));
    G[static_cast<size_t>(j) * n + i] =
        __fsub_rn(__fsub_rn(__fadd_rn(d[j], d[i]), s), corr);
  }
}

// an (n, n) float32 matrix with row stride ld as 2-D boxes of 32 columns
// × 128 rows, 128-byte swizzle, zeros outside
bool encode(EncodeTiled fn, CUtensorMap* map, const float* ptr, int n,
            int ld) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {kSlab, kTile};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace viem

extern "C" {

// G (n×n, row-major float32, row stride n) from C and B (n×n float32,
// row stride ld: ld ≥ n, ld % 4 == 0, both 16-byte aligned); d is an
// n-float scratch the caller allocates.  Two launches on `stream`.
// Returns a cudaError_t code.
int viem_swap_gain_matrix(const float* C, const float* B, int n, int ld,
                          float* d, float* G, void* stream) {
  if (n < 0 || ld < n || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(C) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const viem::EncodeTiled fn = viem::encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tc, tb;
  if (!viem::encode(fn, &tc, C, n, ld) || !viem::encode(fn, &tb, B, n, ld))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (n + viem::kRowWarps - 1) / viem::kRowWarps;
  viem::row_dot<<<row_blocks, viem::kRowWarps * 32, 0, s>>>(C, B, n, ld, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // above 48 KB only after this opt-in, which is per device
  err = cudaFuncSetAttribute(viem::gain_tile,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(viem::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + viem::kTile - 1) / viem::kTile;
  viem::gain_tile<<<tiles * (tiles + 1) / 2, viem::kThreads, viem::kSmem,
                    s>>>(tc, tb, C, B, n, ld, tiles, d, G);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory of one gain_tile block, in bytes
int viem_swap_gain_smem() { return static_cast<int>(viem::kSmem); }

const char* viem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
