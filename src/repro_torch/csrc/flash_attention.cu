// K4, float32 route — causal / sliding-window GQA flash attention,
// forward, at float32, on Hopper's tensor cores (sm_90a) through a
// 3xTF32 split:
//
//   o[b,t,h] = Σ_s softmax_s(q[b,t,h]·k[b,s,h/G]·hd^-½ | mask) · v[b,s,h/G]
//
// with q (B,T,H,hd), k and v (B,S,KV,hd), S = T, G = H/KV, all float32
// and contiguous, hd ∈ {32, 64, 96, 128}, and the mask t ≥ s (causal),
// also t − s < window when window > 0.  Masked scores are −1e30; the
// online softmax (running max m, running sum l of the unrounded p,
// accumulator acc) is float32; o = acc / max(l, 1e-30).  bfloat16 inputs
// go to csrc/flash_attention_sm90.cu.
//
// Replaces: src/repro/kernels/flash_attention.py — flash_attention_kernel
// (`_flash_fwd`, body `_flash_kernel`, `pl.pallas_call` at :94), for
// float32 inputs.  The TPU version runs a grid (B·KV·G, q blocks, kv
// blocks) whose kv axis is sequential, carries m, l and acc across it in
// VMEM scratch, expands GQA through its k/v index map and halves a block
// size until it divides T.
//
// Tolerance contract.  The tensor cores take TF32 (10 stored mantissa
// bits) and truncate float32 operands to it, so one TF32 pass would give
// q·k and p·v to ~2⁻¹¹ relative, far from float32.  Every operand value
// x (q, k, p, v) is split into big = rna_tf32(x) and small =
// rna_tf32(x − big), and each product is taken as big·big + big·small +
// small·big (K3's split, csrc/swap_gain.cu): the dropped small·small
// term and the split's own rounding are ~2⁻²² relative.  The tensor
// cores' float32 accumulation rounds toward zero (swap_gain.cu's
// finding), so no accumulator is carried far: each of S's three products
// gets a fresh accumulator per kv tile (hd / 8 wgmmas), summed with
// __fadd_rn, and each tile's P·V a fresh one (12 wgmmas), folded into O
// with __fmaf_rn.  Carrying O in one accumulator across the keys, as a
// first version did, drifted to 6.7e-6 from the plain version at the
// serve shape (2.6e-6 now) and took the serve phase's float32 logits to
// 1.05e-4, past their 1e-4.  Against the plain float32 version the kernel
// stays within FLASH_F32_TOL = 2e-5 (chip_smoke.py) on the randn inputs
// it is held to; tests/test_torch_flash.py emulates this arithmetic on
// the CPU (truncating accumulators, the key permutation below) against
// the plain version and the Pallas kernel, and plants a 1xTF32 fault the
// tolerance must reject.
//
// Bound on the H100: operations.  Causal attention does 4·hd flop per
// visible (query, key) pair, 2·B·H·hd·(visible pairs) in all: 137.5 GFLOP
// at the serve shape (B 4, T 2048, H 32, hd 128).  One TF32 pass of it at
// the 495 TFLOP/s tensor-core peak takes 0.278 ms, the least any
// tensor-core scheme needs; the 3xTF32 split issues three times that,
// 0.834 ms, the floor of this design; full float32 on the CUDA cores (67
// TFLOP/s) would take 2.05 ms, the floor of the first float32 kernel,
// which ran there.  q, k, v and o are 168 MB (0.050 ms at 3.35 TB/s); the
// pre-pass below moves k and v once more (0.06 ms).
//
// Design:
//   * split_kv, a pre-pass launched from the same C entry on the same
//     stream, splits k and v once per KV head (not once per q tile and
//     per head that reads them) into a scratch the wrapper allocates:
//     kb, ks (B,T,KV,hd) and vᵀb, vᵀs (B·KV, hd, Tp), Tp = T rounded up
//     to 8.  The tf32 form of wgmma has no transpose bit: both operands
//     must be K-major, and v is K-major for P·V only transposed, which
//     TMA cannot do; the pre-pass transposes through a padded shared
//     tile.  It also permutes the keys of every 8-key group by σ = (0 2
//     4 6 1 3 5 7): S's accumulator gives a thread keys {2t, 2t + 1} of
//     each group, and the tf32 A fragment of P·V wants columns {t, t +
//     4}; with vᵀ's columns in σ order the A column t is key 2t and t + 4
//     is key 2t + 1, so p becomes P·V's A operand in registers with no
//     shuffle (the sum over keys does not care about order).  Slots of
//     keys ≥ T are zeros.
//   * One block of 256 threads per (b, h, 128-row q tile): two consumer
//     warpgroups of 64 rows, no producer warp (a ninth warp would cap
//     every thread at 224 registers; a thread holds O, 64 floats at hd
//     128, q's small parts, 64 more, and the fresh accumulators: ptxas
//     gives 245 at hd 128, no spills).  Thread 0 issues the first loads;
//     afterwards the warpgroup that finishes with a stage second refills
//     it (a shared counter per stage and operand), so no thread waits
//     for the other warpgroup.  The grid is (H, B, q tiles) with the q
//     tiles in reverse, so every head's heaviest tiles start first and
//     the G heads that share a KV head run side by side (their k/v tiles
//     come from L2).
//   * TMA, 128-byte swizzle, boxes of 32 float32 columns (one swizzle
//     row): q once (128 rows), then a ring of kStages = 2 stages of 32-key
//     tiles, k's two parts (32 rows × hd, each box of kb followed by the
//     same box of ks) behind one full barrier and vᵀ's two parts (hd
//     rows × 32 keys) behind another, so S starts before v lands.  Rows
//     past T come in as zeros.  Shared memory at hd 128: q 64 KB + 2 ×
//     (k 32 KB + vᵀ 32 KB) = 192 KB, one block an SM; there is no room
//     for 64-key tiles or a third stage.
//   * q's split: each thread reads its A-fragment values of q from the
//     landed tile (rows r, r + 8; columns 8kk + t, + 4), writes big back
//     in place and keeps small in registers; the warpgroup fences the
//     writes to the async proxy and meets at a named barrier.
//   * S = Q·Kᵀ per k8 step: one wgmma m64n64k8 tf32 of Qb against the 64
//     rows [Kb; Ks] (both in shared memory: Qb read once for two
//     products), then m64n32k8 Qs·Kb with Qs from registers.  O += P·V
//     per chunk of 64 columns of o (32 at hd 96): per k8 step of keys
//     wgmma m64n64k8 Pb·Vb, Pb·Vs, Ps·Vb with P from registers, into two
//     fresh accumulators in turn, so one chunk runs on the tensor cores
//     while the other is folded.  On the card each of these was faster
//     than the narrower form it replaced (three m64n32k8 products a k8
//     step for S, 32-column chunks for P·V); carrying P·V of tile i
//     beside the softmax of tile i + 1, as FlashAttention-3 does, was
//     slower (more registers, and S of tile i + 1 queued ahead of P·V),
//     and so was refilling a k stage before the softmax.
//   * Softmax in registers as the bf16 route: rows r and r + 8, row max
//     over the 4 lanes of a quad, l kept per lane and summed over the
//     quad at the end, exp2 of scores scaled by hd^-½·log2 e (__fmul_rn;
//     the library builds with --fmad=false).
//   * A warpgroup computes only the kv tiles that hold a key visible to
//     one of its rows: before the diagonal, and with a window from the
//     first row's first visible key; it still waits for the others and
//     releases them.  Skipping is exact: a skipped tile after a row's
//     first visible key would add p = exp2(−1e30 − m) = 0 with a
//     correction exp2(0) = 1; a tile before it leaves m at −1e30 and adds
//     exp2(0) = 1 terms to l and acc, which the first tile with a visible
//     key rescales by exp2(−1e30 − m) = 0.
//   * No atomics on the data and a fixed order of every sum: two runs
//     give equal bits.  Only rows < T are stored.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace viem {
namespace {

constexpr int kBM = 128;                // q rows of a block
constexpr int kWG = 64;                 // q rows of a consumer warpgroup
constexpr int kBN = 32;                 // keys of a kv tile
constexpr int kStages = 2;              // k / vᵀ ring depth
constexpr int kThreads = 256;           // two consumer warpgroups
constexpr int kCols = 32;               // float32 columns of a TMA box
constexpr uint32_t kRow = kCols * 4;    // bytes of a swizzled row
constexpr float kNegInf = -1e30f;

template <int HD>
struct Tiles {
  static_assert(HD % kCols == 0 && HD <= 128, "hd 32, 64, 96 or 128");
  static constexpr int kBoxes = HD / kCols;
  static constexpr uint32_t kQBox = kBM * kRow;           // 128 q rows
  static constexpr uint32_t kKBox = kBN * kRow;           // 32 k rows
  static constexpr uint32_t kQBytes = kBoxes * kQBox;
  static constexpr uint32_t kKPart = kBoxes * kKBox;      // kb or ks
  // a k stage: box c of kb at 2c·kKBox, box c of ks right after it
  static constexpr uint32_t kVPart = HD * kRow;           // vᵀb or vᵀs
  static constexpr uint32_t kKRing = kStages * 2 * kKPart;
  static constexpr uint32_t kVRing = kStages * 2 * kVPart;
  // q, the two rings, the barriers (q, k and vᵀ full per stage) and the
  // per-stage counters, and slack to align the tiles to the 1024 bytes
  // the swizzle repeats over
  static constexpr size_t kSmem =
      static_cast<size_t>(kQBytes) + kKRing + kVRing + 1024 + 1024;
};

// ---------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of warpgroup `wg` meet (barrier 0 is __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// ------------------------------------------------------------ 3xTF32
// cvt.rna.tf32.f32 in integer arithmetic (swap_gain.cu's rna_tf32): the
// TF32 value nearest to x, ties away from zero, low 13 bits clear
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x → big = rna(x), small = rna(x − big)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(__fsub_rn(x, __uint_as_float(big)));
}

// -------------------------------------------------------------- wgmma
#define VIEM_D16 VIEM_D8(0), VIEM_D8(8)
#define VIEM_R16                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"

// d (64×64) (+)= A·Bᵀ, A (64×8) and B (64×8) tf32, K-major in shared
// memory
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{" VIEM_R32 "}, %32, %33, p, 1, 1;\n"
      "}\n"
      : VIEM_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64×N) (+)= A·Bᵀ, A (64×8 tf32) in registers, B (N×8 tf32) K-major
// in shared memory; N = 32 or 64 by the size of d
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{" VIEM_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : VIEM_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{" VIEM_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : VIEM_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// until at most the newest committed wgmma group is still in flight
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ----------------------------------------------------------- pre-pass
// σ: the key of an 8-key group that column c of vᵀ holds
__device__ __forceinline__ int sigma(int c) {
  return c < 4 ? 2 * c : 2 * (c - 4) + 1;
}

// One block of 256 threads per (32 key slots, 32 columns, b·KV + kvh):
// k's rows split in place of layout; v's rows split, transposed through a
// padded shared tile and written as vᵀ with its key slots in σ order
// (zeros for keys ≥ T).
__global__ void __launch_bounds__(256)
split_kv(const float* __restrict__ k, const float* __restrict__ v,
         float* __restrict__ kb, float* __restrict__ ks,
         float* __restrict__ vb, float* __restrict__ vs, int seq,
         int kv_heads, int head_dim, int tp) {
  __shared__ float tile[32][33];
  const int key0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  const int bk = blockIdx.z;
  const int b = bk / kv_heads;
  const int kvh = bk % kv_heads;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int key = key0 + r;
    float y = 0.0f;
    if (key < seq) {
      const size_t at =
          ((static_cast<size_t>(b) * seq + key) * kv_heads + kvh) *
              head_dim + d0 + tx;
      uint32_t big, small;
      split(k[at], big, small);
      kb[at] = __uint_as_float(big);
      ks[at] = __uint_as_float(small);
      y = v[at];
    }
    tile[r][tx] = y;
  }
  __syncthreads();
  const int slot = key0 + tx;
  if (slot >= tp) return;
  const int src = (tx & ~7) | sigma(tx & 7);
  for (int r = ty; r < 32; r += 8) {
    uint32_t big, small;
    split(tile[src][r], big, small);
    const size_t at =
        (static_cast<size_t>(bk) * head_dim + d0 + r) * tp + slot;
    vb[at] = __uint_as_float(big);
    vs[at] = __uint_as_float(small);
  }
}

// --------------------------------------------------------------- main
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tkb,
               const __grid_constant__ CUtensorMap tks,
               const __grid_constant__ CUtensorMap tvb,
               const __grid_constant__ CUtensorMap tvs,
               float* __restrict__ o, int seq, int heads, int kv_heads,
               int window, float scale) {
  using Ti = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* const base_ptr = smem_raw + pad;
  const uint32_t q_tile = raw + pad;
  const uint32_t k_ring = q_tile + Ti::kQBytes;
  const uint32_t v_ring = k_ring + Ti::kKRing;
  const uint32_t bars = v_ring + Ti::kVRing;
  // barriers: q_full, then k_full per stage, then v_full per stage; the
  // counters after them: k's per stage, then vᵀ's
  const uint32_t q_full = bars;
  const auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  const auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  int* const done = reinterpret_cast<int*>(
      base_ptr + Ti::kQBytes + Ti::kKRing + Ti::kVRing +
      8 * (1 + 2 * kStages));

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  const int kvh = h / (heads / kv_heads);
  // keys after the tile's last row are masked for every row; with a
  // window, so are the keys before its first row's first visible key
  const int k_end = min(q0 + kBM, seq);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBN * kBN : 0;
  const int n_tiles = (k_end - k_begin + kBN - 1) / kBN;

  const auto load_k = [&](int i) {
    const int s = i % kStages;
    const int k0 = k_begin + i * kBN;
    const uint32_t dst = k_ring + s * 2 * Ti::kKPart;
    mbar_expect_tx(k_full(s), 2 * Ti::kKPart);
#pragma unroll
    for (int c = 0; c < Ti::kBoxes; ++c) {
      tma_load_4d(dst + 2 * c * Ti::kKBox, &tkb, k_full(s), c * kCols, kvh,
                  k0, b);
      tma_load_4d(dst + (2 * c + 1) * Ti::kKBox, &tks, k_full(s),
                  c * kCols, kvh, k0, b);
    }
  };
  const auto load_v = [&](int i) {
    const int s = i % kStages;
    const int k0 = k_begin + i * kBN;
    const uint32_t dst = v_ring + s * 2 * Ti::kVPart;
    mbar_expect_tx(v_full(s), 2 * Ti::kVPart);
    tma_load_3d(dst, &tvb, v_full(s), k0, 0, b * kv_heads + kvh);
    tma_load_3d(dst + Ti::kVPart, &tvs, v_full(s), k0, 0,
                b * kv_heads + kvh);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      done[s] = 0;
      done[kStages + s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, Ti::kQBytes);
#pragma unroll
    for (int c = 0; c < Ti::kBoxes; ++c)
      tma_load_4d(q_tile + c * Ti::kQBox, &tq, q_full, c * kCols, h, q0, b);
    for (int i = 0; i < kStages && i < n_tiles; ++i) {
      load_k(i);
      load_v(i);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int t4 = lane % 4;
  const int wq0 = q0 + kWG * wg;        // this warpgroup's first q row
  const int row0 = wq0 + 16 * (tid / 32) + lane / 4;   // and row0 + 8
  // the kv tiles holding a key visible to one of this warpgroup's rows
  const int w_first =
      window > 0 ? max(0, wq0 - window + 1) / kBN * kBN : 0;
  const int w_end = wq0 < seq ? min(wq0 + kWG, seq) : 0;
  // this warpgroup's q rows in each box, and the row of this thread's
  // A fragment (row r and r + 8; 16-byte chunk c of a row sits at
  // c ^ (r % 8) under the swizzle, and r % 8 = lane / 4)
  const uint32_t q_rows = q_tile + kWG * kRow * wg;
  const uint32_t a_row = (16 * (tid / 32) + lane / 4) * kRow + 4 * t4;
  const uint32_t a_xor = static_cast<uint32_t>(lane / 4);

  // q: big in place, small in registers as the A fragments of Qs·Kᵀ
  // (element 4kk + 2·hi + lo: row r + 8·lo, column 8kk + t4 + 4·hi)
  uint32_t qs[HD / 2];
  mbar_wait(q_full, 0);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int lo = 0; lo < 2; ++lo) {
        const uint32_t off = (q_rows - q_tile) + (kk / 4) * Ti::kQBox +
                             a_row + 8 * lo * kRow +
                             ((2 * (kk % 4) + hi) ^ a_xor) * 16;
        float* const at = reinterpret_cast<float*>(base_ptr + off);
        uint32_t big;
        split(*at, big, qs[4 * kk + 2 * hi + lo]);
        *at = __uint_as_float(big);
      }
  fence_async_smem();                   // visible to wgmma's reads
  warpgroup_sync(wg);

  // P·V in chunks of kPV columns of o (vᵀ rows), each over the tile's 4
  // k8 steps of keys into the fresh accumulator f
  constexpr int kPV = HD % 64 == 0 ? 64 : 32;
  constexpr int kChunks = HD / kPV;
  const auto pv_chunk = [&](int c, uint32_t vb, const uint32_t (&pb)[16],
                            const uint32_t (&ps)[16], float (&f)[kPV / 2]) {
    wgmma_fence();
#pragma unroll
    for (int g = 0; g < kBN / 8; ++g) {
      const uint32_t vo = c * kPV * kRow + g * 32;
      const uint64_t vd = sw128_desc(vb + vo, 16, 1024);
      wgmma_rs(f, &pb[4 * g], vd, g > 0);
      wgmma_rs(f, &pb[4 * g], sw128_desc(vb + Ti::kVPart + vo, 16, 1024), 1);
      wgmma_rs(f, &ps[4 * g], vd, 1);
    }
    wgmma_commit();
  };

  // this warpgroup is done with tile i's k (vᵀ): the second of the two
  // to get here refills its stage with tile i + kStages
  const auto release_k = [&](int i) {
    if (tid == 0 &&
        atomicAdd(&done[i % kStages], 1) == 2 * (i / kStages) + 1 &&
        i + kStages < n_tiles)
      load_k(i + kStages);
  };
  const auto release_v = [&](int i) {
    if (tid == 0 &&
        atomicAdd(&done[kStages + i % kStages], 1) ==
            2 * (i / kStages) + 1 &&
        i + kStages < n_tiles)
      load_v(i + kStages);
  };

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float st[16], fa[kPV / 2], fb[kPV / 2];   // S; fresh accumulators

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = k_begin + i * kBN;
    const uint32_t kb = k_ring + s * 2 * Ti::kKPart;
    const uint32_t vb = v_ring + s * 2 * Ti::kVPart;
    const bool live = k0 >= w_first && k0 < w_end;
    uint32_t pb[16], ps[16];            // P as 4 A fragments of 4 regs
    float corr0 = 1.0f, corr1 = 1.0f;

    mbar_wait(k_full(s), parity);
    if (live) {
      // S = Q·Kᵀ (64 × 32): per k8 step Qb·[Kb; Ks]ᵀ in one m64n64 wgmma
      // (the stage holds each box of Kb with its Ks box right after it)
      // and Qs·Kbᵀ from registers, the products in fresh accumulators of
      // their own, then S = (Qb·Kb + Qb·Ks) + Qs·Kb with __fadd_rn
      {
        float sbb[32], ssb[16];         // [Qb·Kbᵀ | Qb·Ksᵀ], Qs·Kbᵀ
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk) {
          const uint32_t qo = (kk / 4) * Ti::kQBox + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * 2 * Ti::kKBox + (kk % 4) * 32;
          const uint64_t kd = sw128_desc(kb + ko, 16, 1024);
          wgmma_ss64(sbb, sw128_desc(q_rows + qo, 16, 1024), kd, kk > 0);
          wgmma_rs(ssb, &qs[4 * kk], kd, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sbb);
        fence_regs(ssb);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          st[j] = __fadd_rn(__fadd_rn(sbb[j], sbb[16 + j]), ssb[j]);
      }
      fence_regs(qs);

      // scale (hd^-½·log2 e), mask, online softmax; element j of st is
      // row row0 (j & 2 clear) or row0 + 8, key k0 + 8·(j / 4) + 2·t4 +
      // (j & 1)
      const bool masked = k0 + kBN - 1 > wq0 ||
                          (window > 0 && wq0 + kWG - 1 - k0 >= window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float x = __fmul_rn(st[j], scale);
        if (masked) {
          const int row = row0 + ((j & 2) ? 8 : 0);
          const int col = k0 + 8 * (j / 4) + 2 * t4 + (j & 1);
          const bool visible =
              col <= row && (window <= 0 || row - col < window);
          x = visible ? x : kNegInf;
        }
        st[j] = x;
        if (j & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      corr0 = exp2f(__fsub_rn(m0, mx0));
      corr1 = exp2f(__fsub_rn(m1, mx1));
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.0f, rs1 = 0.0f;
      // p of key group g: st[4g + {0, 1}] row r, keys 2t4, 2t4 + 1;
      // st[4g + {2, 3}] row r + 8.  In σ order they are A columns t4
      // and t4 + 4: a0 = (r, 2t4), a1 = (r + 8, 2t4), a2 = (r, 2t4 + 1),
      // a3 = (r + 8, 2t4 + 1)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float p00 = exp2f(__fsub_rn(st[4 * g + 0], m0));
        const float p01 = exp2f(__fsub_rn(st[4 * g + 1], m0));
        const float p10 = exp2f(__fsub_rn(st[4 * g + 2], m1));
        const float p11 = exp2f(__fsub_rn(st[4 * g + 3], m1));
        rs0 = __fadd_rn(__fadd_rn(rs0, p00), p01);
        rs1 = __fadd_rn(__fadd_rn(rs1, p10), p11);
        split(p00, pb[4 * g + 0], ps[4 * g + 0]);
        split(p10, pb[4 * g + 1], ps[4 * g + 1]);
        split(p01, pb[4 * g + 2], ps[4 * g + 2]);
        split(p11, pb[4 * g + 3], ps[4 * g + 3]);
      }
      l0 = __fadd_rn(__fmul_rn(l0, corr0), rs0);
      l1 = __fadd_rn(__fmul_rn(l1, corr1), rs1);
    }
    release_k(i);

    mbar_wait(v_full(s), parity);
    if (live) {
      // O = O·corr + P·V: per chunk of kPV columns of o, Pb·Vb + Pb·Vs +
      // Ps·Vb per k8 step of keys in a fresh accumulator (alternately
      // fa, fb: the next chunk runs while this one is folded), folded
      // into O with __fmaf_rn
      pv_chunk(0, vb, pb, ps, fa);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float (&f)[kPV / 2] = (c & 1) ? fb : fa;
        if (c + 1 < kChunks) {
          pv_chunk(c + 1, vb, pb, ps, (c & 1) ? fa : fb);
          wgmma_wait_one();
        } else {
          wgmma_wait_all();
        }
        fence_regs(f);
#pragma unroll
        for (int j = 0; j < kPV / 2; ++j)
          acc[kPV / 2 * c + j] =
              __fmaf_rn(acc[kPV / 2 * c + j], (j & 2) ? corr1 : corr0, f[j]);
      }
      fence_regs(pb);
      fence_regs(ps);
    }
    release_v(i);
    // qs is a wgmma A operand that the loop carries unchanged.  Without
    // a read after the last wgmma of a trip, ptxas (sm_90a, hd 32) takes
    // qs's registers for values of the same trip (the softmax's indices,
    // p's big parts for P·V), so the next trip's Qs·Kb reads those: the
    // Qs term is lost, 1xTF32-sized errors from the second kv tile on.
    // A fence_regs(qs) here, or an asm self-move, is no use: neither is
    // a read ptxas sees.  This read is one: the C entry refuses window <
    // 0, but no compiler can know a kernel argument.  chip_smoke.py's
    // build phase checks the SASS of every entry for the fault
    // (clobbered_wgmma_operands), and tools/flash_f32_keepalive.py
    // builds the kernel without this read to show it.
    if (window < 0) {
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] = __uint_as_float(qs[j]);
    }
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  const size_t row_stride = static_cast<size_t>(heads) * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= seq) continue;
    const float l = half ? l1 : l0;
    float* const out = o + (static_cast<size_t>(b) * seq + row) * row_stride +
                       static_cast<size_t>(h) * HD;
#pragma unroll
    for (int cb = 0; cb < HD / 8; ++cb)
      *reinterpret_cast<float2*>(out + 8 * cb + 2 * t4) =
          make_float2(__fdiv_rn(acc[4 * cb + 2 * half], l),
                      __fdiv_rn(acc[4 * cb + 2 * half + 1], l));
  }
}

// ------------------------------------------------------------- host
// a float32 tensor of `dims` (innermost first, dims[0] contiguous) as
// boxes of `box`, 128-byte swizzle, zeros outside
template <int R>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr,
            const cuuint64_t (&dims)[R], const cuuint32_t (&box)[R]) {
  cuuint64_t strides[R - 1];
  cuuint64_t stride = 4;
  for (int i = 0; i + 1 < R; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  cuuint32_t unit[R];
  for (int i = 0; i < R; ++i) unit[i] = 1;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, R, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// floats of scratch a call needs: kb, ks (B·T·KV·hd each) and vᵀb, vᵀs
// (B·KV·hd·Tp each), Tp = T rounded up to 8; launch<HD> carves it so
long long scratch_floats(int batch, int seq, int kv_heads, int head_dim) {
  const long long tp = (seq + 7) / 8 * 8;
  return 2ll * batch * kv_heads * head_dim * (seq + tp);
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* o, float* scratch, int batch, int seq, int heads,
                   int kv_heads, int window, float scale,
                   cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int tp = (seq + 7) / 8 * 8;
  const size_t n_kv = static_cast<size_t>(batch) * seq * kv_heads * HD;
  const size_t n_vt = static_cast<size_t>(batch) * kv_heads * HD * tp;
  float* const kb = scratch;
  float* const ks = kb + n_kv;
  float* const vb = ks + n_kv;
  float* const vs = vb + n_vt;
  const cuuint64_t t = static_cast<cuuint64_t>(seq);
  const cuuint64_t qdims[4] = {HD, static_cast<cuuint64_t>(heads), t,
                               static_cast<cuuint64_t>(batch)};
  const cuuint64_t kdims[4] = {HD, static_cast<cuuint64_t>(kv_heads), t,
                               static_cast<cuuint64_t>(batch)};
  const cuuint64_t vdims[3] = {
      static_cast<cuuint64_t>(tp), HD,
      static_cast<cuuint64_t>(batch) * kv_heads};
  const cuuint32_t qbox[4] = {kCols, 1, kBM, 1};
  const cuuint32_t kbox[4] = {kCols, 1, kBN, 1};
  const cuuint32_t vbox[3] = {kBN, HD, 1};
  CUtensorMap tq, tkb, tks, tvb, tvs;
  if (!encode(fn, &tq, q, qdims, qbox) || !encode(fn, &tkb, kb, kdims, kbox) ||
      !encode(fn, &tks, ks, kdims, kbox) ||
      !encode(fn, &tvb, vb, vdims, vbox) || !encode(fn, &tvs, vs, vdims, vbox))
    return cudaErrorInvalidValue;
  const dim3 pre((tp + 31) / 32, HD / 32, batch * kv_heads);
  split_kv<<<pre, 256, 0, stream>>>(k, v, kb, ks, vb, vs, seq, kv_heads, HD,
                                    tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Tiles<HD>::kSmem;
  // above 48 KB only after this opt-in, which is per device
  err = cudaFuncSetAttribute(flash_fwd_tf32<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch, (seq + kBM - 1) / kBM);
  flash_fwd_tf32<HD><<<grid, kThreads, smem, stream>>>(
      tq, tkb, tks, tvb, tvs, o, seq, heads, kv_heads, window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace viem

extern "C" {

// Floats of scratch viem_flash_attention needs for these sizes (its
// wrapper allocates them).
long long viem_flash_attention_scratch_floats(int batch, int seq,
                                              int kv_heads, int head_dim) {
  return viem::scratch_floats(batch, seq, kv_heads, head_dim);
}

// o (B,T,H,hd) from q (B,T,H,hd) and k, v (B,T,KV,hd), all float32,
// contiguous and 16-byte aligned; hd ∈ {32, 64, 96, 128}.  scratch holds
// scratch_floats floats (at least viem_flash_attention_scratch_floats),
// 16-byte aligned.  window 0 is full causal attention; scale =
// hd^-½·log2 e.
// Two launches on `stream` (split_kv, then the attention).  Returns a
// cudaError_t code.
int viem_flash_attention(const void* q, const void* k, const void* v,
                         void* o, void* scratch, long long scratch_floats,
                         int batch, int seq, int heads, int kv_heads,
                         int head_dim, int window, float scale,
                         void* stream) {
  if (batch < 0 || seq < 0 || heads <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || window < 0 || heads > 65535 ||
      static_cast<long long>(batch) * kv_heads > 65535 ||
      (seq + viem::kBM - 1) / viem::kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq == 0) return static_cast<int>(cudaSuccess);
  if (scratch_floats <
          viem::scratch_floats(batch, seq, kv_heads, head_dim) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(scratch)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* sf = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 32:
      err = viem::launch<32>(qf, kf, vf, of, sf, batch, seq, heads,
                             kv_heads, window, scale, s);
      break;
    case 64:
      err = viem::launch<64>(qf, kf, vf, of, sf, batch, seq, heads,
                             kv_heads, window, scale, s);
      break;
    case 96:
      err = viem::launch<96>(qf, kf, vf, of, sf, batch, seq, heads,
                             kv_heads, window, scale, s);
      break;
    case 128:
      err = viem::launch<128>(qf, kf, vf, of, sf, batch, seq, heads,
                              kv_heads, window, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* viem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
