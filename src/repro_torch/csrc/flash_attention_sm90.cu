// K4, bf16 route — causal / sliding-window GQA flash attention, forward,
// on Hopper's tensor cores (sm_90a):
//
//   o[b,t,h] = Σ_s softmax_s(q[b,t,h]·k[b,s,h/G]·hd^-½ | mask) · v[b,s,h/G]
//
// with q (B,T,H,hd), k and v (B,S,KV,hd), S = T, G = H/KV, all bfloat16
// and contiguous, and the mask t ≥ s (causal), also t − s < window when
// window > 0.  q·k is summed in float32 and scaled; masked scores are
// −1e30; the online softmax (running max m, running sum l, accumulator
// acc) is float32; p is rounded to bfloat16 before p·v, whose products
// are summed in float32; o = acc / max(l, 1e-30), rounded to bfloat16.
// The exponentials are exp2f with log2 e folded into the scale
// (scale_log2 = hd^-½·log2 e), so s·log2 e takes the place of s; a masked
// score −1e30 still gives exactly 0 weight against any real maximum.
// hd ∈ {32, 64, 96, 128}: 32 and 96 run through the 64 and 128
// instantiations, whose extra columns TMA fills with zeros and which are
// never stored.
//
// Replaces: src/repro/kernels/flash_attention.py — flash_attention_kernel
// (`_flash_fwd`, body `_flash_kernel`), for bfloat16 inputs.  float32
// inputs go to csrc/flash_attention.cu, which keeps the reference's
// float32 precision on the tensor cores through a 3xTF32 split (one TF32
// pass would not).
//
// Bound on the H100: operations.  Causal attention does 4·hd flop per
// visible (query, key) pair, 2·B·H·hd·(visible pairs) in all: 137.5 GFLOP
// at the serve shape (B 4, T 2048, H 32, hd 128), 0.139 ms at the 989
// TFLOP/s bf16 tensor-core peak; q, k, v and o are 84 MB (0.025 ms at
// 3.35 TB/s).  Both products run on the tensor cores (wgmma) from bf16
// tiles that TMA lands in shared memory while the previous tile is being
// computed; the softmax between them (one exp2 per score on the SFU) is
// what the tensor cores wait for.
//
// Design:
//   * One block of 288 threads per (b, h, 128-row q tile): warpgroups 0
//     and 1 consume (64 q rows each), warp 8 produces (one thread issues
//     every TMA load).  The grid is (H, B, q tiles) with the q tiles in
//     reverse, so every head's heaviest tiles are scheduled first and the
//     G heads that share a KV head run side by side (their k/v tiles come
//     from L2).  GQA indexes KV head h / G; no expanded copy of k or v
//     exists.  A consumer thread holds O (64 floats at hd 128) and S (64),
//     which becomes P (32 bf16 pairs): under the 168 registers ptxas
//     gives a 9-warp block, with no spills, so no setmaxnreg.  (ptxas
//     keeps a 12-warp block at 168 too, even after setmaxnreg.inc 240;
//     that is why S of the next tile is not issued beside P·V of this
//     one, as FlashAttention-3 does: S, O and P live at once spill.)
//   * TMA: three 4-D tensor maps over (hd, heads, T, B), built on the
//     host for every call; a box is 64 columns (128 bytes, the 128-byte
//     swizzle's width) × 128 rows, so a tile at hd 128 is two boxes.
//     Rows past T and columns past hd come in as zeros.  q is loaded
//     once; k and v go through a ring of kStages stages with a full
//     barrier each (k and v apart, so S = Q·Kᵀ starts before v lands)
//     and one empty barrier that both consumers arrive on once the
//     product reading that stage's v has completed.  A barrier's parity
//     flips every time round the ring: the consumer waits on full with
//     parity (i / kStages) & 1, the producer on empty with its opposite,
//     which a fresh barrier passes.
//   * S = Q·Kᵀ: wgmma m64n128k16, A (q) and B (k) both K-major in shared
//     memory with the 128-byte swizzle (SBO 1024 bytes between 8-row
//     groups; the k16 slices step 32 bytes inside a 128-byte row, then
//     to the next 64-column box).  O += P·V: wgmma m64n{hd}k16 with A = P
//     in registers and B = v MN-major (the transpose bit; SBO 1024 bytes
//     between 8-row groups of keys, LBO the 16 KB between the two
//     64-column boxes), so no transposing pass exists.
//   * Softmax in registers: a thread holds rows r and r + 8 of its warp's
//     16 (columns 8j + 2·(lane % 4) + {0, 1}); row max and row sum reduce
//     over the 4 lanes that share a row.  The accumulator fragment of S
//     for keys 16k..16k+15 is, element for element, the A fragment of
//     P·V for that k16 slice, so p is packed to bf16 pairs in place.
//     l sums the unrounded p, as the reference does.
//   * Tiles the mask empties for every row of the q tile are skipped:
//     those after the diagonal, and with a window those before the first
//     row's first visible key; a consumer also skips, for its own 64
//     rows, the leading tiles that hold no key visible to any of them (it
//     still waits for them and releases them).  Skipping is exact.  A
//     skipped tile after a row's first visible key would add p =
//     exp2(−1e30 − m) = 0 with a correction exp2(0) = 1.  A tile before
//     it, which a row can also meet inside a tile that is not skipped,
//     leaves m at −1e30 and adds exp2(0) = 1 terms to l and acc; the
//     first tile with a visible key rescales them by exp2(−1e30 − m) = 0.
//     Either way the result is that of visiting every tile, as the TPU
//     kernel does; the argument holds at any tile width.
//   * No atomics and a fixed order of every sum: two runs give equal
//     bits.  Only rows < T and columns < hd are stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace viem {
namespace {

constexpr int kBM = 128;                // q rows of a block
constexpr int kBN = 128;                // kv rows of a tile
static_assert(kBM == kBN, "q and k/v tiles share one TMA box shape");
constexpr int kStages = 2;              // k/v ring depth
constexpr int kThreads = 288;           // 2 consumer warpgroups + producer
constexpr int kBoxCols = 64;            // bf16 columns of a TMA box
constexpr uint32_t kBoxBytes = kBN * kBoxCols * 2;   // 128 rows × 128 B
constexpr float kNegInf = -1e30f;

template <int HD>
struct Tiles {
  static_assert(HD == 64 || HD == 128, "instantiated for hd 64 and 128");
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;
  // q, kStages k tiles, kStages v tiles, the barriers, and slack to
  // align the tiles to the 1024 bytes the 128-byte swizzle repeats over
  static constexpr size_t kSmem =
      static_cast<size_t>(1 + 2 * kStages) * kTileBytes + 1024 + 1024;
};

// ---------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// -------------------------------------------------------------- wgmma
// d (64×128) (+)= A·Bᵀ, A (64×16) and B (128×16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" VIEM_R64 "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VIEM_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64×N) += A·B, A (64×16 bf16) in registers, B (16×N) MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" VIEM_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : VIEM_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" VIEM_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : VIEM_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int seq, int heads,
               int kv_heads, int head_dim, int window, float scale_log2) {
  using Ti = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t k_tiles = q_tile + Ti::kTileBytes;
  const uint32_t v_tiles = k_tiles + kStages * Ti::kTileBytes;
  const uint32_t bars = v_tiles + kStages * Ti::kTileBytes;
  // barriers: q_full, then per stage k_full, v_full, empty
  const uint32_t q_full = bars;
  const auto k_full = [&](int s) { return bars + 8u * (1 + 3 * s); };
  const auto v_full = [&](int s) { return bars + 8u * (2 + 3 * s); };
  const auto empty = [&](int s) { return bars + 8u * (3 + 3 * s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  const int kvh = h / (heads / kv_heads);
  // keys after the tile's last row are masked for every row; with a
  // window, so are the keys before its first row's first visible key
  const int k_end = min(q0 + kBM, seq);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBN * kBN : 0;
  const int n_tiles = (k_end - k_begin + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2);           // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ------------------------------------------------------- producer
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, Ti::kTileBytes);
#pragma unroll
      for (int c = 0; c < Ti::kBoxes; ++c)
        tma_load(q_tile + c * kBoxBytes, &tq, q_full, c * kBoxCols, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        const int k0 = k_begin + i * kBN;
        mbar_wait(empty(s), parity ^ 1);
        mbar_expect_tx(k_full(s), Ti::kTileBytes);
#pragma unroll
        for (int c = 0; c < Ti::kBoxes; ++c)
          tma_load(k_tiles + s * Ti::kTileBytes + c * kBoxBytes, &tk,
                   k_full(s), c * kBoxCols, kvh, k0, b);
        mbar_expect_tx(v_full(s), Ti::kTileBytes);
#pragma unroll
        for (int c = 0; c < Ti::kBoxes; ++c)
          tma_load(v_tiles + s * Ti::kTileBytes + c * kBoxBytes, &tv,
                   v_full(s), c * kBoxCols, kvh, k0, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int wq0 = q0 + 64 * wg;       // this warpgroup's first q row
    const int row0 = wq0 + 16 * (tid / 32) + lane / 4;   // and row0 + 8
    const int col_lane = 2 * (lane % 4);
    // leading tiles holding no key visible to any of this warpgroup's rows
    const int k_first = window > 0 ? max(0, wq0 - window + 1) / kBN * kBN : 0;
    // its q rows: 64 rows of 128 bytes in each box
    const uint32_t q_rows = q_tile + 64 * 128 * wg;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = k_begin + i * kBN;
      const uint32_t k_tile = k_tiles + s * Ti::kTileBytes;
      const uint32_t v_tile = v_tiles + s * Ti::kTileBytes;
      mbar_wait(k_full(s), parity);
      if (k0 >= k_first) {
        // S = Q·Kᵀ (64 × 128 per warpgroup)
        float sc[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss_n128(sc, sw128_desc(q_rows + off, 16, 1024),
                        sw128_desc(k_tile + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale, mask, online softmax; element j of sc is row row0 (j & 2
        // clear) or row0 + 8, key k0 + 8·(j / 4) + col_lane + (j & 1)
        const bool masked = k0 + kBN - 1 > wq0 ||
                            (window > 0 && wq0 + 63 - k0 >= window);
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          float x = __fmul_rn(sc[j], scale_log2);
          if (masked) {
            const int row = row0 + ((j & 2) ? 8 : 0);
            const int col = k0 + 8 * (j / 4) + col_lane + (j & 1);
            const bool visible =
                col <= row && (window <= 0 || row - col < window);
            x = visible ? x : kNegInf;
          }
          sc[j] = x;
          if (j & 2)
            mx1 = fmaxf(mx1, x);
          else
            mx0 = fmaxf(mx0, x);
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float corr0 = exp2f(__fsub_rn(m0, mx0));
        const float corr1 = exp2f(__fsub_rn(m1, mx1));
        m0 = mx0;
        m1 = mx1;
        float rs0 = 0.0f, rs1 = 0.0f;
        uint32_t pa[32];                // P as 8 A fragments of 4 regs
#pragma unroll
        for (int j = 0; j < 64; j += 2) {
          const float mj = (j & 2) ? m1 : m0;
          const float p0 = exp2f(__fsub_rn(sc[j], mj));
          const float p1 = exp2f(__fsub_rn(sc[j + 1], mj));
          if (j & 2)
            rs1 = __fadd_rn(__fadd_rn(rs1, p0), p1);
          else
            rs0 = __fadd_rn(__fadd_rn(rs0, p0), p1);
          pa[j / 2] = pack_bf16(p0, p1);
        }
        l0 = __fadd_rn(__fmul_rn(l0, corr0), rs0);
        l1 = __fadd_rn(__fmul_rn(l1, corr1), rs1);
#pragma unroll
        for (int j = 0; j < HD / 2; ++j)
          acc[j] = __fmul_rn(acc[j], (j & 2) ? corr1 : corr0);

        // O += P·V
        mbar_wait(v_full(s), parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs(acc, &pa[4 * kk],
                   sw128_desc(v_tile + kk * 16 * 128, kBoxBytes, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      } else {
        mbar_wait(v_full(s), parity);
      }
      // this warpgroup is done with the stage's k and v
      if (tid == 0) mbar_arrive(empty(s));
    }

    l0 = fmaxf(quad_sum(l0), 1e-30f);
    l1 = fmaxf(quad_sum(l1), 1e-30f);
    const size_t row_stride = static_cast<size_t>(heads) * head_dim;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= seq) continue;
      const float l = half ? l1 : l0;
      __nv_bfloat16* out = o + (static_cast<size_t>(b) * seq + row) *
                                   row_stride +
                           static_cast<size_t>(h) * head_dim;
#pragma unroll
      for (int cb = 0; cb < HD / 8; ++cb) {
        if (8 * cb >= head_dim) break;
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * cb + col_lane) =
            __floats2bfloat162_rn(__fdiv_rn(acc[4 * cb + 2 * half], l),
                                  __fdiv_rn(acc[4 * cb + 2 * half + 1], l));
      }
    }
  }
}

// ------------------------------------------------------------- host
// a (B, T, n_heads, head_dim) bf16 tensor as 4-D boxes of 64 columns ×
// 128 rows of one head, 128-byte swizzle, zeros outside
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch,
            int seq, int n_heads, int head_dim) {
  const cuuint64_t row = static_cast<cuuint64_t>(head_dim) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * n_heads,
                                 row * n_heads * static_cast<cuuint64_t>(seq)};
  const cuuint32_t box[4] = {kBoxCols, 1, kBN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int seq, int heads, int kv_heads, int head_dim,
                   int window, float scale_log2, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, batch, seq, heads, head_dim) ||
      !encode(fn, &tk, k, batch, seq, kv_heads, head_dim) ||
      !encode(fn, &tv, v, batch, seq, kv_heads, head_dim))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Tiles<HD>::kSmem;
  // above 48 KB only after this opt-in, which is per device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch, (seq + kBM - 1) / kBM);
  flash_fwd_sm90<HD><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), seq, heads, kv_heads,
      head_dim, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace viem

extern "C" {

// o (B,T,H,hd) from q (B,T,H,hd) and k, v (B,T,KV,hd), all bfloat16,
// contiguous and 16-byte aligned; hd ∈ {32, 64, 96, 128}.  window 0 is
// full causal attention.  scale_log2 = hd^-½·log2 e.  One launch on
// `stream`.  Returns a cudaError_t code.
int viem_flash_attention_sm90(const void* q, const void* k, const void* v,
                              void* o, int batch, int seq, int heads,
                              int kv_heads, int head_dim, int window,
                              float scale_log2, void* stream) {
  if (batch < 0 || seq < 0 || heads <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || window < 0 || batch > 65535 ||
      (seq + viem::kBM - 1) / viem::kBM > 65535 || head_dim <= 0 ||
      head_dim > 128 || head_dim % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      head_dim <= 64
          ? viem::launch<64>(q, k, v, o, batch, seq, heads, kv_heads,
                             head_dim, window, scale_log2, s)
          : viem::launch<128>(q, k, v, o, batch, seq, heads, kv_heads,
                              head_dim, window, scale_log2, s);
  return static_cast<int>(err);
}

const char* viem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
