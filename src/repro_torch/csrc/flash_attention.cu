// K4, float32 route — causal / sliding-window GQA flash attention,
// forward, at float32:
//
//   o[b,t,h] = Σ_s softmax_s(q[b,t,h]·k[b,s,h/G]·hd^-½ | mask) · v[b,s,h/G]
//
// with q (B,T,H,hd), k and v (B,S,KV,hd), S = T, G = H/KV, and the mask
// t ≥ s (causal), also t − s < window when window > 0.  Masked scores are
// −1e30.  q·k is taken in float32; the online softmax (running max m,
// running sum l, accumulator acc) is float32; p·v's products accumulate
// in float32; o = acc / max(l, 1e-30).  float32 inputs, hd ∈ {32, 64,
// 96, 128}.  bfloat16 inputs go to csrc/flash_attention_sm90.cu (wgmma
// and TMA); this file keeps float32 only, because the reference's
// float32 q·k is full float32, which the tensor cores (TF32) would not
// give.  It serves the float32 checks of the serving path.
//
// Replaces: src/repro/kernels/flash_attention.py — flash_attention_kernel
// (`_flash_fwd`, body `_flash_kernel`), for float32 inputs.  The TPU
// version runs a grid (B·KV·G, q blocks, kv blocks) whose kv axis is
// sequential, carries m, l and acc across it in VMEM scratch, expands
// GQA through its k/v index map and halves a block size until it
// divides T.
//
// Bound on the H100: operations.  Causal attention does 4·hd flop per
// visible (query, key) pair, 2·B·H·hd·T² in all: 137 GFLOP at the serve
// shape (B 4, T 2048, H 32, hd 128), 2.05 ms at the 67 TFLOP/s float32
// peak of the CUDA cores, which is all full float32 can use; q, k, v and
// o are 168 MB at float32 (0.050 ms at 3.35 TB/s).
//
// Design:
//   * One block of 256 threads per (b, h, 64-row q tile); blockIdx.x runs
//     the q tiles in reverse, so the tiles with the most keys start first.
//     The head's KV head is h / G: GQA shares k and v by indexing, no
//     expanded copy exists.  Blocks run in no order and share nothing.
//   * The q tile is staged once, d-major, in shared memory.  The block
//     then loops over 64-row kv tiles: stage k (d-major) and v
//     (row-major), S = Q·Kᵀ with each thread owning a 4×4 micro-tile
//     (rows 4·ty.., columns 4·tx..), scale, mask, the online softmax
//     update (row max and row sum reduced over the 16 threads of a row
//     group with shuffles), P written over the k tile, then acc += P·V
//     with each thread owning its 4 rows × columns {32c + 2·tx, 32c +
//     2·tx + 1}.
//   * Ragged edges are masked instead of padded: q rows ≥ T and k/v rows
//     ≥ S load as zeros, and only rows < T are stored (the TPU's halving
//     of the block until it divides T is gone).
//   * Tiles the mask empties for every row of the q tile are skipped:
//     those after the diagonal, and with a window those before the first
//     row's first visible key.  Skipping is exact in float32.  A skipped
//     tile after a row's first visible key would add p = exp(−1e30 − m)
//     = 0 with a correction exp(0) = 1.  A tile before it, which a row can
//     also meet inside a tile that is not skipped, leaves m at −1e30 and
//     adds exp(0) = 1 terms to l and acc; the first tile with a visible
//     key rescales them by exp(−1e30 − m) = 0.  Either way the result is
//     the one of visiting every tile, as the TPU kernel does.
//   * Products are explicit __fmaf_rn (the library is built with
//     --fmad=false); exp is the accurate expf; the final divide is
//     __fdiv_rn.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace viem {
namespace {

constexpr int kTile = 64;               // q rows and kv rows of a tile
constexpr int kThreads = 256;           // 16×16: ty = row group, tx = lane
constexpr int kPad = kTile + 4;         // row stride of d-major tiles:
                                        // float4 reads stay aligned
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  // four consecutive elements as float32
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  // p as the reference casts it to v's type before p·v
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store2(float* p, float a,
                                                float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// Rows [r0, r0 + 64) of a (rows, stride) matrix, columns [0, HD), into
// dst[d * kPad + r] (d-major), zero for rows ≥ n_rows.  Consecutive
// threads take consecutive rows, so the transposing stores hit distinct
// banks.
template <typename T, int HD>
__device__ __forceinline__ void stage_dmajor(const T* __restrict__ src,
                                             size_t stride, int r0,
                                             int n_rows, float* dst) {
  for (int e = threadIdx.x; e < kTile * (HD / 4); e += kThreads) {
    const int r = e % kTile;
    const int c = e / kTile;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n_rows)
      x = Elem<T>::load4(src + static_cast<size_t>(r0 + r) * stride + 4 * c);
    dst[(4 * c + 0) * kPad + r] = x.x;
    dst[(4 * c + 1) * kPad + r] = x.y;
    dst[(4 * c + 2) * kPad + r] = x.z;
    dst[(4 * c + 3) * kPad + r] = x.w;
  }
}

// The same rows into dst[r * HD + d] (row-major); consecutive threads
// take consecutive columns of one row.
template <typename T, int HD>
__device__ __forceinline__ void stage_rowmajor(const T* __restrict__ src,
                                               size_t stride, int r0,
                                               int n_rows, float* dst) {
  for (int e = threadIdx.x; e < kTile * (HD / 4); e += kThreads) {
    const int r = e / (HD / 4);
    const int c = e % (HD / 4);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n_rows)
      x = Elem<T>::load4(src + static_cast<size_t>(r0 + r) * stride + 4 * c);
    *reinterpret_cast<float4*>(&dst[r * HD + 4 * c]) = x;
  }
}

// max / sum over the 16 threads of one row group (lanes 16·k .. 16·k+15)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  // q tile + (k tile, reused for P) + v tile, all float32
  return sizeof(float) *
         (static_cast<size_t>(HD) * kPad +
          static_cast<size_t>(HD > kTile ? HD : kTile) * kPad +
          static_cast<size_t>(kTile) * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int seq, int heads,
          int kv_heads, int window, float scale) {
  constexpr int kCols = HD / 32;          // float2 column pairs per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [HD][kPad]
  float* ks = qs + HD * kPad;                         // [HD][kPad] / P
  float* vs = ks + (HD > kTile ? HD : kTile) * kPad;  // [kTile][HD]
  float* ps = ks;                                     // [kTile][kPad]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const size_t q_stride = static_cast<size_t>(heads) * HD;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * HD;
  const size_t q_base = static_cast<size_t>(b) * seq * q_stride +
                        static_cast<size_t>(h) * HD;
  const size_t kv_base = static_cast<size_t>(b) * seq * kv_stride +
                         static_cast<size_t>(kvh) * HD;

  stage_dmajor<T, HD>(q + q_base, q_stride, q0, seq, qs);

  float m[4], l[4], acc[4][kCols][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c][0] = acc[i][c][1] = 0.0f;
  }

  // keys after the tile's last row are masked for every row; with a
  // window, so are the keys before its first row's first visible key
  const int k_end = min(q0 + kTile, seq);
  const int k_begin =
      window > 0 ? max(0, q0 - window + 1) / kTile * kTile : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();            // the previous tile's P and V are consumed
    stage_dmajor<T, HD>(k + kv_base, kv_stride, k0, seq, ks);
    stage_rowmajor<T, HD>(v + kv_base, kv_stride, k0, seq, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d * kPad + 4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&ks[d * kPad + 4 * tx]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float cr[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(ar[i], cr[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const bool visible =
            col <= row && (window <= 0 || row - col < window);
        s[i][j] = visible ? __fmul_rn(s[i][j], scale) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(__fsub_rn(m[i], m_new));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        rs = __fadd_rn(rs, s[i][j]);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), group_sum(rs));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[i][c][0] = __fmul_rn(acc[i][c][0], corr);
        acc[i][c][1] = __fmul_rn(acc[i][c][1], corr);
      }
    }

    __syncthreads();            // every thread is done reading the k tile
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&ps[(4 * tx + j) * kPad + 4 * ty]) =
          make_float4(Elem<T>::round(s[0][j]), Elem<T>::round(s[1][j]),
                      Elem<T>::round(s[2][j]), Elem<T>::round(s[3][j]));
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[j * kPad + 4 * ty]);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float2 w =
            *reinterpret_cast<const float2*>(&vs[j * HD + 32 * c + 2 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = __fmaf_rn(pr[i], w.x, acc[i][c][0]);
          acc[i][c][1] = __fmaf_rn(pr[i], w.y, acc[i][c][1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= seq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + q_base + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      Elem<T>::store2(out + 32 * c + 2 * tx, __fdiv_rn(acc[i][c][0], denom),
                      __fdiv_rn(acc[i][c][1], denom));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int seq, int heads, int kv_heads, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB only after this opt-in, which is per device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, heads, kv_heads,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int seq, int heads, int kv_heads,
                     int head_dim, int window, float scale,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, seq, heads, kv_heads, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, seq, heads, kv_heads, window,
                           scale, stream);
    case 96:
      return launch<T, 96>(q, k, v, o, batch, seq, heads, kv_heads, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, seq, heads, kv_heads, window,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace viem

extern "C" {

// o (B,T,H,hd) from q (B,T,H,hd) and k, v (B,T,KV,hd), all float32 and
// contiguous.  window 0 is full causal attention.  One launch on
// `stream`.  Returns a cudaError_t code.
int viem_flash_attention(const void* q, const void* k, const void* v,
                         void* o, int batch, int seq, int heads,
                         int kv_heads, int head_dim, int window, float scale,
                         void* stream) {
  if (batch < 0 || seq < 0 || heads <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || window < 0 || heads > 65535 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(viem::dispatch<float>(
      q, k, v, o, batch, seq, heads, kv_heads, head_dim, window, scale,
      static_cast<cudaStream_t>(stream)));
}

const char* viem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
