// Hopper (sm_90a) building blocks shared by the kernels that run on the
// tensor cores through TMA: K4's bf16 route (flash_attention_sm90.cu) and
// K3 (swap_gain.cu).  Inline PTX only, so nothing here links against
// libcuda: the tensor-map encoder is looked up through the runtime.
//
//   * mbarriers: init, arrive, arrive with an expected transaction count,
//     and a parity wait that traps after kWaitLimit cycles, so a pipeline
//     fault surfaces as a launch error instead of a hung call;
//   * the shared-memory matrix descriptor of a tile that TMA landed with
//     the 128-byte swizzle (sw128_desc);
//   * the wgmma fences, and VIEM_D* / VIEM_R* for the 64-register (m64
//     n128 f32) accumulator operand lists;
//   * encoder(): cuTensorMapEncodeTiled from the driver.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace viem {

// a wait this long is a fault (a barrier that will never complete):
// trap, so it surfaces as a launch error instead of a hang
constexpr long long kWaitLimit = 1ll << 34;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWaitLimit) __trap();
  }
}

// -------------------------------------------------------------- wgmma
// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins registers that an asynchronous wgmma writes: nothing reads them
// before the wait that precedes this
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// pins A-fragment registers that an asynchronous wgmma reads: they stay
// live, so untouched, until the wait that precedes this
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define VIEM_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VIEM_D32 VIEM_D8(0), VIEM_D8(8), VIEM_D8(16), VIEM_D8(24)
#define VIEM_D64 VIEM_D32, VIEM_D8(32), VIEM_D8(40), VIEM_D8(48), VIEM_D8(56)
#define VIEM_R32                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31"
#define VIEM_R64                                                        \
  VIEM_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "  \
           "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
           "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// ------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up through the runtime, so the
// library links no -lcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace viem
