// Page-locked host blocks for the gain call's readback
// (core/pinned.py): cudaHostAlloc and cudaFreeHost behind a plain C
// interface, so the port owns these blocks itself instead of borrowing
// them from PyTorch's caching host allocator, whose cache other code of
// the process shares.  Not a kernel; built and loaded like the kernels
// (kernels/cuda.py).
#include <cuda_runtime.h>
#include <stddef.h>

extern "C" {

// *out = a page-locked block of ``bytes`` bytes, pinned for every
// context (cudaHostAllocPortable).  Returns a cudaError_t code.
int viem_host_alloc(size_t bytes, void** out) {
  *out = nullptr;
  return static_cast<int>(cudaHostAlloc(out, bytes, cudaHostAllocPortable));
}

// Returns a block of viem_host_alloc to the driver.
int viem_host_free(void* ptr) {
  return static_cast<int>(cudaFreeHost(ptr));
}

const char* viem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
