// Opting a kernel in to more than 48 KB of dynamic shared memory.
//
// cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...) acts on the
// current device's context, so every device needs its own opt-in: a flag
// kept once a process would leave the second card's first launch above
// 48 KB refused.  Each kernel instance keeps one record per device.
#pragma once

#include <cuda_runtime.h>

namespace smem_optin {

constexpr int MAX_DEVICES = 64;

// Opts `kern` in to `bytes` of dynamic shared memory on the current device
// unless `done` records at least that much there already.
template <typename K>
inline cudaError_t ensure(K kern, int bytes, int (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return e;
  done[dev] = bytes;
  return cudaSuccess;
}

}  // namespace smem_optin
