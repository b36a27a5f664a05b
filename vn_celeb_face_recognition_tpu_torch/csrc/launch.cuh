// Host helper shared by the C entry points of csrc/*.cu.
#pragma once

#include <cuda_runtime.h>

// Make the device that holds `ptr` current for the calling thread, so a
// launch on that device's stream works whichever device the caller had
// current. Returns a cudaError_t as int (0 on success).
static inline int vn_set_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, ptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaSetDevice(attr.device);
}
