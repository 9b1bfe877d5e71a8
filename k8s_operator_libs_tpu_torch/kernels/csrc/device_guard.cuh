// Shared by the port's kernel sources (included, not compiled alone).

#pragma once

#include <cuda_runtime.h>

namespace {

// Makes `device` current for a launch and gives the caller back its own
// current device afterwards.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
    } else {
      prev = -1;  // nothing to restore
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace
