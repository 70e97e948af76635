// DeviceScope, shared by the entry points of every csrc/*.cu library.

#pragma once

#include <cuda_runtime.h>

namespace {

// Makes `device` current for one entry point and gives the calling thread
// its own current device back when the entry point returns, so that a
// launch on one card never changes the device the caller (and torch) sees.
class DeviceScope {
 public:
  cudaError_t enter(int device) {
    cudaError_t err = cudaGetDevice(&prev_);
    if (err != cudaSuccess || prev_ == device) return err;
    err = cudaSetDevice(device);
    changed_ = err == cudaSuccess;
    return err;
  }
  ~DeviceScope() {
    if (changed_) cudaSetDevice(prev_);
  }

 private:
  int prev_ = 0;
  bool changed_ = false;
};

}  // namespace
