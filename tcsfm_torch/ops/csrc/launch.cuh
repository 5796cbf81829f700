// The device of one C entry point's launch.
//
// The library links nvcc's static CUDA runtime (nvcc's default; no
// -cudart shared), so it does not depend on finding the same libcudart
// that PyTorch brought. That runtime's current device starts at the
// first card. Each entry point therefore takes the index of the card its
// tensors live on and makes it current for its launch, then restores the
// device that was current before, so the caller's (PyTorch's) current
// device is left as it was. The stream passed in belongs to that card.

#pragma once

#include <cuda_runtime.h>

class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    status_ = cudaGetDevice(&prev_);
    if (status_ == cudaSuccess && prev_ != device) {
      status_ = cudaSetDevice(device);
      switched_ = status_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  cudaError_t status() const { return status_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t status_;
};
