// The error convention of every library in csrc/: an entry point returns 0,
// a cudaError_t, or one of the codes below, which sit past CUDA's own; each
// library exports one decoder for all of them. Include this header once per
// library, from its .cu source.
#pragma once

#include <cuda_runtime.h>

constexpr int ENCODER_MISSING = 10000;  // libcuda has no cuTensorMapEncodeTiled
constexpr int ENCODE_FAILED = 10001;    // cuTensorMapEncodeTiled refused a tensor map

extern "C" const char* deepxi_error_string(int code) {
  switch (code) {
    case ENCODER_MISSING: return "libcuda has no cuTensorMapEncodeTiled";
    case ENCODE_FAILED: return "cuTensorMapEncodeTiled refused a tensor map";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}
