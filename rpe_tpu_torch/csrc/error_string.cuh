// The error text every kernel library exports, so that ops/kernels.py can
// name a failed launch's cudaError_t.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* rpe_cuda_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
