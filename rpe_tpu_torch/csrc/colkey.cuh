// Column argmin across blocks for K7's mutual-NN kernel (match_l2.cu; K3 in
// match_hamming.cu keeps 32-bit keys of its own).
//
// Blocks run in no order, so a column's argmin cannot be carried tile to
// tile as the TPU kernels did over their sequential grid. Each warp folds
// its per-column minimum into colkey[col] (set to ~0 before the launch) with
// a 64-bit atomicMin on (key << 32 | row), which orders by distance, then by
// the lowest row; key is `ordered_key` of the distance.
// `finalize_cols` maps the keys to indices with the reference's canonical
// output: index 0 for an invalid column or a column without valid rows.

#pragma once

#include <cuda_runtime.h>

// order-preserving map of a distance d >= 0 (or -0.0, taken as +0.0 so that
// ties at 0 fall to the lowest row) onto uint32
__device__ __forceinline__ unsigned int ordered_key(float d) {
    return (__float_as_uint(d) & 0x7FFFFFFFu) | 0x80000000u;
}

__global__ void finalize_cols(const unsigned long long* __restrict__ colkey,
                              const bool* __restrict__ valid2, int* __restrict__ nn21,
                              int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    unsigned long long k = colkey[i];
    nn21[i] = (valid2[i] && k != ~0ull) ? (int)(k & 0xffffffffull) : 0;
}
