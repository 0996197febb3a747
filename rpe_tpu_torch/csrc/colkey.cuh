// Column argmin across blocks for K7's mutual-NN kernel (match_l2.cu; K3 in
// match_hamming.cu keeps 32-bit keys of its own).
//
// Blocks run in no order, so a column's argmin cannot be carried tile to
// tile as the TPU kernels did over their sequential grid. Each block folds
// its per-column minimum into colkey[col] with a 64-bit atomicMin on
// (key << 32 | row), which orders by distance, then by the lowest row; key
// is `ordered_key` of the distance.
// `finalize_cols` maps the keys to indices with the reference's canonical
// output: index 0 for an invalid column or a column without valid rows.

#pragma once

#include <cuda_runtime.h>

// order-preserving map of a float onto uint32 (negative values included);
// -0.0 is taken as +0.0 so that ties at 0 fall to the lowest row
__device__ __forceinline__ unsigned int ordered_key(float d) {
    if (d == 0.0f) d = 0.0f;
    unsigned int u = __float_as_uint(d);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void init_colkey(unsigned long long* colkey, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) colkey[i] = ~0ull;
}

__global__ void finalize_cols(const unsigned long long* __restrict__ colkey,
                              const bool* __restrict__ valid2, int* __restrict__ nn21,
                              int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    unsigned long long k = colkey[i];
    nn21[i] = (valid2[i] && k != ~0ull) ? (int)(k & 0xffffffffull) : 0;
}
