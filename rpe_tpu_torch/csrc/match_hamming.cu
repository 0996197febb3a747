// K3: Hamming mutual nearest neighbours of {0,1} descriptors, batched over
// pairs; and K6 in Hamming mode: per-row best, argbest and second-best
// distance for the Lowe ratio test (template flag TOP2).
//
// Replaces rpe_tpu/ops/match_pallas.py `_mutual_nn` (`_match_kernel`), which
// computed -2 a.b Gram tiles on the MXU in bf16 and carried the column argmin
// across its sequential grid, and `_row_top2` (`_ratio_kernel`) with
// norm="hamming". Here descriptors are packed to 8 x uint32 on load and
// distances are exact integers, popc(a ^ b) summed over 8 words.
//
// Layout: one block per (64-row tile, pair); 256 threads as 16 x 16, each
// thread owning rows ty + 16 r and columns tx + 16 c (r, c < 4) of every
// 64-column tile it streams. The distance matrix never reaches memory.
// - Rows: each thread keeps a running (min, argmin) for its 4 rows over its
//   column subset in increasing column order (strict <, so the lowest index
//   wins), then the 16 threads of a row reduce lexicographically on
//   (distance, column) with shuffles.
// - Columns: blocks run in no order, so the column argmin cannot be carried
//   tile to tile; each column's per-block minimum goes through a 64-bit
//   atomicMin on (distance << 32 | row), which orders by distance, then by
//   the lowest row.
// A finalize pass maps the column keys to indices and applies the canonical
// outputs of the reference (`_mutual_nn`): best_d = _BIG and index 0 for an
// invalid row or a row without valid columns, index 0 for an invalid column
// or a column without valid rows.
// Top-2 mode has no column pass: each thread keeps (best, argbest, second)
// per row, second being the minimum over every other valid column (so it
// equals best when best is tied at another index), merged over the row's
// 16 threads; an invalid row gives (_BIG, 0, _BIG). Exact, like K3.
//
// Bound on this card: operations. Per pair N1 * N2 * 8 (xor, popc, add)
// against 2 * N * 256 bytes of input; the bytes are re-read per row tile from
// L2. popc issues at a fraction of the fp32 rate, which is the wall of this
// design; the same work as a {0,1} GEMM on the int8 tensor cores is the
// card's bound.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "colkey.cuh"
#include "error_string.cuh"

#define RT 64
#define CT 64
#define NTHREADS 256
#define BIG_F 3.0e38f

__device__ __forceinline__ uint32_t pack32(const uint8_t* p) {
    // 32 consecutive bytes in {0,1} -> 32 bits, byte k -> bit k
    const uint4* q = reinterpret_cast<const uint4*>(p);
    uint32_t w = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        uint4 v = q[h];
        uint32_t parts[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int b = 0; b < 4; ++b)
                if ((parts[j] >> (8 * b)) & 0xFFu) w |= 1u << (h * 16 + j * 4 + b);
    }
    return w;
}

template <bool TOP2>
__global__ void __launch_bounds__(NTHREADS)
match_hamming_kernel(const uint8_t* __restrict__ bits1, const uint8_t* __restrict__ bits2,
                     const bool* __restrict__ valid1, const bool* __restrict__ valid2,
                     float* __restrict__ best_d, int* __restrict__ nn12,
                     float* __restrict__ second_d,
                     unsigned long long* __restrict__ colkey, int N1, int N2) {
    __shared__ uint32_t s_a[8][RT];
    __shared__ uint32_t s_b[8][CT];
    __shared__ bool s_bv[CT];
    __shared__ unsigned long long s_col[CT];

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int pair = blockIdx.y;
    const int row0 = blockIdx.x * RT;
    const uint8_t* A = bits1 + (size_t)pair * N1 * 256;
    const uint8_t* B = bits2 + (size_t)pair * N2 * 256;
    const bool* V1 = valid1 + (size_t)pair * N1;
    const bool* V2 = valid2 + (size_t)pair * N2;

    {   // pack the row tile: thread -> (row tid / 4, words 2 (tid % 4) + {0, 1})
        int r = tid >> 2, w0 = (tid & 3) * 2;
        int gi = row0 + r;
#pragma unroll
        for (int k = 0; k < 2; ++k)
            s_a[w0 + k][r] = gi < N1 ? pack32(A + (size_t)gi * 256 + (w0 + k) * 32) : 0u;
    }
    __syncthreads();

    uint32_t a[4][8];
    bool rv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        int gi = row0 + ty + 16 * r;
        rv[r] = gi < N1 && V1[gi];
#pragma unroll
        for (int w = 0; w < 8; ++w) a[r][w] = s_a[w][ty + 16 * r];
    }
    int rbest[4], rarg[4], rsec[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) { rbest[r] = INT_MAX; rarg[r] = 0; rsec[r] = INT_MAX; }

    for (int col0 = 0; col0 < N2; col0 += CT) {
        __syncthreads();
        {
            int c = tid >> 2, w0 = (tid & 3) * 2;
            int gj = col0 + c;
#pragma unroll
            for (int k = 0; k < 2; ++k)
                s_b[w0 + k][c] = gj < N2 ? pack32(B + (size_t)gj * 256 + (w0 + k) * 32) : 0u;
            if (tid < CT) {
                s_bv[tid] = (col0 + tid) < N2 && V2[col0 + tid];
                s_col[tid] = ~0ull;
            }
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            int cl = tx + 16 * c;
            uint32_t b[8];
#pragma unroll
            for (int w = 0; w < 8; ++w) b[w] = s_b[w][cl];
            bool cv = s_bv[cl];
            unsigned long long ckey = ~0ull;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                int d = 0;
#pragma unroll
                for (int w = 0; w < 8; ++w) d += __popc(a[r][w] ^ b[w]);
                if (TOP2) {
                    if (cv) {
                        if (d < rbest[r]) {
                            rsec[r] = rbest[r];
                            rbest[r] = d;
                            rarg[r] = col0 + cl;
                        } else if (d < rsec[r]) {
                            rsec[r] = d;
                        }
                    }
                } else {
                    if (cv && d < rbest[r]) { rbest[r] = d; rarg[r] = col0 + cl; }
                    if (rv[r]) {
                        unsigned long long key =
                            ((unsigned long long)d << 32) | (unsigned)(row0 + ty + 16 * r);
                        ckey = key < ckey ? key : ckey;
                    }
                }
            }
            if (!TOP2 && cv && ckey != ~0ull) atomicMin(&s_col[cl], ckey);
        }
        __syncthreads();
        if (!TOP2 && tid < CT && s_col[tid] != ~0ull)
            atomicMin(&colkey[(size_t)pair * N2 + col0 + tid], s_col[tid]);
    }

    // row reduction across the 16 threads (tx) sharing each row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        int d = rbest[r], j = rarg[r], sd = rsec[r];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
            int d2 = __shfl_xor_sync(0xffffffffu, d, off, 16);
            int j2 = __shfl_xor_sync(0xffffffffu, j, off, 16);
            int s2 = __shfl_xor_sync(0xffffffffu, sd, off, 16);
            if (d2 < d || (d2 == d && j2 < j)) {
                sd = min(s2, d);
                d = d2;
                j = j2;
            } else {
                sd = min(sd, d2);
            }
        }
        int gi = row0 + ty + 16 * r;
        if (tx == 0 && gi < N1) {
            bool ok = rv[r] && d != INT_MAX;
            best_d[(size_t)pair * N1 + gi] = ok ? (float)d : BIG_F;
            nn12[(size_t)pair * N1 + gi] = ok ? j : 0;
            if (TOP2)
                second_d[(size_t)pair * N1 + gi] =
                    (rv[r] && sd != INT_MAX) ? (float)sd : BIG_F;
        }
    }
}

extern "C" int match_hamming_launch(const uint8_t* bits1, const uint8_t* bits2,
                                    const bool* valid1, const bool* valid2,
                                    float* best_d, int* nn12, int* nn21,
                                    unsigned long long* colkey, int P, int N1,
                                    int N2, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int ncol = P * N2;
    init_colkey<<<(ncol + 255) / 256, 256, 0, s>>>(colkey, ncol);
    dim3 grid((N1 + RT - 1) / RT, P);
    match_hamming_kernel<false><<<grid, NTHREADS, 0, s>>>(bits1, bits2, valid1, valid2,
                                                          best_d, nn12, nullptr, colkey,
                                                          N1, N2);
    finalize_cols<<<(ncol + 255) / 256, 256, 0, s>>>(colkey, valid2, nn21, ncol);
    return (int)cudaGetLastError();
}

extern "C" int row_top2_hamming_launch(const uint8_t* bits1, const uint8_t* bits2,
                                       const bool* valid1, const bool* valid2, float* d1,
                                       int* a1, float* d2, int P, int N1, int N2,
                                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (P * N1 == 0) return (int)cudaGetLastError();
    dim3 grid((N1 + RT - 1) / RT, P);
    match_hamming_kernel<true><<<grid, NTHREADS, 0, s>>>(bits1, bits2, valid1, valid2, d1,
                                                         a1, d2, nullptr, N1, N2);
    return (int)cudaGetLastError();
}
