// K7: squared-L2 mutual nearest neighbours, and K6 in L2 mode: per-row best,
// argbest and second-best distance, batched over pairs of (N, 128) float32
// descriptor sets.
//
// Replaces rpe_tpu/ops/match_pallas.py `mutual_nn_l2sq` (`_mutual_nn`, body
// `_match_kernel`) and `_row_top2` (body `_ratio_kernel`) with norm="l2".
// The TPU kernels streamed (128, N2) Gram tiles through the MXU, reduced rows
// over |b|^2 - 2 a.b and columns over |a|^2 - 2 a.b (a quantity that can be
// negative), and carried the column argmin across their sequential grid.
// Here the distance is the plain version's own formula,
// max(|a|^2 + |b|^2 - 2 a.b, 0), so ties at 0 (duplicate descriptors) and
// every argmin follow the plain version up to float32 reassociation of the
// 128-term dot product. The (N1, N2) matrix never reaches memory.
//
// Layout: one block per (64-row tile, pair); 256 threads as 16 x 16, thread
// (ty, tx) owning rows 4 ty + r and columns 4 tx + c (r, c < 4) of every
// 64-column tile it streams, with 16 float32 FMA accumulators (no TF32, no
// tensor cores). The row tile stays in shared memory transposed ([k][row])
// and column tiles stream in 32-dimension chunks, so a thread reads its four
// rows and its four columns of one dimension as one float4 each.
// - Rows: a running (min, argmin) per thread in increasing column order
//   (strict <, so the lowest index wins), then a lexicographic (distance,
//   column) shuffle reduction over the 16 threads of a row. In top-2 mode
//   the running state is (best, argbest, second), second being the minimum
//   over every other valid column, so it equals best when best is tied at
//   another index (`_ratio_kernel`).
// - Columns (K7): blocks run in no order, so each column's per-block minimum
//   goes through a 64-bit atomicMin on (ordered_key(d) << 32 | row), an
//   order-preserving map of the float (-0.0 taken as +0.0), so the smallest
//   distance wins and then the lowest row.
// A finalize pass maps the column keys to indices with the reference's
// canonical outputs: best_d = _BIG and index 0 for an invalid row or a row
// without valid columns, index 0 for an invalid column or a column without
// valid rows; in top-2 mode an invalid row gives (_BIG, 0, _BIG).
//
// Bound on this card: operations, 2 * N1 * N2 * 128 FLOP per pair at the
// float32 CUDA-core rate, against 2 * N * 512 bytes of descriptors that are
// re-read per row tile from L2. Two shared-memory vector loads per 16 FMAs
// keep the loop on the FMA pipe; tensor cores (TF32, bf16) would change the
// reassociation contract and are left to a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "colkey.cuh"
#include "error_string.cuh"

#define RT 64
#define CT 64
#define DIM 128
#define KC 32
#define PAD 4
#define NTHREADS 256
#define BIG_F 3.0e38f

__global__ void sq_norms(const float* __restrict__ x, float* __restrict__ out, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float4* p = reinterpret_cast<const float4*>(x + (size_t)i * DIM);
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < DIM / 4; ++k) {
        float4 v = p[k];
        s = fmaf(v.x, v.x, s);
        s = fmaf(v.y, v.y, s);
        s = fmaf(v.z, v.z, s);
        s = fmaf(v.w, v.w, s);
    }
    out[i] = s;
}

template <bool TOP2>
__global__ void __launch_bounds__(NTHREADS)
match_l2_kernel(const float* __restrict__ desc1, const float* __restrict__ desc2,
                const float* __restrict__ norm1, const float* __restrict__ norm2,
                const bool* __restrict__ valid1, const bool* __restrict__ valid2,
                float* __restrict__ out_d1, int* __restrict__ out_i1,
                float* __restrict__ out_d2, unsigned long long* __restrict__ colkey,
                int N1, int N2) {
    __shared__ __align__(16) float s_a[DIM][RT + PAD];
    __shared__ __align__(16) float s_b[KC][CT + PAD];
    __shared__ float s_nb[CT];
    __shared__ bool s_bv[CT];
    __shared__ unsigned long long s_col[CT];

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int pair = blockIdx.y;
    const int row0 = blockIdx.x * RT;
    const float* A = desc1 + (size_t)pair * N1 * DIM;
    const float* B = desc2 + (size_t)pair * N2 * DIM;
    const float* NA = norm1 + (size_t)pair * N1;
    const float* NB = norm2 + (size_t)pair * N2;
    const bool* V1 = valid1 + (size_t)pair * N1;
    const bool* V2 = valid2 + (size_t)pair * N2;
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

    // stage the row tile transposed: thread -> (row f / 32, float4 f % 32)
    for (int f = tid; f < RT * DIM / 4; f += NTHREADS) {
        int r = f >> 5, k4 = f & 31;
        int gi = row0 + r;
        float4 v = gi < N1 ? reinterpret_cast<const float4*>(A + (size_t)gi * DIM)[k4]
                           : zero4;
        s_a[4 * k4 + 0][r] = v.x;
        s_a[4 * k4 + 1][r] = v.y;
        s_a[4 * k4 + 2][r] = v.z;
        s_a[4 * k4 + 3][r] = v.w;
    }

    float na[4], rbest[4], rsec[4];
    int rarg[4];
    bool rv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        int gi = row0 + 4 * ty + r;
        rv[r] = gi < N1 && V1[gi];
        na[r] = gi < N1 ? NA[gi] : 0.0f;
        rbest[r] = BIG_F;
        rsec[r] = BIG_F;
        rarg[r] = 0;
    }

    for (int col0 = 0; col0 < N2; col0 += CT) {
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

        for (int kc = 0; kc < DIM; kc += KC) {
            __syncthreads();
            // column chunk: thread -> (column f / 8, float4 f % 8 of the chunk)
            for (int f = tid; f < CT * KC / 4; f += NTHREADS) {
                int c = f >> 3, k4 = f & 7;
                int gj = col0 + c;
                float4 v = gj < N2
                    ? reinterpret_cast<const float4*>(B + (size_t)gj * DIM + kc)[k4]
                    : zero4;
                s_b[4 * k4 + 0][c] = v.x;
                s_b[4 * k4 + 1][c] = v.y;
                s_b[4 * k4 + 2][c] = v.z;
                s_b[4 * k4 + 3][c] = v.w;
            }
            if (kc == 0 && tid < CT) {
                int gj = col0 + tid;
                s_bv[tid] = gj < N2 && V2[gj];
                s_nb[tid] = gj < N2 ? NB[gj] : 0.0f;
                s_col[tid] = ~0ull;
            }
            __syncthreads();
#pragma unroll 8
            for (int k = 0; k < KC; ++k) {
                float4 a = *reinterpret_cast<const float4*>(&s_a[kc + k][4 * ty]);
                float4 b = *reinterpret_cast<const float4*>(&s_b[k][4 * tx]);
                float av[4] = {a.x, a.y, a.z, a.w};
                float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
            }
        }

#pragma unroll
        for (int c = 0; c < 4; ++c) {
            int cl = 4 * tx + c;
            int gj = col0 + cl;
            bool cv = s_bv[cl];
            float nbj = s_nb[cl];
            unsigned long long ckey = ~0ull;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                float d = fmaxf((na[r] + nbj) - 2.0f * acc[r][c], 0.0f);
                if (TOP2) {
                    if (cv) {
                        if (d < rbest[r]) {
                            rsec[r] = rbest[r];
                            rbest[r] = d;
                            rarg[r] = gj;
                        } else if (d < rsec[r]) {
                            rsec[r] = d;
                        }
                    }
                } else {
                    if (cv && d < rbest[r]) { rbest[r] = d; rarg[r] = gj; }
                    if (rv[r]) {
                        unsigned long long key = ((unsigned long long)ordered_key(d) << 32)
                                                 | (unsigned)(row0 + 4 * ty + r);
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
        float d = rbest[r], s = rsec[r];
        int j = rarg[r];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
            float d2 = __shfl_xor_sync(0xffffffffu, d, off, 16);
            int j2 = __shfl_xor_sync(0xffffffffu, j, off, 16);
            float s2 = __shfl_xor_sync(0xffffffffu, s, off, 16);
            if (d2 < d || (d2 == d && j2 < j)) {
                s = fminf(s2, d);
                d = d2;
                j = j2;
            } else {
                s = fminf(s, d2);
            }
        }
        int gi = row0 + 4 * ty + r;
        if (tx == 0 && gi < N1) {
            size_t o = (size_t)pair * N1 + gi;
            out_d1[o] = rv[r] ? d : BIG_F;
            out_i1[o] = rv[r] ? j : 0;
            if (TOP2) out_d2[o] = rv[r] ? s : BIG_F;
        }
    }
}

static inline int blocks(int n) { return (n + 255) / 256; }

extern "C" int match_l2_launch(const float* desc1, const float* desc2, const bool* valid1,
                               const bool* valid2, float* best_d, int* nn12, int* nn21,
                               float* norm1, float* norm2, unsigned long long* colkey,
                               int P, int N1, int N2, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int n1 = P * N1, n2 = P * N2;
    if (n1 > 0) sq_norms<<<blocks(n1), 256, 0, s>>>(desc1, norm1, n1);
    if (n2 > 0) {
        sq_norms<<<blocks(n2), 256, 0, s>>>(desc2, norm2, n2);
        init_colkey<<<blocks(n2), 256, 0, s>>>(colkey, n2);
    }
    if (n1 > 0) {
        dim3 grid((N1 + RT - 1) / RT, P);
        match_l2_kernel<false><<<grid, NTHREADS, 0, s>>>(desc1, desc2, norm1, norm2, valid1,
                                                         valid2, best_d, nn12, nullptr,
                                                         colkey, N1, N2);
    }
    if (n2 > 0) finalize_cols<<<blocks(n2), 256, 0, s>>>(colkey, valid2, nn21, n2);
    return (int)cudaGetLastError();
}

extern "C" int row_top2_l2_launch(const float* desc1, const float* desc2, const bool* valid1,
                                  const bool* valid2, float* d1, int* a1, float* d2,
                                  float* norm1, float* norm2, int P, int N1, int N2,
                                  void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int n1 = P * N1, n2 = P * N2;
    if (n1 > 0) sq_norms<<<blocks(n1), 256, 0, s>>>(desc1, norm1, n1);
    if (n2 > 0) sq_norms<<<blocks(n2), 256, 0, s>>>(desc2, norm2, n2);
    if (n1 > 0) {
        dim3 grid((N1 + RT - 1) / RT, P);
        match_l2_kernel<true><<<grid, NTHREADS, 0, s>>>(desc1, desc2, norm1, norm2, valid1,
                                                        valid2, d1, a1, d2, nullptr, N1, N2);
    }
    return (int)cudaGetLastError();
}
