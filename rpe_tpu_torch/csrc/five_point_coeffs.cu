// P1: the 5-point constraint coefficients, K4's input, in one launch.
//
// No TPU kernel of its own: it replaces, on the card, the plain PyTorch
// body of geometry/five_point.py `constraint_coeffs` (the reference's
// rpe_tpu/geometry/five_point.py `_householder_null4` and
// `_build_constraint_coeffs`, which XLA fuses). That body is about a
// hundred small launches of batched products (torch.matmul in the
// Householder steps, 72 torch.einsum calls over the monomial tables) whose
// kernels, and so whose summation order, cuBLAS picks by the batch size:
// the same hypothesis got other coefficients in another batch. Here every
// output element is computed by one fixed lane in an order written in this
// file, so a hypothesis's coefficients do not depend on how many others
// share its launch.
//
// One warp per hypothesis (minimal sample of 5 correspondences):
//   1. the 5 epipolar rows, as the 9 x 5 matrix R = A^T in shared memory;
//   2. Householder QR of R, the plain version's five steps: every lane
//      forms the reflector v of column k from shared memory (the same sums
//      in the same order on every lane), then lane 16 + j updates column j
//      of R and lane r updates row r of Q (Q = I to start), so no two
//      lanes write one element; null4 = Q[:, 5:9];
//   3. the 13 degree-2 polynomials (3 minors of E for det E, the 9 entries
//      of E E^T, its trace): lane l < 10 owns monomial l of all of them;
//   4. the 10 cubic constraints over the 20 monomials of degree <= 3: lane
//      l < 20 owns monomial l of all 10 rows;
//   5. the row norms (lane r < 10 sums row r over its 20 monomials in
//      order) and the division.
// The arithmetic is float64 from the inputs on and rounds once to float32
// at the outputs, so that the coefficients are as close to exact as the
// float32 inputs allow (the plain float32 version's error is held against
// a float64 run of it in chip_smoke.py).
//
// Bound on this card: bytes, 80 B in and 944 B out per hypothesis against
// ~7.8e3 operations (Householder ~2.3e3, the products ~4.8e3, norms and
// division ~0.6e3; chip_smoke.py P1_OPS); in practice the latency of a
// warp's dependent float64 steps through shared memory. The warp keeps
// its ~3.7 KB of float64 state in shared memory (81 entries of Q alone
// would spill in one thread's registers).
//
// Tables: the monomial order is that of geometry/five_point.py (_M1, _M2,
// _M3); `five_point_coeffs_tables` exports the multiplication tables
// T1 (4, 4, 10) and T2 (10, 4, 20) dense, so the wrapper can hold them to
// `_mul_tables()`.

#include <cuda_runtime.h>
#include <math.h>

#include "error_string.cuh"

#define WARPS 4          // hypotheses (warps) per block
#define EPS 1e-20

// T1: degree-1 x degree-1 -> degree-2. For degree-2 monomial m, the
// (a, b) index pairs of _M1 whose product is m, ascending; -1 pads.
#define T1_A {0, -1, 0, 1, 0, 2, 1, -1, 1, 2, \
              2, -1, 0, 3, 1, 3, 2, 3, 3, -1}
#define T1_B {0, -1, 1, 0, 2, 0, 1, -1, 2, 1, \
              2, -1, 3, 0, 3, 1, 3, 2, 3, -1}
// T2: degree-2 (index into _M2) x degree-1 (_M1) -> degree-3 monomial m
// of _M3: up to 3 pairs, ascending; -1 pads.
#define T2_A {0, -1, -1, 0, 1, -1, 0, 2, -1, 1, 3, -1, 1, 2, 4, \
              2, 5, -1, 3, -1, -1, 3, 4, -1, 4, 5, -1, 5, -1, -1, \
              0, 6, -1, 1, 6, 7, 2, 6, 8, 3, 7, -1, 4, 7, 8, \
              5, 8, -1, 6, 9, -1, 7, 9, -1, 8, 9, -1, 9, -1, -1}
#define T2_B {0, -1, -1, 1, 0, -1, 2, 0, -1, 1, 0, -1, 2, 1, 0, \
              2, 0, -1, 1, -1, -1, 2, 1, -1, 2, 1, -1, 2, -1, -1, \
              3, 0, -1, 3, 1, 0, 3, 2, 0, 3, 1, -1, 3, 2, 1, \
              3, 2, -1, 3, 0, -1, 3, 1, -1, 3, 2, -1, 3, -1, -1}

// The lanes index the tables by their own monomial, so the kernel reads
// them from constant memory; the host copies (the same literals) feed
// `five_point_coeffs_tables`.
__constant__ int c_t1a[20] = T1_A;
__constant__ int c_t1b[20] = T1_B;
__constant__ int c_t2a[60] = T2_A;
__constant__ int c_t2b[60] = T2_B;
static const int h_t1a[20] = T1_A;
static const int h_t1b[20] = T1_B;
static const int h_t2a[60] = T2_A;
static const int h_t2b[60] = T2_B;

struct WarpState {
    double R[9 * 5];     // A^T, reduced in place
    double Q[9 * 9];     // accumulated reflectors; null4 = Q[:, 5:9]
    double D2[13 * 10];  // minors 0-2, E E^T (3 i + j) 3-11, trace 12
    double C[10 * 20];   // raw constraint coefficients
    double rn[10];       // row norms
};

// entry c (0: x, 1: y, 2: z, 3: 1) of E[i][j] = null4 row 3 i + j
__device__ __forceinline__ double ep(const WarpState& s, int i, int j, int c) {
    return s.Q[(3 * i + j) * 9 + 5 + c];
}

// degree-2 coefficient m of the product of E[i0][j0] and E[i1][j1]
__device__ __forceinline__ double mul11(const WarpState& s, int m, int i0,
                                        int j0, int i1, int j1) {
    double acc = ep(s, i0, j0, c_t1a[m * 2]) * ep(s, i1, j1, c_t1b[m * 2]);
    if (c_t1a[m * 2 + 1] >= 0)
        acc += ep(s, i0, j0, c_t1a[m * 2 + 1]) * ep(s, i1, j1, c_t1b[m * 2 + 1]);
    return acc;
}

// degree-3 coefficient m of the product of degree-2 poly d and E[i][j]
__device__ __forceinline__ double mul21(const WarpState& s, int m, int d,
                                        int i, int j) {
    double acc = 0.0;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
        const int a = c_t2a[m * 3 + p];
        if (a >= 0) acc += s.D2[d * 10 + a] * ep(s, i, j, c_t2b[m * 3 + p]);
    }
    return acc;
}

__global__ void __launch_bounds__(WARPS * 32)
coeffs_kernel(const float* __restrict__ pts1, const float* __restrict__ pts2,
              float* __restrict__ null4, float* __restrict__ coeffs, int M) {
    __shared__ WarpState st[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long h = (long long)blockIdx.x * WARPS + warp;
    if (h >= M) return;
    WarpState& s = st[warp];

    // 1. R = A^T: R[i][j] = entry i of the epipolar row of point j
    if (lane < 5) {
        const double x1 = pts1[h * 10 + 2 * lane], y1 = pts1[h * 10 + 2 * lane + 1];
        const double x2 = pts2[h * 10 + 2 * lane], y2 = pts2[h * 10 + 2 * lane + 1];
        const double row[9] = {x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                               x1, y1, 1.0};
#pragma unroll
        for (int i = 0; i < 9; ++i) s.R[i * 5 + lane] = row[i];
    }
    for (int e = lane; e < 81; e += 32) s.Q[e] = (e / 9 == e % 9) ? 1.0 : 0.0;
    __syncwarp();

    // 2. Householder steps k = 0..4 on R's rows k..8
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const int len = 9 - k;
        double v[9];
        double nx = 0.0;
#pragma unroll
        for (int i = 0; i < 9; ++i) {
            if (i < len) {
                v[i] = s.R[(k + i) * 5 + k];
                nx += v[i] * v[i];
            }
        }
        nx = sqrt(nx + EPS);
        v[0] = v[0] + (v[0] >= 0.0 ? 1.0 : -1.0) * nx;
        double vn2 = 0.0;
#pragma unroll
        for (int i = 0; i < 9; ++i)
            if (i < len) vn2 += v[i] * v[i];
        vn2 += EPS;
        __syncwarp();      // every lane has read column k before it changes
        if (lane >= 16 && lane < 21 && lane - 16 >= k) {
            const int j = lane - 16;
            double vr = 0.0;
#pragma unroll
            for (int i = 0; i < 9; ++i)
                if (i < len) vr += v[i] * s.R[(k + i) * 5 + j];
#pragma unroll
            for (int i = 0; i < 9; ++i)
                if (i < len) s.R[(k + i) * 5 + j] += (-2.0 * v[i] * vr) / vn2;
        }
        if (lane < 9) {
            double qv = 0.0;
#pragma unroll
            for (int i = 0; i < 9; ++i)
                if (i < len) qv += s.Q[lane * 9 + k + i] * v[i];
#pragma unroll
            for (int i = 0; i < 9; ++i)
                if (i < len) s.Q[lane * 9 + k + i] += (-2.0 * qv * v[i]) / vn2;
        }
        __syncwarp();
    }
    if (lane < 9) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
            null4[h * 36 + lane * 4 + c] = (float)s.Q[lane * 9 + 5 + c];
    }

    // 3. degree-2 polynomials: lane m < 10 owns monomial m
    if (lane < 10) {
        const int m = lane;
        // minor(1, 2, c0, c1) for (c0, c1) = (1, 2), (0, 2), (0, 1)
        s.D2[0 * 10 + m] = mul11(s, m, 1, 1, 2, 2) - mul11(s, m, 1, 2, 2, 1);
        s.D2[1 * 10 + m] = mul11(s, m, 1, 0, 2, 2) - mul11(s, m, 1, 2, 2, 0);
        s.D2[2 * 10 + m] = mul11(s, m, 1, 0, 2, 1) - mul11(s, m, 1, 1, 2, 0);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                double acc = mul11(s, m, i, 0, j, 0);
                acc += mul11(s, m, i, 1, j, 1);
                acc += mul11(s, m, i, 2, j, 2);
                s.D2[(3 + 3 * i + j) * 10 + m] = acc;
            }
        s.D2[12 * 10 + m] = (s.D2[3 * 10 + m] + s.D2[7 * 10 + m])
                            + s.D2[11 * 10 + m];
    }
    __syncwarp();

    // 4. the 10 constraints: lane m < 20 owns monomial m of every row
    double c[10];
    if (lane < 20) {
        const int m = lane;
        c[0] = (mul21(s, m, 0, 0, 0) - mul21(s, m, 1, 0, 1))
               + mul21(s, m, 2, 0, 2);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                double acc = mul21(s, m, 3 + 3 * i, 0, j);
                acc += mul21(s, m, 3 + 3 * i + 1, 1, j);
                acc += mul21(s, m, 3 + 3 * i + 2, 2, j);
                c[1 + 3 * i + j] = acc * 2.0 - mul21(s, m, 12, i, j);
            }
#pragma unroll
        for (int r = 0; r < 10; ++r) s.C[r * 20 + m] = c[r];
    }
    __syncwarp();

    // 5. row norms, then the normalized coefficients
    if (lane < 10) {
        double acc = 0.0;
#pragma unroll
        for (int m = 0; m < 20; ++m) acc += s.C[lane * 20 + m] * s.C[lane * 20 + m];
        s.rn[lane] = sqrt(acc + EPS);
    }
    __syncwarp();
    if (lane < 20) {
#pragma unroll
        for (int r = 0; r < 10; ++r)
            coeffs[h * 200 + r * 20 + lane] = (float)(c[r] / s.rn[r]);
    }
}

// pts1, pts2 (M, 5, 2) float32 -> null4 (M, 9, 4), coeffs (M, 10, 20)
extern "C" int five_point_coeffs_launch(const float* pts1, const float* pts2,
                                        float* null4, float* coeffs, int M,
                                        void* stream) {
    if (M <= 0) return 0;
    coeffs_kernel<<<(M + WARPS - 1) / WARPS, WARPS * 32, 0,
                    (cudaStream_t)stream>>>(pts1, pts2, null4, coeffs, M);
    return (int)cudaGetLastError();
}

// The multiplication tables as dense 0/1 arrays: T1 (4, 4, 10) then
// T2 (10, 4, 20), in `_mul_tables()`'s layout.
extern "C" void five_point_coeffs_tables(int* out) {
    for (int e = 0; e < 160 + 800; ++e) out[e] = 0;
    for (int m = 0; m < 10; ++m)
        for (int p = 0; p < 2; ++p)
            if (h_t1a[m * 2 + p] >= 0)
                out[(h_t1a[m * 2 + p] * 4 + h_t1b[m * 2 + p]) * 10 + m] = 1;
    for (int m = 0; m < 20; ++m)
        for (int p = 0; p < 3; ++p)
            if (h_t2a[m * 3 + p] >= 0)
                out[160 + (h_t2a[m * 3 + p] * 4 + h_t2b[m * 3 + p]) * 20 + m] = 1;
}
