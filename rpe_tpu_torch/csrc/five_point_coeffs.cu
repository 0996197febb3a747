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
// One block of THREADS threads per hypothesis (minimal sample of 5
// correspondences), each step giving every thread its own output elements,
// with a block barrier between steps:
//   1. the 5 epipolar rows, as the 9 x 5 matrix R = A^T: a thread per
//      entry;
//   2. Householder QR of R, the plain version's five steps: every thread
//      forms the reflector v of column k (the same sums in the same order
//      on every thread), then owns one element of R's rows and columns >= k
//      or of Q's columns >= k (Q = I to start): it forms its column's
//      v^T R or its row's Q v itself and writes its element's update.
//      R and Q are double-buffered, so a step reads one copy and writes
//      the other behind one barrier; null4 = Q[:, 5:9];
//   3. the 13 degree-2 polynomials (3 minors of E for det E, the 9 entries
//      of E E^T, its trace) over 10 monomials: a thread per coefficient
//      (the trace's threads form its three diagonal entries themselves);
//   4. the 10 cubic constraints over the 20 monomials of degree <= 3: a
//      thread per coefficient;
//   5. the row norms (thread r < 10 sums row r over its 20 monomials in
//      order), then a thread per coefficient for the division.
// The arithmetic is float64 from the inputs on and rounds once to float32
// at the outputs, so that the coefficients are as close to exact as the
// float32 inputs allow (the plain float32 version's error is held against
// a float64 run of it in chip_smoke.py).
//
// Every float64 operation is written as the intrinsic that rounds it
// (__dmul_rn, __dadd_rn, __dsub_rn, __fma_rn, __ddiv_rn, __dsqrt_rn) and
// the file is built with -fmad=false, so the rounding of every output is
// fixed by this source and not by the compiler's choice of contractions.
// The choices are those of the earlier design of this kernel (a warp per
// hypothesis, built with contraction on), read from its machine code: each
// dot product and sum of squares is an fma chain from +0.0 (v^T v, v^T R,
// Q v, the row norms, and every degree-3 coefficient of a product); a
// degree-2 coefficient is a*b, or fma(c, d, a*b) where the monomial has a
// second pair; the Householder update is R + ((-2 v_i) vr) / vn2, a
// product, a division and an add; the remaining sums are adds. So the
// outputs are that design's bit for bit, and do not depend on the batch.
//
// Bound on this card: bytes, 80 B in and 944 B out per hypothesis against
// ~7.8e3 operations (Householder ~2.3e3, the products ~4.8e3, norms and
// division ~0.6e3; chip_smoke.py P1_OPS); in practice the latency of the
// dependent float64 steps through shared memory. The earlier design ran
// them on one warp, with most lanes idle and a lane's nine divisions of a
// row in series; here a step's chain is one dot product, one division and
// an add. A block keeps its ~4.4 KB of float64 state in shared memory.
//
// Tables: the monomial order is that of geometry/five_point.py (_M1, _M2,
// _M3); `five_point_coeffs_tables` exports the multiplication tables
// T1 (4, 4, 10) and T2 (10, 4, 20) dense, so the wrapper can hold them to
// `_mul_tables()`.

#include <cuda_runtime.h>
#include <math.h>

#include "error_string.cuh"

#define THREADS 64       // threads per hypothesis (a block)
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

// The threads index the tables by their own monomial, so the kernel copies
// them from constant memory into shared memory first; the host copies (the
// same literals) feed `five_point_coeffs_tables`.
struct Tables {
    int t1a[20], t1b[20], t2a[60], t2b[60];
};
__constant__ Tables c_tab = {T1_A, T1_B, T2_A, T2_B};
static const int h_t1a[20] = T1_A;
static const int h_t1b[20] = T1_B;
static const int h_t2a[60] = T2_A;
static const int h_t2b[60] = T2_B;
#define TAB_T1A 0
#define TAB_T1B 20
#define TAB_T2A 40
#define TAB_T2B 100

struct BlockState {
    double R[2][9 * 5];  // A^T, reduced in place (two copies, by step)
    double Q[2][9 * 9];  // accumulated reflectors; null4 = Q[:, 5:9]
    double D2[13 * 10];  // minors 0-2, E E^T (3 i + j) 3-11, trace 12
    double C[10 * 20];   // raw constraint coefficients
    double rn[10];       // row norms
    int tab[sizeof(Tables) / sizeof(int)];   // Tables' arrays in order
};

// entry c (0: x, 1: y, 2: z, 3: 1) of E[i][j] = null4 row 3 i + j
__device__ __forceinline__ double ep(const BlockState& s, int i, int j,
                                     int c) {
    return s.Q[1][(3 * i + j) * 9 + 5 + c];
}

// degree-2 coefficient m of the product of E[i0][j0] and E[i1][j1]: the
// first pair's product, then fma with the second pair where m has one
__device__ __forceinline__ double mul11(const BlockState& s, int m, int i0,
                                        int j0, int i1, int j1) {
    const int* t = s.tab;
    double acc = __dmul_rn(ep(s, i0, j0, t[TAB_T1A + 2 * m]),
                           ep(s, i1, j1, t[TAB_T1B + 2 * m]));
    if (t[TAB_T1A + 2 * m + 1] >= 0)
        acc = __fma_rn(ep(s, i0, j0, t[TAB_T1A + 2 * m + 1]),
                       ep(s, i1, j1, t[TAB_T1B + 2 * m + 1]), acc);
    return acc;
}

// E E^T entry (i, j), monomial m: three products added in k order
__device__ __forceinline__ double eet(const BlockState& s, int m, int i,
                                      int j) {
    return __dadd_rn(__dadd_rn(mul11(s, m, i, 0, j, 0),
                               mul11(s, m, i, 1, j, 1)),
                     mul11(s, m, i, 2, j, 2));
}

// degree-3 coefficient m of the product of degree-2 poly d and E[i][j]:
// an fma chain from +0.0 over m's pairs
__device__ __forceinline__ double mul21(const BlockState& s, int m, int d,
                                        int i, int j) {
    double acc = 0.0;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
        const int a = s.tab[TAB_T2A + 3 * m + p];
        if (a >= 0)
            acc = __fma_rn(s.D2[d * 10 + a],
                           ep(s, i, j, s.tab[TAB_T2B + 3 * m + p]), acc);
    }
    return acc;
}

// entry i of the epipolar row of point (x1, y1) <-> (x2, y2)
__device__ __forceinline__ double row_entry(int i, double x1, double y1,
                                            double x2, double y2) {
    switch (i) {
        case 0: return __dmul_rn(x2, x1);
        case 1: return __dmul_rn(x2, y1);
        case 2: return x2;
        case 3: return __dmul_rn(y2, x1);
        case 4: return __dmul_rn(y2, y1);
        case 5: return y2;
        case 6: return x1;
        case 7: return y1;
        default: return 1.0;
    }
}

// Householder step k on R's rows k..8 and Q's columns k..8: read copy
// k % 2, write the other
template <int K>
__device__ __forceinline__ void householder(BlockState& s, int tid) {
    constexpr int LEN = 9 - K, NC = 5 - K, NR = LEN * NC, NQ = 9 * LEN;
    const double* R = s.R[K & 1];
    const double* Q = s.Q[K & 1];
    double* Rn = s.R[(K & 1) ^ 1];
    double* Qn = s.Q[(K & 1) ^ 1];
    double v[LEN];
    double nx = 0.0;
#pragma unroll
    for (int i = 0; i < LEN; ++i) {
        v[i] = R[(K + i) * 5 + K];
        nx = __fma_rn(v[i], v[i], nx);
    }
    nx = __dsqrt_rn(__dadd_rn(nx, EPS));
    v[0] = __dadd_rn(v[0], v[0] >= 0.0 ? nx : -nx);
    double vn2 = 0.0;
#pragma unroll
    for (int i = 0; i < LEN; ++i) vn2 = __fma_rn(v[i], v[i], vn2);
    vn2 = __dadd_rn(vn2, EPS);
    for (int e = tid; e < NR + NQ; e += THREADS) {
        if (e < NR) {
            // R[K + i][j]: its column's v^T R, then the update
            const int i = e / NC, j = K + e % NC;
            double vr = 0.0;
#pragma unroll
            for (int a = 0; a < LEN; ++a)
                vr = __fma_rn(v[a], R[(K + a) * 5 + j], vr);
            const double vi = i == 0 ? v[0] : R[(K + i) * 5 + K];
            const double u = __dmul_rn(__dmul_rn(-2.0, vi), vr);
            Rn[(K + i) * 5 + j] = __dadd_rn(R[(K + i) * 5 + j],
                                            __ddiv_rn(u, vn2));
        } else {
            // Q[r][K + i]: its row's Q v, then the update
            const int r = (e - NR) / LEN, i = (e - NR) % LEN;
            double qv = 0.0;
#pragma unroll
            for (int a = 0; a < LEN; ++a)
                qv = __fma_rn(Q[r * 9 + K + a], v[a], qv);
            const double vi = i == 0 ? v[0] : R[(K + i) * 5 + K];
            const double u = __dmul_rn(__dmul_rn(-2.0, qv), vi);
            Qn[r * 9 + K + i] = __dadd_rn(Q[r * 9 + K + i],
                                          __ddiv_rn(u, vn2));
        }
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
coeffs_kernel(const float* __restrict__ pts1, const float* __restrict__ pts2,
              float* __restrict__ null4, float* __restrict__ coeffs) {
    __shared__ BlockState s;
    const int tid = threadIdx.x;
    const long long h = blockIdx.x;

    // 1. R = A^T: R[i][j] = entry i of the epipolar row of point j; Q = I
    for (int e = tid; e < (int)(sizeof(Tables) / sizeof(int)); e += THREADS)
        s.tab[e] = reinterpret_cast<const int*>(&c_tab)[e];
    for (int e = tid; e < 45; e += THREADS) {
        const int i = e / 5, j = e % 5;
        const double x1 = pts1[h * 10 + 2 * j], y1 = pts1[h * 10 + 2 * j + 1];
        const double x2 = pts2[h * 10 + 2 * j], y2 = pts2[h * 10 + 2 * j + 1];
        s.R[0][e] = row_entry(i, x1, y1, x2, y2);
    }
    for (int e = tid; e < 81; e += THREADS)
        s.Q[0][e] = (e / 9 == e % 9) ? 1.0 : 0.0;
    __syncthreads();

    // 2. Householder steps k = 0..4; the last writes copy 1
    householder<0>(s, tid);
    householder<1>(s, tid);
    householder<2>(s, tid);
    householder<3>(s, tid);
    householder<4>(s, tid);
    for (int e = tid; e < 36; e += THREADS)
        null4[h * 36 + e] = __double2float_rn(s.Q[1][(e / 4) * 9 + 5 + e % 4]);

    // 3. degree-2 polynomials: coefficient m of polynomial p
    for (int e = tid; e < 130; e += THREADS) {
        const int p = e / 10, m = e % 10;
        double d;
        if (p < 3) {
            // minor(1, 2, c0, c1) for (c0, c1) = (1, 2), (0, 2), (0, 1)
            const int c0 = p == 0 ? 1 : 0, c1 = p == 2 ? 1 : 2;
            d = __dsub_rn(mul11(s, m, 1, c0, 2, c1), mul11(s, m, 1, c1, 2, c0));
        } else if (p < 12) {
            d = eet(s, m, (p - 3) / 3, (p - 3) % 3);
        } else {
            d = __dadd_rn(__dadd_rn(eet(s, m, 0, 0), eet(s, m, 1, 1)),
                          eet(s, m, 2, 2));
        }
        s.D2[e] = d;
    }
    __syncthreads();

    // 4. the 10 constraints: coefficient m of row r
    for (int e = tid; e < 200; e += THREADS) {
        const int r = e / 20, m = e % 20;
        double c;
        if (r == 0) {
            c = __dadd_rn(__dsub_rn(mul21(s, m, 0, 0, 0), mul21(s, m, 1, 0, 1)),
                          mul21(s, m, 2, 0, 2));
        } else {
            const int i = (r - 1) / 3, j = (r - 1) % 3;
            const double acc = __dadd_rn(
                __dadd_rn(mul21(s, m, 3 + 3 * i, 0, j),
                          mul21(s, m, 3 + 3 * i + 1, 1, j)),
                mul21(s, m, 3 + 3 * i + 2, 2, j));
            c = __dsub_rn(__dmul_rn(acc, 2.0), mul21(s, m, 12, i, j));
        }
        s.C[e] = c;
    }
    __syncthreads();

    // 5. row norms, then the normalized coefficients
    if (tid < 10) {
        double acc = 0.0;
#pragma unroll
        for (int m = 0; m < 20; ++m)
            acc = __fma_rn(s.C[tid * 20 + m], s.C[tid * 20 + m], acc);
        s.rn[tid] = __dsqrt_rn(__dadd_rn(acc, EPS));
    }
    __syncthreads();
    for (int e = tid; e < 200; e += THREADS)
        coeffs[h * 200 + e] = __double2float_rn(__ddiv_rn(s.C[e],
                                                          s.rn[e / 20]));
}

// pts1, pts2 (M, 5, 2) float32 -> null4 (M, 9, 4), coeffs (M, 10, 20)
extern "C" int five_point_coeffs_launch(const float* pts1, const float* pts2,
                                        float* null4, float* coeffs, int M,
                                        void* stream) {
    if (M <= 0) return 0;
    coeffs_kernel<<<M, THREADS, 0, (cudaStream_t)stream>>>(pts1, pts2, null4,
                                                           coeffs);
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
