// K4: 5-point hidden-variable roots -- bracket, bisect, extract, polish.
//
// Replaces rpe_tpu/ops/five_point_pallas.py `solve_roots_polished`
// (`_roots_kernel` + `_polish_kernel`), which held each of the 100 matrix
// entries as its own (8, 128) register tile with the hypothesis batch in
// sublanes and lanes. On this card:
//   roots_kernel: one warp per hypothesis. Its 10 x 20 row-normalized
//     coefficients (800 B) sit in shared memory, read by all lanes at once.
//     The 32 lanes evaluate the sign of det M(z) at the 97 grid points (3
//     each, lane 0 a fourth): M(z) by Horner into registers, the sign as
//     the product of the pivot signs of an unrolled, unpivoted LU (no
//     overflow at |z| ~ 1e3, where det M itself leaves float range). A
//     ballot of the sign changes gives the first 10 brackets in
//     grid order. The brackets are then bisected together: each round
//     gives every bracket a group of 2^L - 1 lanes (L = 5, 4, 3 or 2 levels
//     for 1, 2, 3-4 or 5-10 brackets) that evaluate the nodes of an L-level
//     bisection tree -- each node's midpoint computed by the same sequence
//     of 0.5f * (a + b) the sequential bisection would take to reach it --
//     and the group walks the tree with the nodes' signs. The 10 levels
//     take 2-5 rounds instead of 10 and end on the sequential endpoints.
//   polish_kernel: one thread per (hypothesis, root). It picks the affine
//     chart or the projective chart w = 1/z by |z|, takes the null vector
//     of M from back-substitution on its unpivoted LU (v9 = 1), clips x, y
//     to +-1e6, and runs 4 Gauss-Newton steps on the 10 cubic constraints.
//     A polish that carries the root past the scanned grid -- |z| above
//     ZKEEP, 1.2 times the grid's last |tan|, the bound of the reference's
//     kernel contract (tests/test_pallas_kernels.py:178-184) -- has left
//     its bracket without converging (two close roots or a pole; the
//     residual fails the cubic system), and the root keeps its unpolished
//     values (its bracket's midpoint and null vector), still marked as a
//     root and flagged in `undone`. The plain version and the reference's
//     kernel keep the polished values.
//     It is ~3% of K4's device time (PERF.md), so it keeps this form.
// Both kernels come from one launcher: one launch of K4 per call.
// K5, rpe_tpu/ops/five_point_pallas.py `find_root_brackets` (its
// `_roots_kernel` alone), is roots_kernel from a launcher of its own.
//
// Bound on this card: operations. ~1.4e5 float operations per hypothesis
// (97 + 100 determinant evaluations of ~835 operations; the tree
// evaluates some nodes off the final path, spending idle lanes to cut the
// serial depth from 197 to 6-9 evaluations) and ~2e4 per root for the
// polish, against 800 B of input per hypothesis. The 10 x 10 matrix stays
// in registers (fully unrolled loops with constant indices).
//
// Tables: the monomial order, hidden-variable groups and chart flip are
// those of geometry/five_point.py; `five_point_tables` exports them so the
// wrapper can hold them to the Python tables.

#include <cuda_runtime.h>
#include <math.h>

#include "error_string.cuh"

#define NR 10            // MAX_ROOTS
#define GRIDN 97
#define BISECT 10
#define WARPS 4          // hypotheses (warps) per block of roots_kernel
#define EPS 1e-20f
#define ZKEEP 1.2e3f     // 1.2 x tan(pi/2 - 1e-3), the grid's last |tan|

// Static tables as constexpr functions, so fully unrolled loops fold them.
// group_mono(g, c): monomial index of xy-group g times z^c (-1 if none).
__host__ __device__ constexpr int group_mono(int g, int c) {
    const int t[40] = {0, -1, -1, -1, 1, -1, -1, -1, 3, -1, -1, -1,
                       6, -1, -1, -1, 10, 2, -1, -1, 11, 4, -1, -1,
                       13, 7, -1, -1, 16, 12, 5, -1, 17, 14, 8, -1,
                       19, 18, 15, 9};
    return t[g * 4 + c];
}
// z-degree bound of group g's entries (3 - its xy degree)
__host__ __device__ constexpr int max_z(int g) {
    return g < 4 ? 0 : (g < 7 ? 1 : (g < 9 ? 2 : 3));
}
// projective-chart flip: monomial (a, b, c) -> (a, b, 3 - a - b - c)
__host__ __device__ constexpr int flip_mono(int m) {
    const int t[20] = {0, 1, 10, 3, 11, 16, 6, 13, 17, 19,
                       2, 4, 12, 7, 14, 18, 5, 8, 15, 9};
    return t[m];
}
// exponent k (0: x, 1: y, 2: z) of monomial m
__host__ __device__ constexpr int mono_exp(int m, int k) {
    const int t[60] = {3, 0, 0, 2, 1, 0, 2, 0, 1, 1, 2, 0, 1, 1, 1, 1, 0, 2,
                       0, 3, 0, 0, 2, 1, 0, 1, 2, 0, 0, 3, 2, 0, 0, 1, 1, 0,
                       1, 0, 1, 0, 2, 0, 0, 1, 1, 0, 0, 2, 1, 0, 0, 0, 1, 0,
                       0, 0, 1, 0, 0, 0};
    return t[m * 3 + k];
}

__device__ __forceinline__ float sgnf(float v) {
    return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// sign of det M(z), coefficients c[e * 20 + m]
__device__ __forceinline__ float det_sign(const float* c, float z) {
    float M[10][10];
#pragma unroll
    for (int e = 0; e < 10; ++e)
#pragma unroll
        for (int g = 0; g < 10; ++g) {
            float v = c[e * 20 + group_mono(g, max_z(g))];
#pragma unroll
            for (int k = max_z(g) - 1; k >= 0; --k)
                v = v * z + c[e * 20 + group_mono(g, k)];
            M[e][g] = v;
        }
    float sign = 1.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        float piv = M[k][k];
        sign *= sgnf(piv);
        float safe = fabsf(piv) > EPS ? piv : 1.f;
#pragma unroll
        for (int i = k + 1; i < 10; ++i) {
            float f = M[i][k] / safe;
#pragma unroll
            for (int j = k + 1; j < 10; ++j) M[i][j] = M[i][j] - f * M[k][j];
        }
    }
    return sign * sgnf(M[9][9]);
}

// Position of the n-th set bit (1-based) of the 96-bit mask
// m0 | m1 << 32 | m2 << 64; n <= its popcount.
__device__ __forceinline__ int nth_change(unsigned m0, unsigned m1, unsigned m2,
                                          int n) {
    int base = 0;
    unsigned m = m0;
    if (n > __popc(m0)) {
        n -= __popc(m0);
        base = 32;
        m = m1;
        if (n > __popc(m1)) {
            n -= __popc(m1);
            base = 64;
            m = m2;
        }
    }
    for (int k = 1; k < n; ++k) m &= m - 1;   // clear the n - 1 lowest
    return base + __ffs(m) - 1;
}

__global__ void __launch_bounds__(WARPS * 32, 4)
roots_kernel(const float* __restrict__ coeffs, const float* __restrict__ tgrid,
             float* __restrict__ brackets, int B) {
    __shared__ float s_c[WARPS][200];
    __shared__ float s_br[WARPS][3][NR];   // t_lo, t_hi, sign at t_lo
    const unsigned full = 0xffffffffu;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int h = blockIdx.x * WARPS + w;
    if (h >= B) return;                    // whole warps only
    for (int i = lane; i < 200; i += 32) s_c[w][i] = coeffs[(size_t)h * 200 + i];
    __syncwarp();
    const float* c = s_c[w];

    // grid: lane l takes points l, 32 + l, 64 + l; lane 0 also point 96
    float sg[3], s96 = 0.f;
#pragma unroll 1
    for (int r = 0; r < 4; ++r) {
        const int p = 32 * r + lane;
        const float sv = p < GRIDN ? det_sign(c, tanf(__ldg(tgrid + p))) : 0.f;
        if (r == 0) sg[0] = sv;
        else if (r == 1) sg[1] = sv;
        else if (r == 2) sg[2] = sv;
        else s96 = sv;
    }
    // interval g = 32 r + lane changes sign between points g and g + 1
    const float first1 = __shfl_sync(full, sg[1], 0);
    const float first2 = __shfl_sync(full, sg[2], 0);
    const float last = __shfl_sync(full, s96, 0);
    float nxt[3];
    nxt[0] = __shfl_down_sync(full, sg[0], 1);
    nxt[1] = __shfl_down_sync(full, sg[1], 1);
    nxt[2] = __shfl_down_sync(full, sg[2], 1);
    if (lane == 31) {
        nxt[0] = first1;
        nxt[1] = first2;
        nxt[2] = last;
    }
    const unsigned m0 = __ballot_sync(full, sg[0] * nxt[0] < 0.f);
    const unsigned m1 = __ballot_sync(full, sg[1] * nxt[1] < 0.f);
    const unsigned m2 = __ballot_sync(full, sg[2] * nxt[2] < 0.f);
    const int cnt = min(__popc(m0) + __popc(m1) + __popc(m2), NR);

    // lane b < cnt sets up bracket b: its grid interval and the sign at t_lo
    {
        const int g = lane < cnt ? nth_change(m0, m1, m2, lane + 1) : 0;
        const float s0 = __shfl_sync(full, sg[0], g & 31);
        const float s1 = __shfl_sync(full, sg[1], g & 31);
        const float s2 = __shfl_sync(full, sg[2], g & 31);
        if (lane < cnt) {
            s_br[w][0][lane] = __ldg(tgrid + g);
            s_br[w][1][lane] = __ldg(tgrid + g + 1);
            s_br[w][2][lane] = g < 32 ? s0 : (g < 64 ? s1 : s2);
        }
    }
    __syncwarp();

    // bisection, L levels per round (warp-uniform control flow)
#pragma unroll 1
    for (int done = 0; cnt > 0 && done < BISECT;) {
        int L = cnt == 1 ? 5 : (cnt == 2 ? 4 : (cnt <= 4 ? 3 : 2));
        L = min(L, BISECT - done);
        const int G = (1 << L) - 1;            // lanes (tree nodes) per bracket
        const int b = lane / G, node = lane % G + 1;   // heap index 1..G
        const bool act = b < cnt;
        float a = 0.f, bb = 0.f, sa = 0.f;
        if (act) {
            a = s_br[w][0][b];
            bb = s_br[w][1][b];
            sa = s_br[w][2][b];
        }
        // this lane's node: descend from the root along node's bits
        float na = a, nb = bb;
        const int depth = 31 - __clz(node);
#pragma unroll 1
        for (int lv = depth - 1; lv >= 0; --lv) {
            const float mid = 0.5f * (na + nb);
            if ((node >> lv) & 1) na = mid; else nb = mid;
        }
        float sm = 0.f;
        if (act) sm = det_sign(c, tanf(0.5f * (na + nb)));
        // walk the tree as the sequential bisection would
        int at = 1;
#pragma unroll 1
        for (int lv = 0; lv < L; ++lv) {
            const float mid = 0.5f * (a + bb);
            const float s = __shfl_sync(full, sm, min(b * G + at - 1, 31));
            if (s * sa >= 0.f) {
                a = mid;
                sa = s;
                at = 2 * at + 1;
            } else {
                bb = mid;
                at = 2 * at;
            }
        }
        __syncwarp();
        if (act && node == 1) {
            s_br[w][0][b] = a;
            s_br[w][1][b] = bb;
            s_br[w][2][b] = sa;
        }
        __syncwarp();
        done += L;
    }
    if (lane < NR) {
        float* out = brackets + (size_t)h * 3 * NR;
        const bool has = lane < cnt;
        out[lane] = has ? s_br[w][0][lane] : 0.f;
        out[NR + lane] = has ? s_br[w][1][lane] : 0.f;
        out[2 * NR + lane] = has ? 1.f : 0.f;
    }
}

__global__ void polish_kernel(const float* __restrict__ coeffs,
                              const float* __restrict__ brackets,
                              float* __restrict__ xo, float* __restrict__ yo,
                              float* __restrict__ rvo, bool* __restrict__ flo,
                              bool* __restrict__ hro, bool* __restrict__ undo,
                              int B) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= B * NR) return;
    const int h = idx / NR, r = idx % NR;
    const float* br = brackets + (size_t)h * 3 * NR;
    const float tlo = br[r], thi = br[NR + r];
    const bool ok = br[2 * NR + r] > 0.5f;
    const float z = tanf(0.5f * (tlo + thi));
    const bool flip = fabsf(z) > 1.f;
    flo[idx] = flip;
    hro[idx] = ok;
    undo[idx] = false;
    if (!ok) {
        xo[idx] = 0.f;
        yo[idx] = 0.f;
        rvo[idx] = 0.f;
        return;
    }
    const float* c = coeffs + (size_t)h * 200;
    const float safe = fabsf(z) > 1e-20f ? z : 1.f;
    float rv = flip ? 1.f / safe : z;

    float M[10][10];
#pragma unroll
    for (int e = 0; e < 10; ++e)
#pragma unroll
        for (int g = 0; g < 10; ++g) {
            const int km = max_z(g);
            float v = flip ? __ldg(c + e * 20 + group_mono(g, 0))
                           : __ldg(c + e * 20 + group_mono(g, km));
#pragma unroll
            for (int k = km - 1; k >= 0; --k)
                v = v * rv + (flip ? __ldg(c + e * 20 + group_mono(g, km - k))
                                   : __ldg(c + e * 20 + group_mono(g, k)));
            M[e][g] = v;
        }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        float piv = M[k][k];
        float inv = 1.f / (fabsf(piv) > EPS ? piv : 1.f);
#pragma unroll
        for (int i = k + 1; i < 10; ++i) {
            float f = M[i][k] * inv;
#pragma unroll
            for (int j = k + 1; j < 10; ++j) M[i][j] = M[i][j] - f * M[k][j];
        }
    }
    float v[10];
    v[9] = 1.f;
#pragma unroll
    for (int i = 8; i >= 0; --i) {
        float s = M[i][9];
#pragma unroll
        for (int j = i + 1; j < 9; ++j) s = s + M[i][j] * v[j];
        float d = M[i][i];
        d = fabsf(d) > 1e-12f ? d : (d >= 0.f ? 1e-12f : -1e-12f);
        v[i] = -s / d;
    }
    float x = fminf(fmaxf(v[7], -1e6f), 1e6f);
    float y = fminf(fmaxf(v[8], -1e6f), 1e6f);
    const float x0 = x, y0 = y, rv0 = rv;

    for (int it = 0; it < 4; ++it) {
        float xp[4] = {1.f, x, x * x, x * x * x};
        float yp[4] = {1.f, y, y * y, y * y * y};
        float rp[4] = {1.f, rv, rv * rv, rv * rv * rv};
        float JtJ[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        float Jtr[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 10; ++e) {
            float re = 0.f, jx = 0.f, jy = 0.f, jr = 0.f;
#pragma unroll
            for (int mm = 0; mm < 20; ++mm) {
                const int a = mono_exp(mm, 0), b = mono_exp(mm, 1), cc = mono_exp(mm, 2);
                float ce = __ldg(c + e * 20 + (flip ? flip_mono(mm) : mm));
                re = re + ce * (xp[a] * yp[b] * rp[cc]);
                if (a > 0) jx = jx + ce * ((float)a * xp[a - 1] * yp[b] * rp[cc]);
                if (b > 0) jy = jy + ce * ((float)b * xp[a] * yp[b - 1] * rp[cc]);
                if (cc > 0) jr = jr + ce * ((float)cc * xp[a] * yp[b] * rp[cc - 1]);
            }
            float J[3] = {jx, jy, jr};
#pragma unroll
            for (int p = 0; p < 3; ++p) {
                Jtr[p] = Jtr[p] + J[p] * re;
#pragma unroll
                for (int q = p; q < 3; ++q) JtJ[p][q] = JtJ[p][q] + J[p] * J[q];
            }
        }
        float a = JtJ[0][0] + 1e-12f, b_ = JtJ[0][1], cq = JtJ[0][2];
        float e_ = JtJ[1][1] + 1e-12f, f = JtJ[1][2];
        float i_ = JtJ[2][2] + 1e-12f;
        float det = a * (e_ * i_ - f * f) - b_ * (b_ * i_ - f * cq)
                    + cq * (b_ * f - e_ * cq);
        det = fabsf(det) > EPS ? det : 1.f;
        float gx = Jtr[0], gy = Jtr[1], gz = Jtr[2];
        float dx = -((e_ * i_ - f * f) * gx + (cq * f - b_ * i_) * gy
                     + (b_ * f - cq * e_) * gz) / det;
        float dy = -((cq * f - b_ * i_) * gx + (a * i_ - cq * cq) * gy
                     + (cq * b_ - a * f) * gz) / det;
        float dz = -((b_ * f - cq * e_) * gx + (cq * b_ - a * f) * gy
                     + (a * e_ - b_ * b_) * gz) / det;
        x = x + dx;
        y = y + dy;
        rv = rv + dz;
    }
    const float zabs = flip ? 1.f / fabsf(rv) : fabsf(rv);
    if (zabs >= ZKEEP) {
        x = x0;
        y = y0;
        rv = rv0;
        undo[idx] = true;
    }
    xo[idx] = x;
    yo[idx] = y;
    rvo[idx] = rv;
}

extern "C" int five_point_roots_launch(const float* coeffs, const float* tgrid,
                                       float* brackets, float* x, float* y,
                                       float* rv, bool* flip, bool* has,
                                       bool* undone, int B, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (B <= 0) return 0;
    roots_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(coeffs, tgrid,
                                                                brackets, B);
    int n = B * NR;
    polish_kernel<<<(n + 127) / 128, 128, 0, s>>>(coeffs, brackets, x, y, rv,
                                                  flip, has, undone, B);
    return (int)cudaGetLastError();
}

// K5: roots_kernel alone (brackets (B, 3, NR): t_lo, t_hi, has as 0/1)
extern "C" int five_point_brackets_launch(const float* coeffs, const float* tgrid,
                                          float* brackets, int B, void* stream) {
    if (B <= 0) return 0;
    roots_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
        coeffs, tgrid, brackets, B);
    return (int)cudaGetLastError();
}

extern "C" void five_point_tables(int* out) {
    for (int g = 0; g < 10; ++g)
        for (int c = 0; c < 4; ++c) out[g * 4 + c] = group_mono(g, c);
    for (int m = 0; m < 20; ++m) out[40 + m] = flip_mono(m);
    for (int m = 0; m < 20; ++m)
        for (int k = 0; k < 3; ++k) out[60 + m * 3 + k] = mono_exp(m, k);
}
