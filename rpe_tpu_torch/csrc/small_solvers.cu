// P5-P8: RANSAC's small per-problem solvers and the threefry hash, one
// launch each where the plain PyTorch versions make hundreds.
//
//   P5 `smallest_eigvec_kernel<N>`  geometry/eig.py `smallest_eigvec_sym`
//       (N = 9: the 8-point and DLT normal matrices; N = 10: K4's plain
//       version): unrolled Cholesky, then `iters` rounds of inverse
//       iteration, ~890 eager launches a call at N = 9;
//   P6 `eigh3x3_kernel`             geometry/eig.py `eigh3x3_desc`: Cardano
//       eigenvalues, cross-product eigenvectors, ~210 launches;
//   P7 `essential_frame_kernel`     geometry/epipolar.py `frame_rotations`:
//       `essential_frame`'s own operations after its second P2 product
//       (the divisions by s + eps, the norms, Gram-Schmidt, the cross
//       product, the sign flips by the determinants), ~80 launches;
//   P8 `threefry_kernel`            rng.py `threefry2x32`: 20 rounds of
//       uint32 add, rotate and xor, ~176 launches.
//
// No TPU kernel of their own: on the TPU the reference's chains are XLA's,
// which fuses them. On this card the plain versions are eager PyTorch, one
// launch for every elementwise operation of every problem batch, so the
// stage they sit in waits on the host issuing them. Here one thread takes
// one independent problem (a matrix, or one output element of the hash)
// and does the plain version's float32 operations in the plain version's
// order; nothing is shared between threads, there is no reduction across
// threads and no atomic.
//
// Every output bit is that of the plain version run eagerly on the card
// (tests/test_torch_gpu.py, chip_smoke.py), not only that of its Python
// expression, so the source repeats what ATen's CUDA kernels do:
//   - one rounding per eager operation: the file is built with
//     -fmad=false, so no product is contracted into an add;
//   - a true division by a Python number is a product with the float
//     reciprocal (`p2 / 6.0` is p2 * (1.0f / 6.0f)), `1.0 / p` is
//     reciprocal(p) * 1.0 (an IEEE division), a Python constant is the
//     float of its double (`(float)1e-20`);
//   - sums over a last dimension follow ATen's reduction order: of 3
//     contiguous elements two lanes, lane 0 holding elements 0 and 2,
//     lane 1 element 1, added by one shuffle; of the N diagonal elements
//     of an N x N matrix (N = 9, 10; strided, so not vectorized) eight
//     lanes, lane j holding elements j and j + 8, then shuffles down by 4,
//     2 and 1; every accumulator starts from +0.0 (so -0.0 enters as
//     +0.0). `linalg.vector_norm` of 3 accumulates fma(x, x, acc) from
//     +0.0, one element an accumulator, so a rounded square each, in the
//     same order, then sqrtf;
//   - Python's `sum(x_i * x_i for ...)` starts from the integer 0;
//   - clamp, clamp_min and sign as ATen: NaN passes clamp unchanged, and
//     sign(x) = (0 < x) - (x < 0), so sign(NaN) = 0;
//   - sqrtf, acosf and cosf from libdevice, without fast math.
//
// Bound on this card: launch latency. A problem reads at most 400 bytes
// (a 10 x 10 matrix) and does at most ~2.5e3 operations (P5 at N = 10 and
// 4 rounds); the cell's largest launch, P6 over 32 x 2560 matrices, reads
// ~1 MB and writes ~1.6 MB. So one launch replaces each chain, and a block
// of 128 threads takes 128 problems.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_DIMS = 6;         // threefry: broadcast dimensions

// the plain versions' Python constants, as ATen casts them to float32
constexpr float EIG_EPS = static_cast<float>(1e-20);    // eig.py _EPS
constexpr float EPI_EPS = static_cast<float>(1e-12);    // epipolar.py _EPS
constexpr float INV3 = 1.0f / static_cast<float>(3.0);
constexpr float INV6 = 1.0f / static_cast<float>(6.0);
constexpr float TWO_PI_3 =
    static_cast<float>(2.0 * 3.141592653589793 / 3.0);   // 2 pi / 3
constexpr float REF_GATE = static_cast<float>(0.9);
constexpr float DEGENERATE = static_cast<float>(1e-6);
constexpr float JITTER_SCALE = static_cast<float>(1e-7);
constexpr float JITTER_FLOOR = static_cast<float>(1e-12);

__device__ __forceinline__ float clamp_min(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float sign(float v) {
    return static_cast<float>(static_cast<int>(0.0f < v)
                              - static_cast<int>(v < 0.0f));
}

// ATen's sum over a contiguous last dimension of 3
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
    return ((0.0f + x0) + (0.0f + x2)) + (0.0f + x1);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
    return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// linalg.vector_norm over a contiguous last dimension of 3
__device__ __forceinline__ float norm3(const float x[3]) {
    return sqrtf((__fmaf_rn(x[0], x[0], 0.0f) + __fmaf_rn(x[2], x[2], 0.0f))
                 + __fmaf_rn(x[1], x[1], 0.0f));
}

// ATen's sum of an N x N matrix's diagonal (N = 9, 10)
template <int N>
__device__ __forceinline__ float diag_sum(const float* a) {
    static_assert(N > 8 && N <= 16, "eight lanes of at most two elements");
    float lane[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        lane[j] = 0.0f + a[j * (N + 1)];
        if (j + 8 < N) lane[j] = lane[j] + (0.0f + a[(j + 8) * (N + 1)]);
    }
    return ((lane[0] + lane[4]) + (lane[2] + lane[6]))
           + ((lane[1] + lane[5]) + (lane[3] + lane[7]));
}

// eig.py `_cross`
__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float c[3]) {
    c[0] = a[1] * b[2] - a[2] * b[1];
    c[1] = a[2] * b[0] - a[0] * b[2];
    c[2] = a[0] * b[1] - a[1] * b[0];
}

// epipolar.py `_det3` of M[i][j] = col[j][i]
__device__ __forceinline__ float det3_cols(const float c0[3],
                                           const float c1[3],
                                           const float c2[3]) {
    return (c0[0] * (c1[1] * c2[2] - c2[1] * c1[2])
            - c1[0] * (c0[1] * c2[2] - c2[1] * c0[2]))
           + c2[0] * (c0[1] * c1[2] - c1[1] * c0[2]);
}

// eigh3x3_desc's `eigvec`: the unit cross product of two rows of A - lam I
// with the largest squared norm (the later pair wins ties)
__device__ __forceinline__ void eigvec(float a00, float a01, float a02,
                                       float a11, float a12, float a22,
                                       float lam, float v[3]) {
    const float r0[3] = {a00 - lam, a01, a02};
    const float r1[3] = {a01, a11 - lam, a12};
    const float r2[3] = {a02, a12, a22 - lam};
    float c01[3], c02[3], c12[3];
    cross3(r0, r1, c01);
    cross3(r0, r2, c02);
    cross3(r1, r2, c12);
    const float n01 = dot3(c01, c01);
    const float n02 = dot3(c02, c02);
    const float n12 = dot3(c12, c12);
    const bool best12 = (n12 >= n01) && (n12 >= n02);
    const bool best02 = (n02 >= n01) && !best12;
    float s[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
        s[i] = best12 ? c12[i] : (best02 ? c02[i] : c01[i]);
    const float n = sqrtf(clamp_min(dot3(s, s), EIG_EPS));
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] = s[i] / n;
}

__global__ void __launch_bounds__(THREADS)
eigh3x3_kernel(const float* __restrict__ A, float* __restrict__ w,
               float* __restrict__ V, long long problems) {
    const long long b = blockIdx.x * (long long)THREADS + threadIdx.x;
    if (b >= problems) return;
    const float* a = A + b * 9;
    const float a00 = a[0], a01 = a[1], a02 = a[2];
    const float a11 = a[4], a12 = a[5], a22 = a[8];

    const float q = ((a00 + a11) + a22) * INV3;
    const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
    const float p2 = ((b00 * b00 + b11 * b11) + b22 * b22)
                     + 2.0f * ((a01 * a01 + a02 * a02) + a12 * a12);
    const float p = sqrtf(clamp_min(p2 * INV6, EIG_EPS));
    const float ip = (1.0f / p) * 1.0f;
    const float c00 = b00 * ip, c11 = b11 * ip, c22 = b22 * ip;
    const float c01 = a01 * ip, c02 = a02 * ip, c12 = a12 * ip;
    float r = 0.5f * ((c00 * (c11 * c22 - c12 * c12)
                       - c01 * (c01 * c22 - c12 * c02))
                      + c02 * (c01 * c12 - c11 * c02));
    r = clamp(r, -1.0f, 1.0f);
    const float phi = acosf(r) * INV3;
    const float w0 = q + 2.0f * p * cosf(phi);                  // largest
    const float w2 = q + 2.0f * p * cosf(phi + TWO_PI_3);       // smallest
    const float w1 = (3.0f * q - w0) - w2;

    float v2[3], v0[3], v1[3];
    eigvec(a00, a01, a02, a11, a12, a22, w2, v2);
    eigvec(a00, a01, a02, a11, a12, a22, w0, v0);
    const float d = dot3(v2, v0);
#pragma unroll
    for (int i = 0; i < 3; ++i) v0[i] = v0[i] - d * v2[i];
    const float n0 = sqrtf(clamp_min(dot3(v0, v0), EIG_EPS));
    const float e0[3] = {1.0f, 0.0f, 0.0f};
    const float e1[3] = {0.0f, 1.0f, 0.0f};
    const bool use_alt = fabsf(dot3(v2, e0)) > REF_GATE;
    float ref[3], fb[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) ref[i] = use_alt ? e1[i] : e0[i];
    const float fd = dot3(v2, ref);
#pragma unroll
    for (int i = 0; i < 3; ++i) fb[i] = ref[i] - fd * v2[i];
    const float fn = sqrtf(clamp_min(dot3(fb, fb), EIG_EPS));
    const bool degenerate = n0 < DEGENERATE;
#pragma unroll
    for (int i = 0; i < 3; ++i)
        v0[i] = degenerate ? fb[i] / fn : v0[i] / n0;
    cross3(v2, v0, v1);

    float* wb = w + b * 3;
    wb[0] = w0;
    wb[1] = w1;
    wb[2] = w2;
    float* Vb = V + b * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        Vb[3 * i + 0] = v0[i];
        Vb[3 * i + 1] = v1[i];
        Vb[3 * i + 2] = v2[i];
    }
}

template <int N>
__global__ void __launch_bounds__(THREADS)
smallest_eigvec_kernel(const float* __restrict__ A, float* __restrict__ out,
                       long long problems, int iters) {
    const long long b = blockIdx.x * (long long)THREADS + threadIdx.x;
    if (b >= problems) return;
    const float* a = A + b * N * N;
    const float jitter = JITTER_SCALE * diag_sum<N>(a) + JITTER_FLOOR;

    // L, lower triangle by rows: L[i][j] at i (i + 1) / 2 + j
    float L[N * (N + 1) / 2];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float s = i == j ? a[i * N + j] + jitter : a[i * N + j];
#pragma unroll
            for (int k = 0; k < j; ++k)
                s = s - L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
            L[i * (i + 1) / 2 + j] = i == j
                ? sqrtf(clamp_min(s, EIG_EPS))
                : s / L[j * (j + 1) / 2 + j];
        }
    }

    float x[N], y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = static_cast<float>(1.0 + 0.01 * i);
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            float s = x[i];
#pragma unroll
            for (int k = 0; k < i; ++k)
                s = s - L[i * (i + 1) / 2 + k] * y[k];
            y[i] = s / L[i * (i + 1) / 2 + i];
        }
#pragma unroll
        for (int i = N - 1; i >= 0; --i) {
            float s = y[i];
#pragma unroll
            for (int k = i + 1; k < N; ++k)
                s = s - L[k * (k + 1) / 2 + i] * x[k];
            x[i] = s / L[i * (i + 1) / 2 + i];
        }
        float ss = x[0] * x[0] + 0.0f;
#pragma unroll
        for (int i = 1; i < N; ++i) ss = ss + x[i] * x[i];
        const float nrm = sqrtf(ss + EIG_EPS);
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] = x[i] / nrm;
    }
    float* o = out + b * N;
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = x[i];
}

__global__ void __launch_bounds__(THREADS)
essential_frame_kernel(const float* __restrict__ w,
                       const float* __restrict__ V,
                       const float* __restrict__ Ev0,
                       const float* __restrict__ Ev1,
                       float* __restrict__ U, float* __restrict__ Vf,
                       long long problems) {
    const long long b = blockIdx.x * (long long)THREADS + threadIdx.x;
    if (b >= problems) return;
    const float s0 = sqrtf(clamp_min(w[b * 3 + 0], 0.0f)) + EPI_EPS;
    const float s1 = sqrtf(clamp_min(w[b * 3 + 1], 0.0f)) + EPI_EPS;
    float u0[3], u1[3], u2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        u0[i] = Ev0[b * 3 + i] / s0;
        u1[i] = Ev1[b * 3 + i] / s1;
    }
    const float n0 = norm3(u0) + EPI_EPS;
#pragma unroll
    for (int i = 0; i < 3; ++i) u0[i] = u0[i] / n0;
    const float d = dot3(u0, u1);
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] = u1[i] - d * u0[i];
    const float n1 = norm3(u1) + EPI_EPS;
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] = u1[i] / n1;
    cross3(u0, u1, u2);
    const float su = sign(det3_cols(u0, u1, u2));

    const float* Vb = V + b * 9;
    float v0[3], v1[3], v2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        v0[i] = Vb[3 * i + 0];
        v1[i] = Vb[3 * i + 1];
        v2[i] = Vb[3 * i + 2];
    }
    const float sv = sign(det3_cols(v0, v1, v2));

    float* Ub = U + b * 9;
    float* Vo = Vf + b * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        Ub[3 * i + 0] = u0[i];
        Ub[3 * i + 1] = u1[i];
        Ub[3 * i + 2] = u2[i] * su;
        Vo[3 * i + 0] = v0[i];
        Vo[3 * i + 1] = v1[i];
        Vo[3 * i + 2] = v2[i] * sv;
    }
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
    return (x << d) | (x >> (32 - d));
}

}  // namespace

// The broadcast of threefry's four operands: the output's sizes
// (outermost first) and each operand's strides in elements, 0 where it
// broadcasts (rng.py `_broadcast_args`).
struct Broadcast {
    long long size[MAX_DIMS];
    long long stride[4][MAX_DIMS];
    long long total;
    int ndim;
};

namespace {

__global__ void __launch_bounds__(THREADS)
threefry_kernel(const long long* __restrict__ k1,
                const long long* __restrict__ k2,
                const long long* __restrict__ x1,
                const long long* __restrict__ x2,
                long long* __restrict__ o1, long long* __restrict__ o2,
                const Broadcast g) {
    const long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
    if (e >= g.total) return;
    long long off[4] = {0, 0, 0, 0};
    long long rest = e;
    for (int d = g.ndim - 1; d >= 0; --d) {
        const long long c = rest % g.size[d];
        rest /= g.size[d];
#pragma unroll
        for (int t = 0; t < 4; ++t) off[t] += c * g.stride[t][d];
    }
    // the plain version's int64 sums are masked to 32 bits before every
    // rotation and at the end, so only the operands' low words matter
    const uint32_t ks[3] = {
        static_cast<uint32_t>(k1[off[0]]), static_cast<uint32_t>(k2[off[1]]),
        static_cast<uint32_t>(k1[off[0]]) ^ static_cast<uint32_t>(k2[off[1]])
            ^ 0x1BD11BDAu};
    uint32_t a = static_cast<uint32_t>(x1[off[2]]) + ks[0];
    uint32_t c = static_cast<uint32_t>(x2[off[3]]) + ks[1];
    constexpr int ROT[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            a = a + c;
            c = rotl(c, ROT[i % 2][r]) ^ a;
        }
        a = a + ks[(i + 1) % 3];
        c = c + ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
    o1[e] = static_cast<long long>(a);
    o2[e] = static_cast<long long>(c);
}

inline unsigned grid(long long n) {
    return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

int small_solvers_broadcast_size() { return sizeof(Broadcast); }
int small_solvers_max_dims() { return MAX_DIMS; }

int smallest_eigvec_launch(const float* A, float* out, long long problems,
                           int n, int iters, cudaStream_t stream) {
    if (n == 9) {
        smallest_eigvec_kernel<9><<<grid(problems), THREADS, 0, stream>>>(
            A, out, problems, iters);
    } else if (n == 10) {
        smallest_eigvec_kernel<10><<<grid(problems), THREADS, 0, stream>>>(
            A, out, problems, iters);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

int eigh3x3_launch(const float* A, float* w, float* V, long long problems,
                   cudaStream_t stream) {
    eigh3x3_kernel<<<grid(problems), THREADS, 0, stream>>>(A, w, V, problems);
    return static_cast<int>(cudaGetLastError());
}

int essential_frame_launch(const float* w, const float* V, const float* Ev0,
                           const float* Ev1, float* U, float* Vf,
                           long long problems, cudaStream_t stream) {
    essential_frame_kernel<<<grid(problems), THREADS, 0, stream>>>(
        w, V, Ev0, Ev1, U, Vf, problems);
    return static_cast<int>(cudaGetLastError());
}

int threefry_launch(const long long* k1, const long long* k2,
                    const long long* x1, const long long* x2, long long* o1,
                    long long* o2, const Broadcast* g, cudaStream_t stream) {
    threefry_kernel<<<grid(g->total), THREADS, 0, stream>>>(
        k1, k2, x1, x2, o1, o2, *g);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
