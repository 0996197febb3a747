// K1: fused FAST-9 score + 3x3 nonmax + Harris rank map + 7x7 Gaussian blur.
//
// Replaces rpe_tpu/ops/fast_pallas.py `fast_harris_rank_map`
// (`_fast_harris_kernel`), which streamed 8..32-row tiles of the atlas
// through VMEM with lane rolls. Here each block owns a TH x TW tile of output
// pixels and stages the tile plus a 4-pixel halo in shared memory once
// (FAST at the nonmax neighbours reads +-4, Harris gradients + 7x7 box read
// +-4, the blur +-3). Edges wrap on both axes, as the plain version's
// torch.roll does.
//
// Bound on this card: bytes. Per pixel the kernel reads 4 bytes and writes 8
// (rank + blur) and does ~250 float operations, far below the H100's
// ~20 FLOP/byte balance point for fp32 CUDA-core work. The design keeps every
// intermediate (16 circle differences, gradient products, box sums, the
// vertical blur) in shared memory or registers, so device memory sees one
// read of the image and one write of each output (plus the halo re-read,
// (TH+8)(TW+8)/(TH*TW) = 1.9x on the input).
//
// Arithmetic order follows the plain version (ops/fast.py): the 16 FAST
// margin terms in circle order, box sums vertical then horizontal with taps
// from the top/left, blur taps vertical then horizontal. Built with
// -fmad=false, so roundings match its separate multiplies and adds.

#include <cuda_runtime.h>
#include <math.h>

#include "error_string.cuh"

#define TW 32
#define TH 16
#define HALO 4
#define SW (TW + 2 * HALO)
#define SH (TH + 2 * HALO)
#define NTHREADS 256

struct Gauss7 {
    float k[7];
};

__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ int wrap_index(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

__device__ __forceinline__ bool run_ge9(unsigned m) {
    // any circular run of >= 9 set bits among the low 16
    auto rot = [](unsigned v, int s) { return ((v >> s) | (v << (16 - s))) & 0xFFFFu; };
    unsigned s2 = m & rot(m, 1);
    unsigned s4 = s2 & rot(s2, 2);
    unsigned s8 = s4 & rot(s4, 4);
    unsigned s9 = s8 & rot(m, 8);
    return s9 != 0u;
}

__global__ void __launch_bounds__(NTHREADS)
fast_harris_kernel(const float* __restrict__ img, float* __restrict__ rank,
                   float* __restrict__ blur, int H, int W, float t, float kh,
                   Gauss7 g) {
    __shared__ float s_in[SH][SW];                 // input tile + halo
    __shared__ float s_fast[TH + 2][TW + 2];       // FAST score, 1-px halo
    __shared__ float s_g[3][TH + 6][TW + 6];       // gxx, gyy, gxy, 3-px halo
    __shared__ float s_v[3][TH][TW + 6];           // vertical box sums
    __shared__ float s_vb[TH][TW + 6];             // vertical blur

    const size_t plane = (size_t)H * W;
    const float* src = img + blockIdx.z * plane;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int tid = threadIdx.x;

    for (int i = tid; i < SH * SW; i += NTHREADS) {
        int r = i / SW, c = i % SW;
        int y = wrap_index(y0 - HALO + r, H);
        int x = wrap_index(x0 - HALO + c, W);
        s_in[r][c] = src[(size_t)y * W + x];
    }
    __syncthreads();

    // FAST score on output rows -1..TH, cols -1..TW
    for (int i = tid; i < (TH + 2) * (TW + 2); i += NTHREADS) {
        int r = i / (TW + 2), c = i % (TW + 2);
        int cy = r + HALO - 1, cx = c + HALO - 1;
        float ctr = s_in[cy][cx];
        float sb = 0.f, sd = 0.f;
        unsigned mb = 0u, md = 0u;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            float d = s_in[cy + c_dy[k]][cx + c_dx[k]] - ctr;
            if (d > t) { sb = sb + (d - t); mb |= 1u << k; }
            if (d < -t) { sd = sd + (-d - t); md |= 1u << k; }
        }
        bool corner = run_ge9(mb) || run_ge9(md);
        s_fast[r][c] = corner ? fmaxf(sb, sd) : 0.f;
    }
    // gradient products on output rows -3..TH+2, cols -3..TW+2
    for (int i = tid; i < (TH + 6) * (TW + 6); i += NTHREADS) {
        int r = i / (TW + 6), c = i % (TW + 6);
        int cy = r + HALO - 3, cx = c + HALO - 3;
        float gx = s_in[cy][cx + 1] - s_in[cy][cx - 1];
        float gy = s_in[cy + 1][cx] - s_in[cy - 1][cx];
        s_g[0][r][c] = gx * gx;
        s_g[1][r][c] = gy * gy;
        s_g[2][r][c] = gx * gy;
    }
    __syncthreads();

    // vertical passes: box sums of the products, blur of the input
    for (int i = tid; i < TH * (TW + 6); i += NTHREADS) {
        int r = i / (TW + 6), c = i % (TW + 6);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            float acc = 0.f;
#pragma unroll
            for (int d = 0; d < 7; ++d) acc = acc + s_g[p][r + d][c];
            s_v[p][r][c] = acc;
        }
        float vb = 0.f;
#pragma unroll
        for (int d = 0; d < 7; ++d) vb = vb + g.k[d] * s_in[r + HALO - 3 + d][c + HALO - 3];
        s_vb[r][c] = vb;
    }
    __syncthreads();

    for (int i = tid; i < TH * TW; i += NTHREADS) {
        int r = i / TW, c = i % TW;
        int y = y0 + r, x = x0 + c;
        if (y >= H || x >= W) continue;
        float a = 0.f, b = 0.f, cc = 0.f, bl = 0.f;
#pragma unroll
        for (int d = 0; d < 7; ++d) {
            a = a + s_v[0][r][c + d];
            b = b + s_v[1][r][c + d];
            cc = cc + s_v[2][r][c + d];
            bl = bl + g.k[d] * s_vb[r][c + d];
        }
        float harris = (a * b - cc * cc) - kh * ((a + b) * (a + b));
        float s = s_fast[r + 1][c + 1];
        float m = s;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, s_fast[r + dy][c + dx]);
        bool keep = (s >= m) && (s > 0.f);
        size_t o = blockIdx.z * plane + (size_t)y * W + x;
        rank[o] = keep ? harris : -INFINITY;
        blur[o] = bl;
    }
}

extern "C" int fast_harris_launch(const float* img, float* rank, float* blur,
                                  int F, int H, int W, float threshold,
                                  float k_harris, const float* gauss_host,
                                  void* stream) {
    Gauss7 g;
    for (int i = 0; i < 7; ++i) g.k[i] = gauss_host[i];
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, F);
    fast_harris_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        img, rank, blur, H, W, threshold, k_harris, g);
    return (int)cudaGetLastError();
}
