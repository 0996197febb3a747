// K1: fused FAST-9 score + 3x3 nonmax + Harris rank map + 7x7 Gaussian blur.
//
// Replaces rpe_tpu/ops/fast_pallas.py `fast_harris_rank_map`
// (`_fast_harris_kernel`), which streamed 8..32-row tiles of the atlas
// through VMEM with lane rolls. Edges wrap on both axes, as the plain
// version's torch.roll does.
//
// Bound on this card: instruction issue, not bytes. Per pixel the kernel
// reads 4 bytes and writes 8 (rank + blur), but the explicit-tap
// arithmetic it must repeat is ~150 float operations per pixel, and every
// horizontal tap needs a value from another thread's column. The design
// spends as few instructions per pixel as that arithmetic allows:
//   - A block owns a 16 x 120 tile of output pixels and 128 threads. Phase
//     A: thread j owns work column j of the tile (the 120 output columns
//     and a 4-pixel halo each side) and holds that column's 24 input rows
//     in registers, so every vertical tap (gy, the 7-row box sums of the
//     three gradient products, the vertical blur) comes from registers:
//     one load serves up to 7 outputs. The tile is also staged in shared
//     memory for the horizontal neighbours (gx, the FAST circle). Phase B:
//     thread t owns runs of 4 output pixels of one row and reads the
//     vertical sums of their 10-column window with 16-byte shared loads
//     (consecutive lanes, consecutive 16 bytes: no bank conflict), so the
//     horizontal taps come from registers too.
//   - FAST in three steps. The four compass points of every pixel first: a
//     9-run of the 16-point circle holds one of them, so a pixel whose four
//     differences are all within +-t scores 0. Then, for the rows where
//     some lane of the warp passed, two rows at a time, the 16-point masks
//     and the corner test: both masks come from |d| > t and the sign of d,
//     shifted in by two funnel shifts a point, and the run
//     test works on the mask doubled to 32 bits. Last, each lane takes the
//     margin sums of its own corners only. Every other pixel scores 0, as
//     the full test would give.
//   - Wrap-around costs a modulo only in the outer ring of tiles; interior
//     tiles address directly.
//   - Two barriers per tile, one pass over the image.
//
// Arithmetic order follows the plain version (ops/fast.py): the 16 FAST
// margin terms in circle order, box sums vertical then horizontal with 7
// explicit taps from the top/left, blur taps vertical then horizontal. Built
// with -fmad=false, so roundings match its separate multiplies and adds.

#include <cuda_runtime.h>
#include <math.h>

#include "error_string.cuh"

#define TW 120                 // output columns of a tile
#define HALO 4
#define WC (TW + 2 * HALO)     // work columns = threads of a block
#define TH 16                  // output rows of a tile
#define RI (TH + 2 * HALO)     // input rows held per column
#define NF (TH + 2)            // FAST rows per column (1-row nonmax halo)
#define NG (TH + 6)            // gradient-product rows per column
#define SEG 4                  // output pixels per phase-B run
#define NSEG (TW / SEG * TH)
#define NTHREADS WC

struct Gauss7 {
    float k[7];
};

// shared memory, in floats
#define S_IMG 0                          // [RI][WC] input tile
#define S_V (S_IMG + RI * WC)            // [4][TH][WC] vertical sums: xx, yy, xy, blur
#define S_SC (S_V + 4 * TH * WC)         // [NF][WC] FAST score, rows -1..TH
#define SMEM_FLOATS (S_SC + NF * WC)

__host__ __device__ constexpr int circ_dx(int k) {
    const int t[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
    return t[k];
}
__host__ __device__ constexpr int circ_dy(int k) {
    const int t[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
    return t[k];
}

// any circular run of >= 9 set bits among the low 16: doubled to 32 bits,
// a linear run of 9 that starts in the low half
__device__ __forceinline__ bool run_ge9(unsigned m16) {
    const unsigned m = m16 | (m16 << 16);
    unsigned s = m & (m >> 1);
    s &= s >> 2;
    s &= s >> 4;
    s &= m >> 8;
    return (s & 0xFFFFu) != 0u;
}

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

__global__ void __launch_bounds__(NTHREADS, 4)
fast_harris_kernel(const float* __restrict__ img, float* __restrict__ rank,
                   float* __restrict__ blur, int H, int W, float t, float kh,
                   Gauss7 g) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float (*s_img)[WC] = reinterpret_cast<float (*)[WC]>(smem + S_IMG);
    float (*s_v)[TH][WC] = reinterpret_cast<float (*)[TH][WC]>(smem + S_V);
    float (*s_sc)[WC] = reinterpret_cast<float (*)[WC]>(smem + S_SC);

    const size_t plane = (size_t)H * W;
    const float* src = img + blockIdx.z * plane;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int j = threadIdx.x;
    const bool interior = x0 >= HALO && x0 + TW + HALO <= W && y0 >= HALO &&
                          y0 + TH + HALO <= H;

    // ---- phase A: one work column per thread ----
    float col[RI];
    {
        const int x = interior ? x0 - HALO + j : wrap(x0 - HALO + j, W);
        if (interior) {
            const float* p = src + (size_t)(y0 - HALO) * W + x;
#pragma unroll
            for (int i = 0; i < RI; ++i) col[i] = __ldg(p + (size_t)i * W);
        } else {
#pragma unroll
            for (int i = 0; i < RI; ++i)
                col[i] = __ldg(src + (size_t)wrap(y0 - HALO + i, H) * W + x);
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) s_img[i][j] = col[i];
    }
    __syncthreads();

    // FAST on rows -1..TH (input rows 3..TH+4). Columns outside the tile's
    // FAST range (j < 3, j > WC - 4) read wrapped tile columns; their
    // results are not used.
    // Step 1, every pixel: a 9-run of the circle holds a compass point
    // (0, 4, 8 or 12), so a pixel whose four are within +-t scores 0.
    unsigned pre = 0u;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
        const int i = f + HALO - 1;
        const float p = col[i];
        const float c0 = col[i - 3] - p;
        const float c4 = s_img[i][(j + 3) & (WC - 1)] - p;
        const float c8 = col[i + 3] - p;
        const float c12 = s_img[i][(j - 3) & (WC - 1)] - p;
        const bool cand = fmaxf(fmaxf(fabsf(c0), fabsf(c4)),
                                fmaxf(fabsf(c8), fabsf(c12))) > t;
        pre |= (cand ? 1u : 0u) << f;
        s_sc[f][j] = 0.f;
    }
    // Step 2, the rows where some lane of the warp passed, two at a time:
    // the 16-point masks (bit 15 - k: |d_k| > t as the sign of t - |d_k|,
    // and the sign of d_k, shifted in by funnel shifts; exact for t >= 0,
    // which the wrapper requires) and the corner test.
    unsigned corners = 0u;
#pragma unroll 1
    for (unsigned rm = __reduce_or_sync(0xffffffffu, pre); rm;) {
        const int f1 = __ffs(rm) - 1;
        rm &= rm - 1;
        const bool two = rm != 0u;
        const int f2 = two ? __ffs(rm) - 1 : f1;
        if (two) rm &= rm - 1;
        const int i1 = f1 + HALO - 1, i2 = f2 + HALO - 1;
        const float p1 = s_img[i1][j], p2 = s_img[i2][j];
        unsigned ma1 = 0u, ms1 = 0u, ma2 = 0u, ms2 = 0u;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const int c = (j + circ_dx(k)) & (WC - 1);
            const float d1 = s_img[i1 + circ_dy(k)][c] - p1;
            const float d2 = s_img[i2 + circ_dy(k)][c] - p2;
            ma1 = __funnelshift_l(__float_as_uint(t - fabsf(d1)), ma1, 1);
            ms1 = __funnelshift_l(__float_as_uint(d1), ms1, 1);
            ma2 = __funnelshift_l(__float_as_uint(t - fabsf(d2)), ma2, 1);
            ms2 = __funnelshift_l(__float_as_uint(d2), ms2, 1);
        }
        if (run_ge9(ma1 & ~ms1) || run_ge9(ma1 & ms1)) corners |= 1u << f1;
        if (run_ge9(ma2 & ~ms2) || run_ge9(ma2 & ms2)) corners |= 1u << f2;
    }
    // Step 3, this lane's corners only: the margin sums in circle order.
#pragma unroll 1
    for (unsigned cm = corners; cm; cm &= cm - 1) {
        const int f = __ffs(cm) - 1;
        const int i = f + HALO - 1;
        const float p = s_img[i][j];
        float sb = 0.f, sd = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const float d = s_img[i + circ_dy(k)][(j + circ_dx(k)) & (WC - 1)] - p;
            if (d > t) sb = sb + (d - t);
            if (d < -t) sd = sd + (-d - t);
        }
        s_sc[f][j] = fmaxf(sb, sd);
    }

    // vertical blur of output rows 0..TH-1: taps input rows r+1..r+7
#pragma unroll
    for (int r = 0; r < TH; ++r) {
        float vb = 0.f;
#pragma unroll
        for (int d = 0; d < 7; ++d) vb = vb + g.k[d] * col[r + 1 + d];
        s_v[3][r][j] = vb;
    }

    // gradients on rows -3..TH+2 (input rows 1..TH+6), then the vertical
    // 7-row box sums of each product
    float gx[NG], gy[NG];
#pragma unroll
    for (int q = 0; q < NG; ++q) {
        const int i = q + 1;
        gx[q] = s_img[i][(j + 1) & (WC - 1)] - s_img[i][(j - 1) & (WC - 1)];
        gy[q] = col[i + 1] - col[i - 1];
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
        float prod[NG];
#pragma unroll
        for (int q = 0; q < NG; ++q)
            prod[q] = p == 0 ? gx[q] * gx[q] : (p == 1 ? gy[q] * gy[q] : gx[q] * gy[q]);
#pragma unroll
        for (int r = 0; r < TH; ++r) {
            float acc = 0.f;
#pragma unroll
            for (int d = 0; d < 7; ++d) acc = acc + prod[r + d];
            s_v[p][r][j] = acc;
        }
    }
    __syncthreads();

    // ---- phase B: runs of SEG output pixels of one row per thread ----
    const bool vec_ok = (W & 3) == 0;
    for (int s = threadIdx.x; s < NSEG; s += NTHREADS) {
        const int r = s / (TW / SEG);
        const int c0 = (s % (TW / SEG)) * SEG;   // output column of the run
        const int y = y0 + r;
        if (y >= H || x0 + c0 >= W) continue;
        // work columns c0 .. c0+11 cover every tap: output o sits at work
        // column c0 + 4 + o, its taps at c0 + 1 + o .. c0 + 7 + o
        float v[4][12];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int u = 0; u < 3; ++u) {
                const float4 w4 = *reinterpret_cast<const float4*>(&s_v[q][r][c0 + 4 * u]);
                v[q][4 * u] = w4.x;
                v[q][4 * u + 1] = w4.y;
                v[q][4 * u + 2] = w4.z;
                v[q][4 * u + 3] = w4.w;
            }
        // 3 x 3 max of the score: rows r-1..r+1 are s_sc rows r..r+2
        float m[12];
#pragma unroll
        for (int u = 0; u < 3; ++u) {
            float4 q[3];
#pragma unroll
            for (int dr = 0; dr < 3; ++dr)
                q[dr] = *reinterpret_cast<const float4*>(&s_sc[r + dr][c0 + 4 * u]);
            m[4 * u] = fmaxf(fmaxf(q[0].x, q[1].x), q[2].x);
            m[4 * u + 1] = fmaxf(fmaxf(q[0].y, q[1].y), q[2].y);
            m[4 * u + 2] = fmaxf(fmaxf(q[0].z, q[1].z), q[2].z);
            m[4 * u + 3] = fmaxf(fmaxf(q[0].w, q[1].w), q[2].w);
        }
        const float4 sc4 = *reinterpret_cast<const float4*>(&s_sc[r + 1][c0 + 4]);
        const float sc[SEG] = {sc4.x, sc4.y, sc4.z, sc4.w};
        float ro[SEG], bo[SEG];
#pragma unroll
        for (int o = 0; o < SEG; ++o) {
            float a = 0.f, b = 0.f, cc = 0.f, bl = 0.f;
#pragma unroll
            for (int d = 0; d < 7; ++d) {
                a = a + v[0][o + 1 + d];
                b = b + v[1][o + 1 + d];
                cc = cc + v[2][o + 1 + d];
                bl = bl + g.k[d] * v[3][o + 1 + d];
            }
            const float harris = (a * b - cc * cc) - kh * ((a + b) * (a + b));
            const float mx = fmaxf(fmaxf(m[o + 3], m[o + 4]), m[o + 5]);
            const bool keep = (sc[o] >= mx) && (sc[o] > 0.f);
            ro[o] = keep ? harris : -INFINITY;
            bo[o] = bl;
        }
        const size_t base = blockIdx.z * plane + (size_t)y * W + x0 + c0;
        if (vec_ok && x0 + c0 + SEG <= W) {
            *reinterpret_cast<float4*>(rank + base) = make_float4(ro[0], ro[1], ro[2], ro[3]);
            *reinterpret_cast<float4*>(blur + base) = make_float4(bo[0], bo[1], bo[2], bo[3]);
        } else {
#pragma unroll
            for (int o = 0; o < SEG; ++o)
                if (x0 + c0 + o < W) {
                    rank[base + o] = ro[o];
                    blur[base + o] = bo[o];
                }
        }
    }
}

extern "C" int fast_harris_launch(const float* img, float* rank, float* blur,
                                  int F, int H, int W, float threshold,
                                  float k_harris, const float* gauss_host,
                                  void* stream) {
    // the dynamic shared memory above 48 KB is allowed once per device
    static unsigned long long attr_set = 0ull;
    const int smem = SMEM_FLOATS * (int)sizeof(float);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !(attr_set >> dev & 1ull)) {
        e = cudaFuncSetAttribute(fast_harris_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        if (dev < 64) attr_set |= 1ull << dev;
    }
    Gauss7 g;
    for (int i = 0; i < 7; ++i) g.k[i] = gauss_host[i];
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, F);
    fast_harris_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        img, rank, blur, H, W, threshold, k_harris, g);
    return (int)cudaGetLastError();
}
