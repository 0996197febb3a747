// K2: banded patch extraction + IC moments + steered BRIEF, one slot per block,
// and K12, the same with the ORB paper's 30-bin steering (template BINNED).
//
// Replaces rpe_tpu/ops/extract_pallas.py `extract_windows_t_brief(quad=True)`
// (`_extract_t_brief_kernel_quad` with `_brief_bits_from_patch`) and, binned,
// `extract_windows_t_brief(binned=True)` (`_extract_t_brief_kernel_v7`). The TPU
// kernel selected patch rows with one-hot MXU products because the TPU has
// no fast gather; a GPU thread reads any address, so here each block loads
// its slot's 31x31 raw and blurred patches straight from the two atlases into
// shared memory, reduces the intensity-centroid moments m10/m01 over the
// circular umax mask, normalises (m10, m01) into (cos, sin) of the angle,
// and lets each of its 256 threads sample one rotated BRIEF pair.
//
// Slot tables follow rpe_tpu/ops/atlas.py `banded_extract`: the patch of slot
// (b, s) has its top-left corner at (x0[b, s], b * band + rel_y[b, s]);
// parked slots (rel_y < 0) output zero moments and all-zero bits.
//
// Bound on this card: bytes. A slot moves 2 x 961 floats in and 264 bytes
// out for ~4k float operations. The blocks read patches directly (no window
// materialisation, no one-hot operands), so device memory traffic is the
// patches themselves; neighbouring slots overlap in rows, and those re-reads
// hit L2.
//
// Arithmetic: moments reduce in a fixed order (thread-strided partial sums,
// then a warp tree, then the 8 warps in order). Rounding of the rotated
// pattern is half-to-even (rintf) as jnp.round/torch.round; built with
// -fmad=false so x cos - y sin rounds like the plain version's separate
// products.
//
// K12 (BINNED): the v7 kernel batched 4 slots' samples through static one-hot
// tables so the TPU's matrix unit could do the sampling. Here each thread
// picks the bin itself -- the first b maximising m10 cos_b + m01 sin_b, each
// product rounded and then summed (no FMA), as ops/orb.py `angle_bins` -- and
// reads its pair's two sample indices from the static (30, 512) table
// (row-major patch index iy * 31 + ix, column n = j * 256 + pair), which the
// wrapper copies to the card once. Zero moments give bin 0; parked slots
// give zero bits. Bound as K2.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "error_string.cuh"

#define PATCH 31
#define PATCH_R 15
#define NPIX (PATCH * PATCH)
#define NTHREADS 256
#define NBINS 30

template <bool BINNED>
__global__ void __launch_bounds__(NTHREADS)
extract_brief_kernel(const float* __restrict__ atlas, const float* __restrict__ blur,
                     const int* __restrict__ tbl_x0, const int* __restrict__ rel_y,
                     const float* __restrict__ mu, const float* __restrict__ mv,
                     const float* __restrict__ pat, const int* __restrict__ bin_idx,
                     const float* __restrict__ bin_cs, uint8_t* __restrict__ bits,
                     float* __restrict__ m10_out, float* __restrict__ m01_out,
                     int HA, int WP, int NB, int CAP, int band) {
    __shared__ float s_raw[NPIX];
    __shared__ float s_blur[NPIX];
    __shared__ float s_red[2][NTHREADS / 32];
    __shared__ float s_m[2];

    const int tid = threadIdx.x;
    const int slot = blockIdx.x;                 // b * CAP + s
    const size_t so = (size_t)blockIdx.y * NB * CAP + slot;
    const int ry = rel_y[so];
    if (ry < 0) {
        bits[so * 256 + tid] = 0;
        if (tid == 0) {
            m10_out[so] = 0.f;
            m01_out[so] = 0.f;
        }
        return;
    }
    const int y0 = (slot / CAP) * band + ry;
    const int x0 = tbl_x0[so];
    const size_t plane = (size_t)HA * WP;
    const float* A = atlas + blockIdx.y * plane;
    const float* Bl = blur + blockIdx.y * plane;
    for (int i = tid; i < NPIX; i += NTHREADS) {
        int r = i / PATCH, c = i % PATCH;
        int y = y0 + r, x = x0 + c;
        bool in = (y >= 0) && (y < HA) && (x >= 0) && (x < WP);
        size_t o = (size_t)y * WP + x;
        s_raw[i] = in ? A[o] : 0.f;
        s_blur[i] = in ? Bl[o] : 0.f;
    }
    __syncthreads();

    float p10 = 0.f, p01 = 0.f;
    for (int i = tid; i < NPIX; i += NTHREADS) {
        p10 = p10 + s_raw[i] * mu[i];
        p01 = p01 + s_raw[i] * mv[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        p10 = p10 + __shfl_down_sync(0xffffffffu, p10, off);
        p01 = p01 + __shfl_down_sync(0xffffffffu, p01, off);
    }
    if ((tid & 31) == 0) {
        s_red[0][tid >> 5] = p10;
        s_red[1][tid >> 5] = p01;
    }
    __syncthreads();
    if (tid == 0) {
        float a = 0.f, b = 0.f;
        for (int w = 0; w < NTHREADS / 32; ++w) {
            a = a + s_red[0][w];
            b = b + s_red[1][w];
        }
        s_m[0] = a;
        s_m[1] = b;
        m10_out[so] = a;
        m01_out[so] = b;
    }
    __syncthreads();
    const float m10 = s_m[0], m01 = s_m[1];
    float v[2];
    if (BINNED) {
        int bin = 0;
        float best = m10 * bin_cs[0] + m01 * bin_cs[NBINS];
        for (int b = 1; b < NBINS; ++b) {
            float d = m10 * bin_cs[b] + m01 * bin_cs[NBINS + b];
            if (d > best) {
                best = d;
                bin = b;
            }
        }
        v[0] = s_blur[bin_idx[bin * 512 + tid]];
        v[1] = s_blur[bin_idx[bin * 512 + 256 + tid]];
    } else {
        const float r = sqrtf(m10 * m10 + m01 * m01);
        const float ca = r > 0.f ? m10 / r : 1.f;
        const float sa = r > 0.f ? m01 / r : 0.f;
        // pair tid: points (px0, py0) and (px1, py1)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            float px = pat[tid * 4 + 2 * j];
            float py = pat[tid * 4 + 2 * j + 1];
            float rx = px * ca - py * sa;
            float ryf = px * sa + py * ca;
            int ix = min(max((int)rintf(rx) + PATCH_R, 0), PATCH - 1);
            int iy = min(max((int)rintf(ryf) + PATCH_R, 0), PATCH - 1);
            v[j] = s_blur[iy * PATCH + ix];
        }
    }
    bits[so * 256 + tid] = v[0] < v[1] ? 1 : 0;
}

// binned: 0 launches K2, 1 launches K12 (bin_idx and bin_cs are read only then)
extern "C" int extract_brief_launch(int binned, const float* atlas, const float* blur,
                                    const int* tbl_x0, const int* rel_y,
                                    const float* mu, const float* mv,
                                    const float* pat, const int* bin_idx,
                                    const float* bin_cs, uint8_t* bits,
                                    float* m10, float* m01, int F, int HA,
                                    int WP, int NB, int CAP, int band,
                                    void* stream) {
    dim3 grid(NB * CAP, F);
    cudaStream_t s = (cudaStream_t)stream;
    if (binned)
        extract_brief_kernel<true><<<grid, NTHREADS, 0, s>>>(
            atlas, blur, tbl_x0, rel_y, mu, mv, pat, bin_idx, bin_cs, bits, m10,
            m01, HA, WP, NB, CAP, band);
    else
        extract_brief_kernel<false><<<grid, NTHREADS, 0, s>>>(
            atlas, blur, tbl_x0, rel_y, mu, mv, pat, bin_idx, bin_cs, bits, m10,
            m01, HA, WP, NB, CAP, band);
    return (int)cudaGetLastError();
}
