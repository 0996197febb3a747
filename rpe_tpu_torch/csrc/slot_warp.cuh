// What the warp-per-slot extraction kernels share: K2 and K12
// (extract_brief.cu), K9 and K10 (extract_patches.cu). One warp owns a slot's
// 31x31 patch, lane c its column c. The IC moments are folded here, in one
// order for all four kernels, so their moments are equal bit for bit on the
// same tables.

#pragma once

#include <cuda_runtime.h>

#define PATCH 31
#define PATCH_R 15
#define NPIX (PATCH * PATCH)
#define FULL 0xffffffffu

// OpenCV's IC_Angle extents: row v of the mask covers |u| <= kUmax[|v|]. The
// wrappers hold them to ops/orb.py `_ic_angle_masks()` when they load a
// library (extract_brief_layout, extract_patches_layout).
constexpr int kUmax[PATCH_R + 1] = {15, 15, 15, 15, 14, 14, 14, 13,
                                    13, 12, 11, 10, 9,  8,  6,  3};

constexpr unsigned long long pack_umax() {
    unsigned long long p = 0;
    for (int v = 0; v <= PATCH_R; ++v)
        p |= (unsigned long long)kUmax[v] << (4 * v);
    return p;
}

constexpr unsigned long long kUmaxBits = pack_umax();

__device__ __forceinline__ int umax_of(int av) {
    return (int)((kUmaxBits >> (4 * av)) & 15ull);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// m10, m01 of a slot's raw patch. Lane c holds in raw[r] the pixel of row r
// and column c where |c - 15| <= umax[|r - 15|], else 0 (lane 31, u = 16,
// lies outside every mask row). Each lane folds its column with the exact
// weights u = c - 15, v = r - 15 (the products `mask * u`, `mask * v` of
// ops/orb.py `_ic_angle_masks`), rows in order; a butterfly of shuffles then
// gives every lane the same sums (float addition commutes, so each pair of
// lanes adds the same two values). Built with -fmad=false, so each product
// rounds before its sum.
__device__ __forceinline__ void ic_fold(const float (&raw)[PATCH], int lane,
                                        float& m10, float& m01) {
    const float fu = (float)(lane - PATCH_R);
    m10 = 0.f;
    m01 = 0.f;
#pragma unroll
    for (int r = 0; r < PATCH; ++r) {
        m10 = m10 + raw[r] * fu;
        m01 = m01 + raw[r] * (float)(r - PATCH_R);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        m10 = m10 + __shfl_xor_sync(FULL, m10, off);
        m01 = m01 + __shfl_xor_sync(FULL, m01, off);
    }
}
