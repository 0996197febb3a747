// K8, K9, K10: banded patch extraction, one slot per block, in three output
// forms chosen by the template MODE:
//   RAW_BLUR        (K8)  raw and blurred 31x31 patches;
//   BLUR_MOMENTS    (K9)  blurred patch + the raw patch's IC moments m10, m01;
//   BLUR_T_MOMENTS  (K10) blurred patch transposed, out[u * 31 + v] =
//                         blurred[y0 + v, x0 + u], + m10, m01.
//
// Replaces rpe_tpu/ops/extract_pallas.py `extract_windows` (`_extract_kernel`),
// `extract_windows_moments` (`_extract_moments_kernel`) and `extract_windows_t`
// (`_extract_t_kernel`). The TPU kernels selected patch rows and columns with
// one-hot matrix products over band windows (or a VMEM transpose) because
// the TPU has no fast gather, and padded each patch to 32x32 lanes. A GPU
// thread reads any address, so each block reads its slot's patch straight
// from the two atlases and writes it unpadded, (F, NB*CAP, 31, 31) float32. K10 stages the blurred patch in shared memory (coalesced
// reads) and writes it transposed from there (stride 31 is conflict-free).
//
// Slot tables follow rpe_tpu/ops/atlas.py `banded_extract`: the patch of slot
// (b, s) has its top-left corner at (x0[b, s], b * band + rel_y[b, s]); parked
// slots (rel_y < 0) write zero patches and zero moments.
//
// Bound on this card: bytes. A slot reads 1922 floats (K9, K10: the raw
// pixels only feed the moments) and writes 961 or 1922; ~4 operations per
// raw pixel for the moments. Writing the patches dominates.
//
// Arithmetic: the moments reduce in a fixed order (thread-strided partial
// sums, a warp tree, the 8 warps in order), built with -fmad=false, so K9
// and K10 give the same moments and copies are exact; K2 sums in another
// order (a lane per column), within the same contract.

#include <cuda_runtime.h>

#include "error_string.cuh"

#define PATCH 31
#define NPIX (PATCH * PATCH)
#define NTHREADS 256

enum { RAW_BLUR = 0, BLUR_MOMENTS = 1, BLUR_T_MOMENTS = 2 };

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
extract_patches_kernel(const float* __restrict__ atlas, const float* __restrict__ blur,
                       const int* __restrict__ tbl_x0, const int* __restrict__ rel_y,
                       const float* __restrict__ mu, const float* __restrict__ mv,
                       float* __restrict__ raw_out, float* __restrict__ blur_out,
                       float* __restrict__ m10_out, float* __restrict__ m01_out,
                       int HA, int WP, int NB, int CAP, int band) {
    __shared__ float s_blur[MODE == BLUR_T_MOMENTS ? NPIX : 1];
    __shared__ float s_red[2][NTHREADS / 32];

    const int tid = threadIdx.x;
    const int slot = blockIdx.x;                 // b * CAP + s
    const size_t so = (size_t)blockIdx.y * NB * CAP + slot;
    float* ob = blur_out + so * NPIX;
    float* orw = MODE == RAW_BLUR ? raw_out + so * NPIX : nullptr;
    const int ry = rel_y[so];
    if (ry < 0) {
        for (int i = tid; i < NPIX; i += NTHREADS) {
            ob[i] = 0.f;
            if (MODE == RAW_BLUR) orw[i] = 0.f;
        }
        if (MODE != RAW_BLUR && tid == 0) {
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

    float p10 = 0.f, p01 = 0.f;
    for (int i = tid; i < NPIX; i += NTHREADS) {
        int r = i / PATCH, c = i % PATCH;
        int y = y0 + r, x = x0 + c;
        bool in = (y >= 0) && (y < HA) && (x >= 0) && (x < WP);
        size_t o = (size_t)y * WP + x;
        float a = in ? A[o] : 0.f;
        float b = in ? Bl[o] : 0.f;
        if (MODE == RAW_BLUR) {
            orw[i] = a;
        } else {
            p10 = p10 + a * mu[i];
            p01 = p01 + a * mv[i];
        }
        if (MODE == BLUR_T_MOMENTS)
            s_blur[i] = b;
        else
            ob[i] = b;
    }
    if (MODE == RAW_BLUR) return;

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        p10 = p10 + __shfl_down_sync(0xffffffffu, p10, off);
        p01 = p01 + __shfl_down_sync(0xffffffffu, p01, off);
    }
    if ((tid & 31) == 0) {
        s_red[0][tid >> 5] = p10;
        s_red[1][tid >> 5] = p01;
    }
    __syncthreads();                             // also completes s_blur
    if (tid == 0) {
        float a = 0.f, b = 0.f;
        for (int w = 0; w < NTHREADS / 32; ++w) {
            a = a + s_red[0][w];
            b = b + s_red[1][w];
        }
        m10_out[so] = a;
        m01_out[so] = b;
    }
    if (MODE == BLUR_T_MOMENTS) {
        for (int i = tid; i < NPIX; i += NTHREADS) {
            int u = i / PATCH, v = i % PATCH;
            ob[i] = s_blur[v * PATCH + u];
        }
    }
}

// mode: 0 = K8 (raw_out and blur_out), 1 = K9, 2 = K10 (blur_out, m10, m01)
extern "C" int extract_patches_launch(int mode, const float* atlas, const float* blur,
                                      const int* tbl_x0, const int* rel_y,
                                      const float* mu, const float* mv,
                                      float* raw_out, float* blur_out, float* m10,
                                      float* m01, int F, int HA, int WP, int NB,
                                      int CAP, int band, void* stream) {
    dim3 grid(NB * CAP, F);
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
    case RAW_BLUR:
        extract_patches_kernel<RAW_BLUR><<<grid, NTHREADS, 0, s>>>(
            atlas, blur, tbl_x0, rel_y, mu, mv, raw_out, blur_out, m10, m01, HA,
            WP, NB, CAP, band);
        break;
    case BLUR_MOMENTS:
        extract_patches_kernel<BLUR_MOMENTS><<<grid, NTHREADS, 0, s>>>(
            atlas, blur, tbl_x0, rel_y, mu, mv, raw_out, blur_out, m10, m01, HA,
            WP, NB, CAP, band);
        break;
    case BLUR_T_MOMENTS:
        extract_patches_kernel<BLUR_T_MOMENTS><<<grid, NTHREADS, 0, s>>>(
            atlas, blur, tbl_x0, rel_y, mu, mv, raw_out, blur_out, m10, m01, HA,
            WP, NB, CAP, band);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
