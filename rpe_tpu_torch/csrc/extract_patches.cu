// K8, K9, K10: banded patch extraction in three output forms:
//   K8  (mode 0) raw and blurred 31x31 patches;
//   K9  (mode 1) blurred patch + the raw patch's IC moments m10, m01;
//   K10 (mode 2) blurred patch transposed, out[u * 31 + v] =
//                blurred[y0 + v, x0 + u], + m10, m01.
//
// Replaces rpe_tpu/ops/extract_pallas.py `extract_windows` (`_extract_kernel`),
// `extract_windows_moments` (`_extract_moments_kernel`) and `extract_windows_t`
// (`_extract_t_kernel`). The TPU kernels selected patch rows and columns with
// one-hot matrix products over band windows (or a VMEM transpose) because
// the TPU has no fast gather, and padded each patch to 32x32 lanes. A GPU
// thread reads any address, so here the patches are read straight from the
// two atlases and written unpadded, (F, NB*CAP, 31, 31) float32.
//
// Slot tables follow rpe_tpu/ops/atlas.py `banded_extract`: the patch of slot
// (b, s) has its top-left corner at (x0[b, s], b * band + rel_y[b, s]); parked
// slots (rel_y < 0) write zero patches and zero moments. Rows and columns past
// the atlas clamp to its edge, as the plain version's gather.
//
// Bound on this card: bytes, and of those mostly the patch stores. Every
// slot's patch is written, parked slots' zeros included (the patches are
// returned in slot space), 3844 bytes a slot (K8 twice); the reads are the
// raw pixels under live slots' IC masks (K8: whole) and their blurred
// patches; ~4 operations per masked raw pixel for the moments.
//
// K8: a block of 256 threads per slot, grid (NB * CAP, F), a pixel per
// thread in strided rounds (the first port's design, at about half its
// bound).
//
// K9, K10: a warp per slot, designed for the store path:
//   - 4 slots a block in flat (F, NB, CAP) order, so a block's outputs are
//     one contiguous run of 4 x 961 floats, 16-byte aligned whatever CAP is
//     (4 x 3844 = 16 x 961 bytes); a warp finds its band and frame once;
//   - lane c owns patch column c and issues all its loads before it uses
//     any, neighbouring lanes on neighbouring addresses: the raw rows inside
//     the IC mask into registers, folded into the moments as K2 folds them
//     (slot_warp.cuh `ic_fold`, so K9's and K10's moments equal K2's bit for
//     bit); the blurred column by 4-byte cp.async straight to the place it
//     takes in the block's run in shared memory, s[r * 31 + c] for K9 and
//     s[c * 31 + r] for K10, whose bank (31c + r) mod 32 differs for every
//     lane, so the transpose costs no extra pass;
//   - a parked slot's warp zero-fills its 961 shared floats;
//   - after one barrier the block writes its run as 961 coalesced 16-byte
//     stores (the last block, when the slot count is not a multiple of 4,
//     with scalar stores);
//   - at most 64 registers a thread and 15376 B shared a block, so 32 warps
//     fit an SM.
//
// Arithmetic: built with -fmad=false. The moments sum in another order than
// the plain version's (lane rows in order, then the butterfly), within its
// rtol 1e-4, atol 2 contract; patches are copies, exact.

#include <cuda_runtime.h>

#include "error_string.cuh"
#include "slot_warp.cuh"

#define K8_THREADS 256
#define WARPS 4
#define RUN (WARPS * NPIX)   // floats of a block's output run (K9, K10)

enum { RAW_BLUR = 0, BLUR_MOMENTS = 1, BLUR_T_MOMENTS = 2 };

__global__ void __launch_bounds__(K8_THREADS)
raw_blur_kernel(const float* __restrict__ atlas, const float* __restrict__ blur,
                const int* __restrict__ tbl_x0, const int* __restrict__ rel_y,
                float* __restrict__ raw_out, float* __restrict__ blur_out,
                int HA, int WP, int NB, int CAP, int band) {
    const int tid = threadIdx.x;
    const int slot = blockIdx.x;                 // b * CAP + s
    const size_t so = (size_t)blockIdx.y * NB * CAP + slot;
    float* ob = blur_out + so * NPIX;
    float* orw = raw_out + so * NPIX;
    const int ry = rel_y[so];
    if (ry < 0) {
        for (int i = tid; i < NPIX; i += K8_THREADS) {
            ob[i] = 0.f;
            orw[i] = 0.f;
        }
        return;
    }
    const int y0 = (slot / CAP) * band + ry;
    const int x0 = tbl_x0[so];
    const size_t plane = (size_t)HA * WP;
    const float* A = atlas + blockIdx.y * plane;
    const float* Bl = blur + blockIdx.y * plane;
    for (int i = tid; i < NPIX; i += K8_THREADS) {
        const int r = i / PATCH, c = i % PATCH;
        const size_t o = (size_t)min(max(y0 + r, 0), HA - 1) * WP
                         + min(max(x0 + c, 0), WP - 1);
        orw[i] = A[o];
        ob[i] = Bl[o];
    }
}

// Grid (ceil(nslots / WARPS)); tables and outputs in (F, NB, CAP) slot order.
template <bool TRANSPOSED>
__global__ void __launch_bounds__(WARPS * 32, 32 / WARPS)
patch_moments_kernel(const float* __restrict__ atlas, const float* __restrict__ blur,
                     const int* __restrict__ tbl_x0, const int* __restrict__ rel_y,
                     float* __restrict__ blur_out, float* __restrict__ m10_out,
                     float* __restrict__ m01_out, int HA, int WP, int NB, int CAP,
                     int band, int nslots) {
    __shared__ __align__(16) float s_run[RUN];

    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int first = blockIdx.x * WARPS;        // the block's first slot
    const int so = first + w;                    // (f * NB + b) * CAP + s
    float* sb = s_run + w * NPIX;
    if (so < nslots) {
        const int ry = rel_y[so];
        const int x0 = tbl_x0[so];
        if (ry < 0) {
            for (int i = lane; i < NPIX; i += 32) sb[i] = 0.f;
            if (lane == 0) {
                m10_out[so] = 0.f;
                m01_out[so] = 0.f;
            }
        } else {
            // rows and columns past the atlas clamp to its edge; lane 31
            // (u = 16, outside every mask row) loads nothing
            const int fb = so / CAP;             // f * NB + b
            const int f = fb / NB;
            const int y0 = (fb - f * NB) * band + ry;
            const size_t col = (size_t)f * HA * WP
                               + min(max(x0 + min(lane, PATCH - 1), 0), WP - 1);
            const float* A = atlas + col;
            const float* Bl = blur + col;
            const int au = abs(lane - PATCH_R);
            float raw[PATCH];
#pragma unroll
            for (int r = 0; r < PATCH; ++r) {
                const size_t o = (size_t)min(max(y0 + r, 0), HA - 1) * WP;
                if (lane < PATCH)
                    cp_async4(sb + (TRANSPOSED ? lane * PATCH + r
                                               : r * PATCH + lane), Bl + o);
                raw[r] = au <= umax_of(abs(r - PATCH_R)) ? __ldg(A + o) : 0.f;
            }
            float m10, m01;
            ic_fold(raw, lane, m10, m01);
            if (lane == 0) {
                m10_out[so] = m10;
                m01_out[so] = m01;
            }
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // the block's run starts blockIdx.x * 16 * 961 bytes into blur_out
    float* out = blur_out + (size_t)first * NPIX;
    const int n = min(nslots - first, WARPS) * NPIX;
    if (n == RUN) {
        const float4* s4 = reinterpret_cast<const float4*>(s_run);
        float4* o4 = reinterpret_cast<float4*>(out);
        for (int i = threadIdx.x; i < RUN / 4; i += WARPS * 32) o4[i] = s4[i];
    } else {
        for (int i = threadIdx.x; i < n; i += WARPS * 32) out[i] = s_run[i];
    }
}

// mode: 0 = K8 (raw_out and blur_out), 1 = K9, 2 = K10 (blur_out, m10, m01)
extern "C" int extract_patches_launch(int mode, const float* atlas, const float* blur,
                                      const int* tbl_x0, const int* rel_y,
                                      float* raw_out, float* blur_out, float* m10,
                                      float* m01, int F, int HA, int WP, int NB,
                                      int CAP, int band, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int nslots = F * NB * CAP;
    const int blocks = (nslots + WARPS - 1) / WARPS;
    switch (mode) {
    case RAW_BLUR:
        raw_blur_kernel<<<dim3(NB * CAP, F), K8_THREADS, 0, s>>>(
            atlas, blur, tbl_x0, rel_y, raw_out, blur_out, HA, WP, NB, CAP,
            band);
        break;
    case BLUR_MOMENTS:
        patch_moments_kernel<false><<<blocks, WARPS * 32, 0, s>>>(
            atlas, blur, tbl_x0, rel_y, blur_out, m10, m01, HA, WP, NB, CAP,
            band, nslots);
        break;
    case BLUR_T_MOMENTS:
        patch_moments_kernel<true><<<blocks, WARPS * 32, 0, s>>>(
            atlas, blur, tbl_x0, rel_y, blur_out, m10, m01, HA, WP, NB, CAP,
            band, nslots);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// What the wrapper's check compares: the IC mask's extents umax[0..15].
extern "C" void extract_patches_layout(int* out) {
    for (int v = 0; v <= PATCH_R; ++v) out[v] = kUmax[v];
}
