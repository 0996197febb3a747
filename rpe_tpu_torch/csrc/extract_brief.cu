// K2: banded patch extraction + IC moments + steered BRIEF, one warp per
// slot, and K12, the same with the ORB paper's 30-bin steering (template
// BINNED).
//
// Replaces rpe_tpu/ops/extract_pallas.py `extract_windows_t_brief(quad=True)`
// (`_extract_t_brief_kernel_quad` with `_brief_bits_from_patch`) and, binned,
// `extract_windows_t_brief(binned=True)` (`_extract_t_brief_kernel_v7`). The TPU
// kernel selected patch rows with one-hot MXU products because the TPU has
// no fast gather; a GPU thread reads any address, so here each warp reads
// its slot's 31x31 raw and blurred patches straight from the two atlases.
//
// Slot tables follow rpe_tpu/ops/atlas.py `banded_extract`: the patch of slot
// (b, s) has its top-left corner at (x0[b, s], b * band + rel_y[b, s]);
// parked slots (rel_y < 0) output zero moments and all-zero bits. Rows and
// columns past the atlas clamp to its edge, as the plain version's gather.
//
// Bound on this card: bytes. A slot needs at most the 749 raw pixels under
// its IC mask and the blurred pixels its 512 samples reach, and writes 264
// bytes, for ~4k float operations. A block-per-slot design (the first port)
// ran at ~6x that bound: every block, parked ones included, went through
// serial load rounds, three barriers and a serial reduction, so latency set
// its time. This design removes the chain:
//   - a warp per slot, 4 slots per block, no block-wide barrier; the grid
//     is (CAP / 4, NB, F), so no division finds a slot's band or frame; a
//     parked slot's warp writes its 256 zero bytes and two zeros and exits;
//   - lane c owns patch column c and issues all of its loads before it uses
//     any: the raw rows inside the IC mask (|u| <= umax[|v|]) into
//     registers, the blurred rows by cp.async into shared memory (no
//     registers held), neighbouring lanes on neighbouring addresses;
//   - only the blurred pixels that a sample can reach are copied: for a
//     pattern within radius SAMPLE_R = 13 (the default, Gaussian one) a
//     rotated point rounds to |ix|, |iy| <= 13, and the two outer rows and
//     columns on each side are never read (K2's clamp to them acts only on
//     non-finite moments); a pattern that reaches further (OpenCV's, to
//     radius 18.4) takes the wide mode, which copies the whole patch and
//     clamps K2's rotated samples to its rim, as the plain version clips
//     them;
//   - the raw patch never goes to shared memory: each lane folds its rows
//     into m10, m01 with the exact weights u, v of its column and row, and
//     a butterfly of shuffles gives every lane the same sums (slot_warp.cuh
//     `ic_fold`, shared with K9 and K10, whose moments are therefore K2's);
//   - each lane samples 8 of the 256 pairs (pairs lane * 8 + k) and stores
//     its 8 result bytes as one 8-byte store, the warp's 256 bytes
//     coalesced;
//   - K12 picks the bin across the lanes: lane b < 30 forms
//     m10 cos_b + m01 sin_b, a shuffle argmax keeps the largest and the
//     lowest b among ties (zero or NaN moments give bin 0); the pairs of
//     the bin come from a static table read as two coalesced 16-byte loads
//     a lane;
//   - at most 64 registers a thread, so 32 warps fit an SM.
// What is left is most likely the traffic from L2: each live slot requests
// its own rows, and patches overlap, so on the main path's chunk the
// sectors requested are several times those holding a pixel some slot
// needs (scripts/extract_breakdown.py counts both).
// The pattern and K12's pair table are laid out by the wrapper
// (ops/extract.py `_brief_tables`) so that each warp-wide load reads
// consecutive addresses.
//
// Modes (template parameters, chosen by the launcher's `mode` bits): K2 or
// K12; the sample radius R, SAMPLE_R or WIDE_R; QUANT, each sampled value
// rounded half-to-even (rintf) before the compare, as RPE_BRIEF_QUANT asks.
// The wrapper picks R from the pattern, so the default path runs the
// narrow, unrounded code.
//
// Arithmetic: built with -fmad=false, so each product rounds before its
// sum as in the plain version. The moments sum in another order than the
// plain version's (lane rows in order, then the butterfly), within its
// rtol 1e-4, atol 2 contract; steering is (cos, sin) = (m10, m01) / r with
// IEEE sqrtf and division, rounding half-to-even as torch.round.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "error_string.cuh"
#include "slot_warp.cuh"

#define SAMPLE_R 13           // narrow mode: samples round to |ix|, |iy| <= 13
#define WIDE_R PATCH_R        // wide mode: samples clip to the patch rim
#define WARPS 4
#define NBINS 30
#define MODE_BINNED 1         // the launcher's mode bits
#define MODE_WIDE 2
#define MODE_QUANT 4

// The wrapper holds the IC mask's extents (slot_warp.cuh `kUmax`) to ops/
// orb.py `_ic_angle_masks()`, and picks the mode from the BRIEF pattern's
// reach and SAMPLE_R, when it loads the library (extract_brief_layout).

// Row-major patch index of the rotated pattern point (px, py), clamped to
// the pixels copied (|ix|, |iy| <= R). For R = SAMPLE_R and a pattern
// within it, finite moments give |(ca, sa)| <= 1 and the clamp never acts;
// it keeps non-finite ones inside the copy. For R = WIDE_R it is the plain
// version's clip to the patch.
template <int R>
__device__ __forceinline__ int sample_index(float px, float py, float ca,
                                            float sa) {
    const float rx = px * ca - py * sa;
    const float ry = px * sa + py * ca;
    const int ix = min(max(__float2int_rn(rx), -R), R);
    const int iy = min(max(__float2int_rn(ry), -R), R);
    return (iy + PATCH_R) * PATCH + ix + PATCH_R;
}

template <bool QUANT>
__device__ __forceinline__ unsigned brief_bit(float v0, float v1) {
    if (QUANT) {
        v0 = rintf(v0);
        v1 = rintf(v1);
    }
    return v0 < v1 ? 1u : 0u;
}

// pat: float4 (x0, y0, x1, y1) of pair lane * 8 + k at [k * 32 + lane];
// bin_pairs: uint4 at [(bin * 2 + h) * 32 + lane], component q the two
// row-major sample indices iy * 31 + ix (low and high 16 bits) of pair
// lane * 8 + h * 4 + q; bin_cs: the bins' cos (30) then sin (30).
// Grid (CAP / WARPS, NB, F); tables and outputs in (F, NB, CAP) slot order.
template <bool BINNED, int R, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32, 32 / WARPS)
extract_brief_kernel(const float* __restrict__ atlas, const float* __restrict__ blur,
                     const int* __restrict__ tbl_x0, const int* __restrict__ rel_y,
                     const float4* __restrict__ pat, const uint4* __restrict__ bin_pairs,
                     const float* __restrict__ bin_cs, uint8_t* __restrict__ bits,
                     float* __restrict__ m10_out, float* __restrict__ m01_out,
                     int HA, int WP, int CAP, int band) {
    __shared__ float s_blur[WARPS][NPIX];

    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int s = blockIdx.x * WARPS + w;        // slot within its band
    if (s >= CAP) return;
    const int b = blockIdx.y;
    const size_t so = ((size_t)blockIdx.z * gridDim.y + b) * CAP + s;
    const int ry = rel_y[so];
    const int x0 = tbl_x0[so];
    uint2* out = reinterpret_cast<uint2*>(bits + so * 256) + lane;
    if (ry < 0) {
        *out = make_uint2(0u, 0u);
        if (lane == 0) {
            m10_out[so] = 0.f;
            m01_out[so] = 0.f;
        }
        return;
    }
    // Lane c loads column c of both patches, every load issued before any
    // is used; rows and columns past the atlas clamp to its edge, as the
    // plain version's gather. Raw: rows inside the IC mask, into
    // registers (lane 31, u = 16, lies outside every mask row). Blurred: the
    // rows and columns within R of the centre, into shared memory.
    const int y0 = b * band + ry;
    const size_t col = (size_t)blockIdx.z * HA * WP
                       + min(max(x0 + min(lane, PATCH - 1), 0), WP - 1);
    const float* A = atlas + col;
    const float* Bl = blur + col;
    float* sb = s_blur[w];
    const int au = abs(lane - PATCH_R);
    float raw[PATCH];
#pragma unroll
    for (int r = 0; r < PATCH; ++r) {
        const size_t o = (size_t)min(max(y0 + r, 0), HA - 1) * WP;
        if (abs(r - PATCH_R) <= R && au <= R)
            cp_async4(sb + r * PATCH + lane, Bl + o);
        raw[r] = au <= umax_of(abs(r - PATCH_R)) ? __ldg(A + o) : 0.f;
    }
    float m10, m01;
    ic_fold(raw, lane, m10, m01);
    if (lane == 0) {
        m10_out[so] = m10;
        m01_out[so] = m01;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();

    unsigned word[2] = {0u, 0u};
    if (BINNED) {
        // lanes past the bins start at bin 0, so every lane's bin stays a
        // row of the table; lane 0's bin is the slot's (NaN moments take no
        // compare and keep bin 0)
        float d = -INFINITY;
        int bin = lane < NBINS ? lane : 0;
        if (lane < NBINS) d = m10 * bin_cs[lane] + m01 * bin_cs[NBINS + lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float od = __shfl_xor_sync(FULL, d, off);
            const int ob = __shfl_xor_sync(FULL, bin, off);
            if (od > d || (od == d && ob < bin)) {
                d = od;
                bin = ob;
            }
        }
        bin = __shfl_sync(FULL, bin, 0);
        const uint4* tp = bin_pairs + bin * 64 + lane;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint4 q = tp[h * 32];
            const unsigned qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                word[h] |= brief_bit<QUANT>(sb[qs[k] & 0xffffu],
                                            sb[qs[k] >> 16]) << (8 * k);
            }
        }
    } else {
        const float r = sqrtf(m10 * m10 + m01 * m01);
        const float ca = r > 0.f ? m10 / r : 1.f;
        const float sa = r > 0.f ? m01 / r : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const float4 p = pat[k * 32 + lane];
            word[k >> 2] |= brief_bit<QUANT>(
                sb[sample_index<R>(p.x, p.y, ca, sa)],
                sb[sample_index<R>(p.z, p.w, ca, sa)]) << (8 * (k & 3));
        }
    }
    *out = make_uint2(word[0], word[1]);
}

template <bool BINNED, int R, bool QUANT>
static void launch(dim3 grid, cudaStream_t s, const float* atlas,
                   const float* blur, const int* tbl_x0, const int* rel_y,
                   const void* pat, const void* bin_pairs, const float* bin_cs,
                   uint8_t* bits, float* m10, float* m01, int HA, int WP,
                   int CAP, int band) {
    extract_brief_kernel<BINNED, R, QUANT><<<grid, WARPS * 32, 0, s>>>(
        atlas, blur, tbl_x0, rel_y, (const float4*)pat,
        (const uint4*)bin_pairs, bin_cs, bits, m10, m01, HA, WP, CAP, band);
}

// mode: MODE_BINNED launches K12 (bin_pairs and bin_cs are read only then,
// pat only for K2), MODE_WIDE the sample radius WIDE_R, MODE_QUANT rounded
// samples; another bit is refused
extern "C" int extract_brief_launch(int mode, const float* atlas, const float* blur,
                                    const int* tbl_x0, const int* rel_y,
                                    const void* pat, const void* bin_pairs,
                                    const float* bin_cs, uint8_t* bits,
                                    float* m10, float* m01, int F, int HA,
                                    int WP, int NB, int CAP, int band,
                                    void* stream) {
    if (mode & ~(MODE_BINNED | MODE_WIDE | MODE_QUANT))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((CAP + WARPS - 1) / WARPS, NB, F);
    cudaStream_t s = (cudaStream_t)stream;
    typedef void (*Launch)(dim3, cudaStream_t, const float*, const float*,
                           const int*, const int*, const void*, const void*,
                           const float*, uint8_t*, float*, float*, int, int,
                           int, int);
    static const Launch table[8] = {
        launch<false, SAMPLE_R, false>, launch<true, SAMPLE_R, false>,
        launch<false, WIDE_R, false>,   launch<true, WIDE_R, false>,
        launch<false, SAMPLE_R, true>,  launch<true, SAMPLE_R, true>,
        launch<false, WIDE_R, true>,    launch<true, WIDE_R, true>};
    table[mode](grid, s, atlas, blur, tbl_x0, rel_y, pat, bin_pairs, bin_cs,
                bits, m10, m01, HA, WP, CAP, band);
    return (int)cudaGetLastError();
}

// What the wrapper's checks compare: the IC mask's extents umax[0..15], then
// SAMPLE_R and WIDE_R, the narrow and wide modes' sample radii.
extern "C" void extract_brief_layout(int* out) {
    for (int v = 0; v <= PATCH_R; ++v) out[v] = kUmax[v];
    out[PATCH_R + 1] = SAMPLE_R;
    out[PATCH_R + 2] = WIDE_R;
}
