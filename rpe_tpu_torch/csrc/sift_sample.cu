// P3 and P4: SIFT's orientation histogram and descriptor in a fixed order.
//
// No TPU kernel of their own: the reference's SIFT (rpe_tpu/ops/sift.py
// `_orientation` :421-465, `_descriptor` :502-596) is XLA. Its sums are
// float32 matmuls -- the separable bilinear sampling of the 24 x 24 grid,
// the 36-bin histogram against a one-hot of the bins, the 4x4x8 trilinear
// histogram against one-hots of the bins -- and the descriptor's two norms
// are reductions. On this card cuBLAS picks a batched GEMM's kernel, and
// PyTorch a reduction's split, by the batch, so a frame's keypoints got
// other bits in a call of another size: a histogram bit moved a secondary
// peak across 0.8 of the first, and the re-selection kept another keypoint.
//
// Here one warp owns one keypoint slot and every sum runs in an order that
// depends only on the sample index (the 24 x 24 grid, row-major ascending):
//
//   P3 `ori_hist_kernel`: lanes compute the 576 samples of both gradient
//     planes (bilinear: rows, then columns), their magnitude, angle, bin
//     and Gaussian-windowed term into shared memory; lane b then sums the
//     terms of bin b (and b + 32) over the samples in ascending order.
//   P4 `desc_kernel`: lanes compute each sample's rotated bin coordinates
//     and its trilinear weights (two row, two column, two orientation bins)
//     into shared memory, 192 samples at a time; lane l owns column bin
//     l / 8, orientation bin l % 8 and the four row bins, and sums its four
//     outputs over the samples in ascending order. The 128 sums are then
//     normalised, clipped at 0.2 and renormalised, each norm summed over
//     the 128 values in ascending order by every lane alike.
//
// Sums are carried in float64 and rounded once to float32, as P2 does;
// the bilinear sample is formed in float64 from its four exact products
// and rounded once. Every other step is the plain version's float32
// operation in the plain version's order: the file is built with
// -fmad=false, no fast math (IEEE division and sqrtf, libdevice's atan2f,
// cosf, sinf), and constants are the plain version's Python floats rounded
// to float32. So the kernels differ from their plain versions only in the
// order and precision of the sums; a sample's bin can still differ where
// its angle lies within rounding of a bin edge (chip_smoke.py counts such
// slots). Nothing depends on the batch, the grid of blocks or the octave:
// no float atomics, no split of one output's sum.
//
// Bound on this card: bytes -- the sampled pixels of each slot's two
// gradient patches (at most 48 x 48 of the 80 x 80, read through L1),
// the per-slot scalars and the outputs; the float64 sums and atan2f make
// the work a few thousand operations a slot, well under the byte time at
// the main path's 27,216 slots of octave 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int G = 24;               // sample grid side, both windows
constexpr int NS = G * G;           // 576 samples
constexpr int ORI_BINS = 36;
constexpr int DESC_N = 128;         // 4 x 4 x 8
constexpr int WARPS = 4;            // slots per block
constexpr int CHUNK = 192;          // descriptor samples staged per pass

// the plain version's Python constants, rounded to float32 as PyTorch
// rounds a Python float for a float32 operation
constexpr float TWO_PI = (float)6.283185307179586;   // _div(., 2 * math.pi)
constexpr float SQRT2 = (float)1.4142135623730951;   // math.sqrt(2.0)
constexpr float EPS = (float)1e-12;
constexpr float CLIP = (float)0.2;

// Tables (float32, on the card once per device): orientation grid lin (G),
// its Gaussian window (NS), descriptor grid lin (G), its window (NS).
constexpr int TAB_ORI_LIN = 0, TAB_ORI_W = G, TAB_DESC_LIN = G + NS,
              TAB_DESC_W = 2 * G + NS;

// `_sep_weights` for one grid coordinate u of a patch side p: clamp to
// [1, p - 2.001], first tap floor(u), weights 1 - f and f.
__device__ __forceinline__ void sep_tap(float u, int p, int& i0, float& w0,
                                        float& w1) {
    const float hi = (float)((double)p - 2.001);
    u = fminf(fmaxf(u, 1.0f), hi);
    const float fl = floorf(u);
    i0 = (int)fl;
    const float f = u - fl;
    w0 = 1.0f - f;
    w1 = f;
}

// One bilinear sample of a patch (row stride px): rows first, then
// columns, as `_patch_sample`'s (Wy @ gp) @ Wx^T; the four products are
// exact in float64 and the sample rounds once.
__device__ __forceinline__ float bilinear(const float* __restrict__ p, int px,
                                          int y0, float wy0, float wy1,
                                          int x0, float wx0, float wx1) {
    const float* r0 = p + (long long)y0 * px + x0;
    const float* r1 = r0 + px;
    const double t0 = (double)wy0 * (double)r0[0] + (double)wy1 * (double)r1[0];
    const double t1 = (double)wy0 * (double)r0[1] + (double)wy1 * (double)r1[1];
    return (float)((double)wx0 * t0 + (double)wx1 * t1);
}

// Each lane < G computes the taps of grid row/column `lane` around centre
// (cx, cy) at `radius` into shared memory ([0] rows y, [1] columns x).
struct Taps {
    int i0[2][G];
    float w0[2][G], w1[2][G];
};

__device__ __forceinline__ void grid_taps(Taps& t, int lane,
                                          const float* __restrict__ lin,
                                          float cx, float cy, float radius,
                                          int py, int px) {
    if (lane < G) {
        const float step = lin[lane] * radius;
        sep_tap(cy + step, py, t.i0[0][lane], t.w0[0][lane], t.w1[0][lane]);
        sep_tap(cx + step, px, t.i0[1][lane], t.w0[1][lane], t.w1[1][lane]);
    }
    __syncwarp();
}

__device__ __forceinline__ float sample(const Taps& t, const float* p, int px,
                                        int i, int j) {
    return bilinear(p, px, t.i0[0][i], t.w0[0][i], t.w1[0][i], t.i0[1][j],
                    t.w0[1][j], t.w1[1][j]);
}

// `_tri` for n bins: floor, fraction, and the two bins' weights (masked
// out of range and clamped) or, with wrap, both bins taken modulo n.
__device__ __forceinline__ void tri(float v, int n, bool wrap, int& i0,
                                    float& w0, int& i1, float& w1) {
    const float b = floorf(v);
    const float f = v - b;
    const int b0 = (int)b, b1 = b0 + 1;
    if (wrap) {
        i0 = ((b0 % n) + n) % n;
        i1 = ((b1 % n) + n) % n;
        w0 = 1.0f - f;
        w1 = f;
    } else {
        w0 = (b0 >= 0 && b0 < n) ? 1.0f - f : 0.0f;
        w1 = (b1 >= 0 && b1 < n) ? f : 0.0f;
        i0 = min(max(b0, 0), n - 1);
        i1 = min(max(b1, 0), n - 1);
    }
}

// torch.remainder of a float32 by a positive float32
__device__ __forceinline__ float remainder_pos(float a, float b) {
    float m = fmodf(a, b);
    if (m != 0.0f && m < 0.0f) m += b;
    return m;
}

template <bool DETAIL>
__global__ void __launch_bounds__(WARPS * 32)
ori_hist_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ ucx, const float* __restrict__ ucy,
                const float* __restrict__ scl, const float* __restrict__ tab,
                float* __restrict__ hist, float* __restrict__ samples,
                uint8_t* __restrict__ bins, long long n, int py, int px) {
    __shared__ Taps s_taps[WARPS];
    __shared__ float s_term[WARPS][NS];
    __shared__ unsigned char s_bin[WARPS][NS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long slot = (long long)blockIdx.x * WARPS + warp;
    if (slot >= n) return;              // the whole warp: no block barrier
    Taps& t = s_taps[warp];
    const float radius = scl[slot] * 4.5f;          // 3.0 * 1.5 * scl
    grid_taps(t, lane, tab + TAB_ORI_LIN, ucx[slot], ucy[slot], radius, py,
              px);
    const long long plane = (long long)py * px;
    const float* pgx = gx + slot * plane;
    const float* pgy = gy + slot * plane;
    const float* win = tab + TAB_ORI_W;
    for (int s = lane; s < NS; s += 32) {
        const int i = s / G, j = s - (s / G) * G;
        const float vx = sample(t, pgx, px, i, j);
        const float vy = sample(t, pgy, px, i, j);
        const float mag = sqrtf(vx * vx + vy * vy);
        const float ang = atan2f(vy, vx);
        int b = (int)floorf((ang / TWO_PI + 0.5f) * (float)ORI_BINS);
        b = min(max(b, 0), ORI_BINS - 1);
        s_term[warp][s] = mag * win[s];
        s_bin[warp][s] = (unsigned char)b;
        if (DETAIL) {
            samples[slot * 2 * NS + s] = vx;
            samples[slot * 2 * NS + NS + s] = vy;
            bins[slot * NS + s] = (uint8_t)b;
        }
    }
    __syncwarp();
    const int b0 = lane, b1 = lane + 32;
    double a0 = 0.0, a1 = 0.0;
    for (int s = 0; s < NS; ++s) {
        const int b = s_bin[warp][s];
        if (b == b0) a0 += (double)s_term[warp][s];
        else if (b == b1) a1 += (double)s_term[warp][s];
    }
    hist[slot * ORI_BINS + b0] = (float)a0;
    if (b1 < ORI_BINS) hist[slot * ORI_BINS + b1] = (float)a1;
}

// Sum of the float32 squares of 128 shared values, in ascending order.
__device__ __forceinline__ float norm128(const float* d) {
    double ss = 0.0;
    for (int k = 0; k < DESC_N; ++k) ss += (double)(d[k] * d[k]);
    return sqrtf((float)ss) + EPS;
}

template <bool DETAIL>
__global__ void __launch_bounds__(WARPS * 32)
desc_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
            const long long* __restrict__ pidx,
            const float* __restrict__ ucx, const float* __restrict__ ucy,
            const float* __restrict__ scl, const float* __restrict__ theta,
            const float* __restrict__ tab, float* __restrict__ desc,
            float* __restrict__ samples, float* __restrict__ raw,
            long long n, long long q, long long q_src, int py, int px) {
    __shared__ Taps s_taps[WARPS];
    // per staged sample: two row, two column and two orientation bins
    // with their weights (the orientation ones times the sample's term)
    __shared__ unsigned char s_rb[WARPS][2][CHUNK], s_cb[WARPS][2][CHUNK],
        s_ob[WARPS][2][CHUNK];
    __shared__ float s_rw[WARPS][2][CHUNK], s_cw[WARPS][2][CHUNK],
        s_ow[WARPS][2][CHUNK];
    __shared__ float s_d[WARPS][DESC_N];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long slot = (long long)blockIdx.x * WARPS + warp;
    if (slot >= n) return;              // the whole warp: no block barrier
    Taps& t = s_taps[warp];
    const float th = theta[slot];
    const float ca = cosf(th), sa = sinf(th);
    // hist_width * sqrt(2) * (d + 1) * 0.5, hist_width = 3.0 * scl
    const float radius = scl[slot] * 3.0f * SQRT2 * 5.0f * 0.5f;
    grid_taps(t, lane, tab + TAB_DESC_LIN, ucx[slot], ucy[slot], radius, py,
              px);
    const long long plane = (long long)py * px;
    const long long src = (slot / q) * q_src + pidx[slot];
    const float* pgx = gx + src * plane;
    const float* pgy = gy + src * plane;
    const float* lin = tab + TAB_DESC_LIN;
    const float* win = tab + TAB_DESC_W;
    const int my_c = lane >> 3, my_o = lane & 7;   // outputs 32 r + lane
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    for (int c0 = 0; c0 < NS; c0 += CHUNK) {
        for (int k = lane; k < CHUNK; k += 32) {
            const int s = c0 + k;
            const int i = s / G, j = s - (s / G) * G;
            const float vx = sample(t, pgx, px, i, j);
            const float vy = sample(t, pgy, px, i, j);
            const float mag = sqrtf(vx * vx + vy * vy);
            const float ang = atan2f(vy, vx) - th;
            const float gxg = lin[j], gyg = lin[i];
            const float gxr = gxg * ca + gyg * sa;
            const float gyr = -gxg * sa + gyg * ca;
            const float rbin = gyr * SQRT2 * 5.0f * 0.5f + 2.0f - 0.5f;
            const float cbin = gxr * SQRT2 * 5.0f * 0.5f + 2.0f - 0.5f;
            // cv2's descriptor gradients are y-up: the relative angle negated
            const float obin = remainder_pos(-ang / TWO_PI * 8.0f, 8.0f);
            const float w = mag * win[s];
            int r0, r1, q0, q1, o0, o1;
            float rw0, rw1, cw0, cw1, ow0, ow1;
            tri(rbin, 4, false, r0, rw0, r1, rw1);
            tri(cbin, 4, false, q0, cw0, q1, cw1);
            tri(obin, 8, true, o0, ow0, o1, ow1);
            s_rb[warp][0][k] = (unsigned char)r0;
            s_rb[warp][1][k] = (unsigned char)r1;
            s_cb[warp][0][k] = (unsigned char)q0;
            s_cb[warp][1][k] = (unsigned char)q1;
            s_ob[warp][0][k] = (unsigned char)o0;
            s_ob[warp][1][k] = (unsigned char)o1;
            s_rw[warp][0][k] = rw0;
            s_rw[warp][1][k] = rw1;
            s_cw[warp][0][k] = cw0;
            s_cw[warp][1][k] = cw1;
            s_ow[warp][0][k] = w * ow0;
            s_ow[warp][1][k] = w * ow1;
            if (DETAIL) {
                samples[slot * 2 * NS + s] = vx;
                samples[slot * 2 * NS + NS + s] = vy;
            }
        }
        __syncwarp();
        for (int k = 0; k < CHUNK; ++k) {
            // the one-hot products of the plain version: C[c] and wO[o]
            // (a bin's two weights meet only where one of them is 0)
            const float cc = (s_cb[warp][0][k] == my_c ? s_cw[warp][0][k] : 0.0f)
                + (s_cb[warp][1][k] == my_c ? s_cw[warp][1][k] : 0.0f);
            const float wo = s_ob[warp][0][k] == my_o ? s_ow[warp][0][k]
                : (s_ob[warp][1][k] == my_o ? s_ow[warp][1][k] : 0.0f);
            if (cc == 0.0f || wo == 0.0f) continue;
            const int r0 = s_rb[warp][0][k], r1 = s_rb[warp][1][k];
            const float rw0 = s_rw[warp][0][k], rw1 = s_rw[warp][1][k];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float rr = (r0 == r ? rw0 : 0.0f) + (r1 == r ? rw1 : 0.0f);
                if (rr != 0.0f) acc[r] += (double)(rr * cc) * (double)wo;
            }
        }
        __syncwarp();
    }
    float d[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        d[r] = (float)acc[r];
        s_d[warp][32 * r + lane] = d[r];
        if (DETAIL) raw[slot * DESC_N + 32 * r + lane] = d[r];
    }
    __syncwarp();
    const float nrm = norm128(s_d[warp]);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        d[r] = fminf(d[r] / nrm, CLIP);
        s_d[warp][32 * r + lane] = d[r];
    }
    __syncwarp();
    const float nrm2 = norm128(s_d[warp]);
#pragma unroll
    for (int r = 0; r < 4; ++r) desc[slot * DESC_N + 32 * r + lane] = d[r] / nrm2;
}

int grid_for(long long n, unsigned& blocks) {
    const long long b = (n + WARPS - 1) / WARPS;
    if (b > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    blocks = (unsigned)b;
    return 0;
}

}  // namespace

// P3. gx, gy (n, py, px); ucx, ucy, scl (n); tab the four grid tables;
// hist (n, 36). samples (n, 2, 576) and bins (n, 576), both or neither:
// the kernel's samples and bins, for the contracts and the probe.
extern "C" int sift_orientation_hist_launch(
        const float* gx, const float* gy, const float* ucx, const float* ucy,
        const float* scl, const float* tab, float* hist, float* samples,
        uint8_t* bins, long long n, int py, int px, void* stream) {
    if (n <= 0) return 0;
    if (py < 4 || px < 4 || (samples == nullptr) != (bins == nullptr))
        return (int)cudaErrorInvalidValue;
    unsigned blocks;
    if (int rc = grid_for(n, blocks)) return rc;
    cudaStream_t st = (cudaStream_t)stream;
    if (samples != nullptr)
        ori_hist_kernel<true><<<blocks, WARPS * 32, 0, st>>>(
            gx, gy, ucx, ucy, scl, tab, hist, samples, bins, n, py, px);
    else
        ori_hist_kernel<false><<<blocks, WARPS * 32, 0, st>>>(
            gx, gy, ucx, ucy, scl, tab, hist, nullptr, nullptr, n, py, px);
    return (int)cudaGetLastError();
}

// P4. gx, gy (f, q_src, py, px); pidx (f, q) indices into q_src; ucx, ucy,
// scl, theta (f, q); desc (f, q, 128). samples (n, 2, 576) and raw
// (n, 128), both or neither: the samples and the sums before
// normalising, for the contracts and the probe. n = f * q.
extern "C" int sift_descriptor_launch(
        const float* gx, const float* gy, const long long* pidx,
        const float* ucx, const float* ucy, const float* scl,
        const float* theta, const float* tab, float* desc, float* samples,
        float* raw, long long n, long long q, long long q_src, int py, int px,
        void* stream) {
    if (n <= 0) return 0;
    if (py < 4 || px < 4 || q <= 0 || q_src <= 0
            || (samples == nullptr) != (raw == nullptr))
        return (int)cudaErrorInvalidValue;
    unsigned blocks;
    if (int rc = grid_for(n, blocks)) return rc;
    cudaStream_t st = (cudaStream_t)stream;
    if (samples != nullptr)
        desc_kernel<true><<<blocks, WARPS * 32, 0, st>>>(
            gx, gy, pidx, ucx, ucy, scl, theta, tab, desc, samples, raw, n, q,
            q_src, py, px);
    else
        desc_kernel<false><<<blocks, WARPS * 32, 0, st>>>(
            gx, gy, pidx, ucx, ucy, scl, theta, tab, desc, nullptr, nullptr,
            n, q, q_src, py, px);
    return (int)cudaGetLastError();
}

// The grid side and the table layout's length, so the wrapper can hold
// its tables to the kernel's.
extern "C" int sift_sample_grid() { return G; }
extern "C" int sift_sample_table_len() { return 2 * G + 2 * NS; }
