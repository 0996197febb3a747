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
//   P3 `ori_hist_kernel`: the lanes compute the 576 samples of both
//     gradient planes (bilinear: rows, then columns), their magnitude,
//     angle, bin and Gaussian-windowed term in 18 rounds of 32 samples,
//     lane l taking sample 32 r + l and holding its term in a register.
//     Each sample takes its place in its bin's list as it is made: the
//     bin's entries of the rounds before (a count in shared memory) plus
//     the lanes before it in this round with the same bin
//     (`__match_any_sync`). After the rounds an exclusive scan of the 36
//     counts gives each bin a contiguous run of shared memory, every term
//     goes to its place, and the lane that owns a bin sums its run in
//     ascending order. A term that is exactly +0.0 takes no place (every
//     term is >= 0 or NaN and the sum starts at +0.0, so adding it changes
//     no bit): the 168 samples outside the window's circle and the flat
//     ones. Lane b owns bin b; bins 32-35 go to the four lanes with the
//     fewest entries, so the walk takes as long as the largest bin, not
//     576 samples for every bin.
//   P4 `desc_kernel`: a block of four warps owns one slot. Its 128
//     threads compute the samples in rounds of 128: each sample's rotated
//     bin coordinates and trilinear weights (two row, two column and two
//     orientation bins). Each sample appends itself, with the product of
//     its row and column weights, to the list of every cell (row bin,
//     column bin) where both are non-zero -- at most 2 x 2 cells -- at a
//     place that keeps each list in ascending sample order: the entries of
//     the rounds before, of the warps before it in this round (their
//     counts, by ballot, in shared memory) and of the lanes before it (a
//     ballot). A list holds at most 60 of the 576 samples (the grid points
//     inside a rotated square of 2 x 2 bins, 6.79 samples a side; 50 at
//     most over a sweep of the angle). Thread (w, l) then owns output
//     32 w + l (row bin w, column bin l / 8, orientation bin l % 8) and
//     walks its cell's list, adding the samples whose orientation weight
//     for its bin is non-zero. The 128 sums are then normalised, clipped at
//     0.2 and renormalised, each norm summed over the 128 values in
//     ascending order by one thread. Each output sums the same non-zero
//     terms in the same order as a walk over all 576 samples would, so
//     its bits are that walk's.
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
// the main path's 27,216 slots of octave 0. Both kernels are held back by
// issue slots instead, so both visit each sample once per output it
// reaches: in P3 a sample reaches one of the 36 bins, and its lists spare
// each bin a walk over all 576 samples; in P4 a sample reaches 8 of the
// 128 outputs, and an output visits its cell's ~46 and adds ~12 terms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int G = 24;               // sample grid side, both windows
constexpr int NS = G * G;           // 576 samples
constexpr int ORI_BINS = 36;
constexpr int DESC_N = 128;         // 4 x 4 x 8
constexpr int WARPS = 4;            // P3: slots per block; P4: warps per slot
constexpr int DESC_D = 4;           // P4's row and column bins
constexpr int CELLS = DESC_D * DESC_D;
constexpr int CAP = 64;             // a cell's list: at most 60 samples

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
    constexpr int ROUNDS = NS / 32;
    constexpr unsigned NONE = 0xffffffffu;      // a term that takes no place
    __shared__ Taps s_taps[WARPS];
    __shared__ float s_run[WARPS][NS];          // the terms, bin by bin
    __shared__ int s_at[WARPS][ORI_BINS];       // a bin's count, then offset
    const unsigned FULL = 0xffffffffu;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const long long slot = (long long)blockIdx.x * WARPS + warp;
    if (slot >= n) return;              // the whole warp: no block barrier
    Taps& t = s_taps[warp];
    int* at = s_at[warp];
    float* run = s_run[warp];
    const float radius = scl[slot] * 4.5f;          // 3.0 * 1.5 * scl
    at[lane] = 0;
    if (lane < ORI_BINS - 32) at[32 + lane] = 0;
    grid_taps(t, lane, tab + TAB_ORI_LIN, ucx[slot], ucy[slot], radius, py,
              px);                                  // (ends in __syncwarp)
    const long long plane = (long long)py * px;
    const float* pgx = gx + slot * plane;
    const float* pgy = gy + slot * plane;
    const float* win = tab + TAB_ORI_W;
    float term[ROUNDS];
    unsigned key[ROUNDS];               // bin << 16 | place in its bin
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int s = 32 * r + lane;
        const int i = s / G, j = s - (s / G) * G;
        const float vx = sample(t, pgx, px, i, j);
        const float vy = sample(t, pgy, px, i, j);
        const float mag = sqrtf(vx * vx + vy * vy);
        const float ang = atan2f(vy, vx);
        int b = (int)floorf((ang / TWO_PI + 0.5f) * (float)ORI_BINS);
        b = min(max(b, 0), ORI_BINS - 1);
        const float w = mag * win[s];
        if (DETAIL) {
            samples[slot * 2 * NS + s] = vx;
            samples[slot * 2 * NS + NS + s] = vy;
            bins[slot * NS + s] = (uint8_t)b;
        }
        const bool keep = __float_as_uint(w) != 0u;
        const unsigned peers = __match_any_sync(FULL, keep ? b : ORI_BINS);
        const int place = at[b] + __popc(peers & below);
        __syncwarp();
        // the last lane of the bin's group counts the round's entries
        if (keep && (peers >> lane) == 1u) at[b] = place + 1;
        __syncwarp();
        term[r] = w;
        key[r] = keep ? ((unsigned)b << 16 | (unsigned)place) : NONE;
    }
    // exclusive scan of the counts: bins 0-31 in the low half-word of a
    // lane's value, bins 32-35 (lanes 0-3) in the high one
    const int c0 = at[lane];
    const int c1 = lane < ORI_BINS - 32 ? at[32 + lane] : 0;
    int sum = c0 | (c1 << 16);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, sum, d);
        if (lane >= d) sum += u;
    }
    const int total0 = __shfl_sync(FULL, sum, 31) & 0xffff;
    const int off0 = (sum & 0xffff) - c0;
    const int off1 = total0 + (sum >> 16) - c1;
    __syncwarp();
    at[lane] = off0;
    if (lane < ORI_BINS - 32) at[32 + lane] = off1;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r)
        if (key[r] != NONE) run[at[key[r] >> 16] + (key[r] & 0xffffu)] = term[r];
    // bin 32 + e goes to the lane with the e-th fewest entries (ties to
    // the lower lane)
    unsigned mine = (unsigned)c0 << 5 | (unsigned)lane;
    int extra = -1;
#pragma unroll
    for (int e = 0; e < ORI_BINS - 32; ++e) {
        const unsigned least = __reduce_min_sync(FULL, mine);
        if ((least & 31u) == (unsigned)lane) {
            extra = 32 + e;
            mine = 0xffffffffu;
        }
    }
    const int e1 = extra < 0 ? 0 : extra - 32;
    const int x_off = __shfl_sync(FULL, off1, e1);
    const int x_cnt = __shfl_sync(FULL, c1, e1);
    __syncwarp();
    // each bin's run in ascending sample order, in float64, rounded once
    double a0 = 0.0;
    for (int k = 0; k < c0; ++k) a0 += (double)run[off0 + k];
    hist[slot * ORI_BINS + lane] = (float)a0;
    if (extra >= 0) {
        double a1 = 0.0;
        for (int k = 0; k < x_cnt; ++k) a1 += (double)run[x_off + k];
        hist[slot * ORI_BINS + extra] = (float)a1;
    }
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
            long long q, long long q_src, int py, int px) {
    __shared__ Taps s_taps;
    // per sample: orientation bins o0, o1 and the sample's term times
    // their weights
    __shared__ uchar2 s_ob[NS];
    __shared__ float2 s_ow[NS];
    // per cell (row bin r, column bin c: 4 r + c): its samples in
    // ascending order and their row weight times column weight (strides
    // padded so that the cells of a warp's lanes spread over the banks)
    __shared__ unsigned short s_idx[CELLS][CAP + 2];
    __shared__ float s_rc[CELLS][CAP + 1];
    __shared__ int s_cnt[WARPS][CELLS];     // a round's entries per warp
    __shared__ int s_off[WARPS][CELLS];     // where a warp's entries go
    __shared__ int s_len[CELLS];            // entries of all rounds so far
    __shared__ float s_d[DESC_N];
    __shared__ float s_nrm;
    const unsigned FULL = 0xffffffffu;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const unsigned below = (1u << lane) - 1u;
    const long long slot = blockIdx.x;
    const float th = theta[slot];
    const float ca = cosf(th), sa = sinf(th);
    // hist_width * sqrt(2) * (d + 1) * 0.5, hist_width = 3.0 * scl
    const float radius = scl[slot] * 3.0f * SQRT2 * 5.0f * 0.5f;
    grid_taps(s_taps, tid, tab + TAB_DESC_LIN, ucx[slot], ucy[slot], radius,
              py, px);
    if (tid < CELLS) s_len[tid] = 0;
    __syncthreads();
    const long long plane = (long long)py * px;
    const long long src = (slot / q) * q_src + pidx[slot];
    const float* pgx = gx + src * plane;
    const float* pgy = gy + src * plane;
    const float* lin = tab + TAB_DESC_LIN;
    const float* win = tab + TAB_DESC_W;
    // rounds of 128 samples, thread t taking sample s0 + t; each round
    // appends its samples to the lists of the cells they reach, in
    // ascending order: warps by the counts of the warps before them, lanes
    // by a ballot
    for (int s0 = 0; s0 < NS; s0 += WARPS * 32) {
        const int s = s0 + tid;
        int r0 = 0, r1 = 0, q0 = 0, q1 = 0;
        float rw0 = 0.0f, rw1 = 0.0f, cw0 = 0.0f, cw1 = 0.0f;
        if (s < NS) {
            const int i = s / G, j = s - (s / G) * G;
            const float vx = sample(s_taps, pgx, px, i, j);
            const float vy = sample(s_taps, pgy, px, i, j);
            const float mag = sqrtf(vx * vx + vy * vy);
            const float ang = atan2f(vy, vx) - th;
            const float gxg = lin[j], gyg = lin[i];
            const float gxr = gxg * ca + gyg * sa;
            const float gyr = -gxg * sa + gyg * ca;
            const float rbin = gyr * SQRT2 * 5.0f * 0.5f + 2.0f - 0.5f;
            const float cbin = gxr * SQRT2 * 5.0f * 0.5f + 2.0f - 0.5f;
            // cv2's descriptor gradients are y-up: the relative angle
            // negated
            const float obin = remainder_pos(-ang / TWO_PI * 8.0f, 8.0f);
            const float w = mag * win[s];
            int o0, o1;
            float ow0, ow1;
            tri(rbin, DESC_D, false, r0, rw0, r1, rw1);
            tri(cbin, DESC_D, false, q0, cw0, q1, cw1);
            tri(obin, 8, true, o0, ow0, o1, ow1);
            s_ob[s] = make_uchar2(o0, o1);
            s_ow[s] = make_float2(w * ow0, w * ow1);
            if (DETAIL) {
                samples[slot * 2 * NS + s] = vx;
                samples[slot * 2 * NS + NS + s] = vy;
            }
        }
        // the plain version's one-hot products R[b] and C[b] of this
        // sample (0 past the grid): lane b holds the warp's ballot of
        // R[b] != 0, lane 4 + b that of C[b] != 0 (a bin's two weights
        // meet only where one of them is 0)
        unsigned hold = 0;
#pragma unroll
        for (int b = 0; b < DESC_D; ++b) {
            const float rr = (r0 == b ? rw0 : 0.0f) + (r1 == b ? rw1 : 0.0f);
            const float cc = (q0 == b ? cw0 : 0.0f) + (q1 == b ? cw1 : 0.0f);
            const unsigned mr = __ballot_sync(FULL, rr != 0.0f);
            const unsigned mc = __ballot_sync(FULL, cc != 0.0f);
            hold = lane == b ? mr : lane == DESC_D + b ? mc : hold;
        }
        const unsigned cellm = __shfl_sync(FULL, hold, (lane >> 2) & 3)
            & __shfl_sync(FULL, hold, DESC_D + (lane & 3));
        if (lane < CELLS) s_cnt[warp][lane] = __popc(cellm);
        __syncthreads();
        if (tid < CELLS) {
            int run = s_len[tid];
#pragma unroll
            for (int w = 0; w < WARPS; ++w) {
                s_off[w][tid] = run;
                run += s_cnt[w][tid];
            }
            s_len[tid] = run;
        }
        __syncthreads();
        // this sample's entries: the (at most) 2 x 2 cells it reaches
        const unsigned mr0 = __shfl_sync(FULL, hold, r0);
        const unsigned mr1 = __shfl_sync(FULL, hold, r1);
        const unsigned mc0 = __shfl_sync(FULL, hold, DESC_D + q0);
        const unsigned mc1 = __shfl_sync(FULL, hold, DESC_D + q1);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
            const int r = a ? r1 : r0;
            const unsigned mr = a ? mr1 : mr0;
            const float rr = (r0 == r ? rw0 : 0.0f) + (r1 == r ? rw1 : 0.0f);
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                const int c = b ? q1 : q0;
                const unsigned mc = b ? mc1 : mc0;
                const float cc = (q0 == c ? cw0 : 0.0f)
                    + (q1 == c ? cw1 : 0.0f);
                const bool once = (a == 0 || r1 != r0) && (b == 0 || q1 != q0);
                if (once && rr != 0.0f && cc != 0.0f) {
                    const int cell = DESC_D * r + c;
                    const int at = s_off[warp][cell] + __popc(mr & mc & below);
                    if (at < CAP) {
                        s_idx[cell][at] = (unsigned short)s;
                        s_rc[cell][at] = rr * cc;
                    }
                }
            }
        }
    }
    __syncthreads();
    // output 32 w + lane (row bin r = w, column bin c, orientation bin o):
    // its cell's samples in ascending order, each where the orientation
    // one-hot wO[o] is non-zero
    const int r = warp, c = lane >> 3, o = lane & 7, cell = DESC_D * r + c;
    const int len = s_len[cell];
    double acc = 0.0;
    for (int k = 0; k < min(len, CAP); ++k) {
        const int s = s_idx[cell][k];
        const uchar2 ob = s_ob[s];
        const float2 ow = s_ow[s];
        const float wo = ob.x == o ? ow.x : (ob.y == o ? ow.y : 0.0f);
        if (wo != 0.0f) acc += (double)s_rc[cell][k] * (double)wo;
    }
    // more samples than a list holds (only a non-finite angle): no result
    float d = len > CAP ? __int_as_float(0x7fc00000) : (float)acc;
    s_d[tid] = d;
    if (DETAIL) raw[slot * DESC_N + tid] = d;
    __syncthreads();
    if (tid == 0) s_nrm = norm128(s_d);
    __syncthreads();
    d = fminf(d / s_nrm, CLIP);
    s_d[tid] = d;
    __syncthreads();
    if (tid == 0) s_nrm = norm128(s_d);
    __syncthreads();
    desc[slot * DESC_N + tid] = d / s_nrm;
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
    if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const unsigned blocks = (unsigned)n;           // a block per slot
    cudaStream_t st = (cudaStream_t)stream;
    if (samples != nullptr)
        desc_kernel<true><<<blocks, WARPS * 32, 0, st>>>(
            gx, gy, pidx, ucx, ucy, scl, theta, tab, desc, samples, raw, q,
            q_src, py, px);
    else
        desc_kernel<false><<<blocks, WARPS * 32, 0, st>>>(
            gx, gy, pidx, ucx, ucy, scl, theta, tab, desc, nullptr, nullptr,
            q, q_src, py, px);
    return (int)cudaGetLastError();
}

// The grid side and the table layout's length, so the wrapper can hold
// its tables to the kernel's.
extern "C" int sift_sample_grid() { return G; }
extern "C" int sift_sample_table_len() { return 2 * G + 2 * NS; }
