// K7: squared-L2 mutual nearest neighbours, and K6 in L2 mode: per-row best,
// argbest and second-best distance (template flag TOP2), batched over pairs
// of (N, 128) float32 descriptor sets.
//
// Replaces rpe_tpu/ops/match_pallas.py `mutual_nn_l2sq` (`_mutual_nn`, body
// `_match_kernel`) and `_row_top2` (body `_ratio_kernel`) with norm="l2".
// The TPU kernels streamed (128, N2) Gram tiles through the MXU and reduced
// them in VMEM; here the Gram product runs on Hopper's TF32 tensor cores
// and the (N1, N2) matrix never reaches memory. The distance is the plain
// version's own formula, max(|a|^2 + |b|^2 - 2 a.b, 0), so ties at 0
// (duplicate descriptors) and every argmin follow the plain version up to
// the rounding of a.b.
//
// Precision: one TF32 product keeps 11 significant bits of each operand
// (about 1e-4 on a unit-norm dot product), too coarse for the 1e-5 contract.
// So each value is split, x = hi + lo, hi = tf32(x) and lo = tf32(x - hi),
// both rounded to nearest (cvt.rna; the tensor cores would truncate the low
// 13 bits of an unrounded operand), and a.b = hi.lo + lo.hi + hi.hi
// ("3xTF32"). The dropped lo.lo term and the rounding of lo leave about
// 2^-21 sum |a_k b_k| per dot product. The sums need care too: the tensor
// cores round each k-step's float32 sum toward zero (scripts/l2_accuracy.py
// fits the kernel's distances to both roundings), and with one accumulator
// over all 48 steps that bias flipped a near-tie the plain version resolves.
// So each 32-dimension stage accumulates its cross products first and its
// four hi.hi steps last, and the stage's sum joins a register accumulator
// with one rounding to nearest; |x|^2 is summed in float64 and rounded
// once.
//
// Bound on this card: operations, 3 x 2 x 128 per valid cell (valid rows x
// valid columns) at the TF32 tensor-core rate (494.7 TFLOP/s dense): 0.102
// ms at the chunk's 8 pairs of 4096 x 4096; the descriptors take 0.010 ms
// to read at 3.35 TB/s. What the design does about it:
// - A split pass (one launch for both sets) writes hi and lo as a (2, P, N,
//   128) tensor, each descriptor's |x|^2 (+inf for an invalid slot, padded
//   to whole tiles) and one flag per 128-descriptor tile: does it hold a
//   valid slot.
// - Main kernel: one CTA per (pair, 128-row tile), two consumer warpgroups
//   of 64 rows and a producer warpgroup, whose first thread issues every
//   load (`setmaxnreg` moves its registers to the consumers, which hold the
//   products and their register sums). The row tile's hi and lo (128 KB)
//   are loaded once by TMA and stay resident; (128-column x 32-dimension)
//   boxes of hi and lo (32 KB a stage) stream through a ring of STAGES
//   buffers, 128-byte swizzled, completing on mbarriers. Per stage each
//   warpgroup runs twelve `wgmma.m64n128k8.f32.tf32.tf32` (four k-steps of
//   the two cross products, then four of hi.hi), both operands read from
//   shared memory through 128-byte-swizzle descriptors, then adds the
//   result into its register sums. A row tile without a valid row only
//   writes its canonical outputs; a column tile without a valid column is
//   neither loaded nor multiplied.
// - Overlap: warpgroup 1 starts one warpgroup-stage of products after
//   warpgroup 0, so that each one's sums and epilogue run while the other's
//   products keep the tensor cores busy; and a tile's epilogue runs after
//   the next tile's first products are issued, under them.
// - Epilogue in registers, per 128-column tile (`tile_epilogue`): each
//   cell's distance (+inf where the row or the column is invalid); rows
//   keep running (min, argmin) chains in increasing column order (strict
//   <, so the lowest index wins), in top-2 mode also the second best, the
//   minimum over every other valid column (`_ratio_kernel`), merged
//   lexicographically on (distance, column) at the end. Columns (K7): per
//   column the nearer of the thread's two rows as the key (ordered_key(d)
//   << 32 | row), the minimum over the warp's 16 rows by shuffles, then one
//   global 64-bit atomicMin per column per warp (measured faster than a
//   per-CTA minimum in shared memory, whose 64-bit atomics cost more).
// A finalize pass maps the column keys to indices with the reference's
// canonical outputs: best_d = _BIG and index 0 for an invalid row or a row
// without valid columns, index 0 for an invalid column or a column without
// valid rows; in top-2 mode an invalid row gives (_BIG, 0, _BIG).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "colkey.cuh"
#include "error_string.cuh"
#include "sm90.cuh"

#define DIM 128                   // descriptor length: the product's depth
#define KCH 32                    // dimensions per box: one 128-byte swizzle span
#define NKC (DIM / KCH)           // boxes per descriptor (stages per column tile)
#define ROWS 128                  // rows per CTA, resident
#define TILE 128                  // columns per streamed tile
#define STAGES 3                  // boxes in flight
#define NCONSUMER 256             // two consumer warpgroups
#define NTHREADS (NCONSUMER + 128)  // + the producer warpgroup
#define BIG_F 3.0e38f

typedef unsigned long long u64;

constexpr int BOX_BYTES = TILE * KCH * 4;           // 128 rows or columns x 128 B
constexpr int STAGE_BYTES = 2 * BOX_BYTES;          // hi and lo: 32 KB
constexpr int A_BYTES = NKC * 2 * BOX_BYTES;        // 128 KB
constexpr int SMEM_BYTES = 1024                     // alignment slack
                           + A_BYTES                // A: [NKC][hi, lo][rows][128 B]
                           + STAGES * STAGE_BYTES   // B ring
                           + (2 * STAGES + 2) * 8;  // mbarriers
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a CTA may use");
static_assert(ROWS == TILE, "A and B boxes share one shape");

// x rounded to the nearest TF32 value (ties away from zero), low 13 bits 0
__device__ __forceinline__ float tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r & 0xFFFFE000u);
}

__device__ __forceinline__ void split1(float x, float& hi, float& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - hi);        // x - hi is exact in float32
}

// Grid (T1 + T2, P), 128 threads: block (x, pair) takes one 128-descriptor
// tile of desc1 (x < T1) or desc2. Each warp takes one descriptor at a time,
// a float4 per lane (coalesced): its hi and lo, and |x|^2 as float64 partial
// sums (the squares are exact there) reduced by shuffles, rounded once.
__global__ void __launch_bounds__(TILE)
split_kernel(const float* __restrict__ desc1, const float* __restrict__ desc2,
             const bool* __restrict__ valid1, const bool* __restrict__ valid2,
             float* __restrict__ hilo1, float* __restrict__ hilo2,
             float* __restrict__ nav1, float* __restrict__ nav2, int* __restrict__ flags1,
             int* __restrict__ flags2, int P, int N1, int N2, int T1, int T2) {
    const bool second = blockIdx.x >= T1;
    const int tile = second ? blockIdx.x - T1 : blockIdx.x;
    const int N = second ? N2 : N1, T = second ? T2 : T1;
    const int pair = blockIdx.y, t = threadIdx.x, lane = t & 31, r0 = tile * TILE;
    const float* x = (second ? desc2 : desc1) + (size_t)pair * N * DIM;
    const bool* v = (second ? valid2 : valid1) + (size_t)pair * N;
    float* nav = (second ? nav2 : nav1) + (size_t)pair * T * TILE;
    float* hi = (second ? hilo2 : hilo1) + (size_t)pair * N * DIM;
    float* lo = hi + (size_t)P * N * DIM;
    const bool ok = r0 + t < N && v[r0 + t];
    const int any = __syncthreads_or(ok);
    if (t == 0) (second ? flags2 : flags1)[pair * T + tile] = any;
    const int n = min(TILE, N - r0);
    if (r0 + t >= N) nav[r0 + t] = INFINITY;          // past the end
    for (int r = t >> 5; r < n; r += TILE / 32) {
        const size_t f = (size_t)(r0 + r) * (DIM / 4) + lane;
        const float4 a = reinterpret_cast<const float4*>(x)[f];
        float4 h, l;
        split1(a.x, h.x, l.x);
        split1(a.y, h.y, l.y);
        split1(a.z, h.z, l.z);
        split1(a.w, h.w, l.w);
        reinterpret_cast<float4*>(hi)[f] = h;
        reinterpret_cast<float4*>(lo)[f] = l;
        double s = (double)a.x * a.x + (double)a.y * a.y + (double)a.z * a.z +
                   (double)a.w * a.w;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) nav[r0 + r] = v[r0 + r] ? (float)s : INFINITY;
    }
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 rows x 128 columns, f32) (+)= A (64 x 8 tf32) . B (128 x 8 tf32)^T, both
// K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "setp.ne.b32 p, %66, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, "
        "%64, %65, p, 1, 1;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

// (d, j, s) <- the lexicographic minimum on (distance, column) of two
// disjoint column sets' (best, argbest, second best); the second best stays
// the minimum over every other column
__device__ __forceinline__ void merge_best(float& d, int& j, float& s, float d2, int j2,
                                           float s2) {
    if (d2 < d || (d2 == d && j2 < j)) {
        s = fminf(s2, d);
        d = d2;
        j = j2;
    } else {
        s = fminf(s, d2);
    }
}

// The epilogue of one 128-column tile starting at col0, on a thread's
// fragment of the finished dot products (see the header); nb[j] holds the
// |b|^2 of the thread's columns 8j + 2 (lane % 4) + {0, 1} (+inf: invalid or
// past the end), na those of its rows, so an invalid row or column gives
// d = +inf.
// Rows: four independent running (best, argbest[, second]) chains q = 2h +
// e (row h, columns of parity e), each in increasing column order (strict
// <, so the lowest index wins). K7's columns: keys (ordered_key(d) << 32 |
// row), reduced over the warp's 16 rows by shuffles, then one global 64-bit
// atomicMin per column per warp.
template <bool TOP2>
__device__ __forceinline__ void tile_epilogue(const float (&dot)[64], const float2 (&nb)[16],
                                              int col0, const float (&na)[2],
                                              float (&best)[4], float (&sec)[4],
                                              int (&arg)[4], int row_lo, int lane, u64* ck,
                                              int N2) {
    const int cq = col0 + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        u64 colp[16];                     // the half's 16 columns of this thread
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * half + jj;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float nbv = e ? nb[j].y : nb[j].x;
                const int c = cq + 8 * j + e;
                float d[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    d[h] = fmaxf((na[h] + nbv) - 2.0f * dot[4 * j + 2 * h + e], 0.0f);
                    const int q = 2 * h + e;
                    const bool better = d[h] < best[q];
                    if (TOP2) sec[q] = better ? best[q] : fminf(sec[q], d[h]);
                    best[q] = fminf(best[q], d[h]);
                    arg[q] = better ? c : arg[q];
                }
                if (!TOP2) {
                    // the column's nearer row of the two (the upper on ties)
                    const bool lower = d[1] < d[0];
                    const float dm = lower ? d[1] : d[0];
                    colp[2 * jj + e] = dm < INFINITY
                                           ? ((u64)ordered_key(dm) << 32) |
                                                 (unsigned)(row_lo + (lower ? 8 : 0))
                                           : ~0ull;
                }
            }
        }
        if (!TOP2) {
            // reduce-scatter (min) over the 8 lanes that hold the same
            // columns (lane bits 2-4): afterwards lane l holds the half's
            // fragment columns q = 2 (l >> 2) + k, k < 2
            const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const u64 send = b4 ? colp[k] : colp[k + 8];
                const u64 keep = b4 ? colp[k + 8] : colp[k];
                colp[k] = umin64(keep, __shfl_xor_sync(0xffffffffu, send, 16));
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const u64 send = b3 ? colp[k] : colp[k + 4];
                const u64 keep = b3 ? colp[k + 4] : colp[k];
                colp[k] = umin64(keep, __shfl_xor_sync(0xffffffffu, send, 8));
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const u64 send = b2 ? colp[k] : colp[k + 2];
                const u64 keep = b2 ? colp[k + 2] : colp[k];
                colp[k] = umin64(keep, __shfl_xor_sync(0xffffffffu, send, 4));
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int q = 2 * (lane >> 2) + k;     // q = 2 jj + e
                const int c = col0 + 8 * (8 * half + (q >> 1)) + 2 * (lane & 3) + (q & 1);
                if (colp[k] != ~0ull && c < N2) atomicMin(ck + c, colp[k]);
            }
        }
    }
}

template <bool TOP2>
__global__ void __launch_bounds__(NTHREADS, 1)
l2_tc_kernel(const __grid_constant__ CUtensorMap map1,
             const __grid_constant__ CUtensorMap map2, const float* __restrict__ nav1,
             const float* __restrict__ nav2, const int* __restrict__ flags1,
             const int* __restrict__ flags2, float* __restrict__ best_d,
             int* __restrict__ nn12, float* __restrict__ second_d, u64* __restrict__ colkey,
             int P, int N1, int N2) {
    const int T1 = (N1 + ROWS - 1) / ROWS, T2 = (N2 + TILE - 1) / TILE;
    const int tid = threadIdx.x, pair = blockIdx.y, row0 = blockIdx.x * ROWS;
    if (!flags1[pair * T1 + blockIdx.x]) {
        // no valid row in the tile: only the canonical outputs
        const int i = row0 + tid;
        if (tid < ROWS && i < N1) {
            const size_t o = (size_t)pair * N1 + i;
            best_d[o] = BIG_F;
            nn12[o] = 0;
            if (TOP2) second_d[o] = BIG_F;
        }
        return;
    }
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* sA = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint8_t* sB = sA + A_BYTES;                     // [STAGES][hi, lo][128][128 B]
    uint64_t* bars = reinterpret_cast<uint64_t*>(sB + STAGES * STAGE_BYTES);
    // full: a stage landed; empty: the consumers released it; afull: the
    // row tile landed; go: warpgroup 0's first products are done
    const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES),
                   afull = smem_u32(bars + 2 * STAGES), go = afull + 8;
    const int* f2 = flags2 + pair * T2;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, NCONSUMER);
        }
        mbar_init(afull, 1);
        mbar_init(go, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= NCONSUMER) {
        // ---- producer: the last warpgroup's first thread issues every load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
        if (tid != NCONSUMER) return;
        mbar_expect_tx(afull, A_BYTES);
        for (int kc = 0; kc < NKC; ++kc)
            for (int part = 0; part < 2; ++part)
                tma_box(smem_u32(sA + (2 * kc + part) * BOX_BYTES), &map1, afull, kc * KCH,
                        row0, part * P + pair);
        int it = 0;
        for (int t = 0; t < T2; ++t) {
            if (!f2[t]) continue;
            for (int kc = 0; kc < NKC; ++kc, ++it) {
                const int s = it % STAGES;
                if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
                const uint32_t fb = full0 + 8 * s;
                mbar_expect_tx(fb, STAGE_BYTES);
                for (int part = 0; part < 2; ++part)
                    tma_box(smem_u32(sB + s * STAGE_BYTES + part * BOX_BYTES), &map2, fb,
                            kc * KCH, t * TILE, part * P + pair);
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg holds tile rows 64 wg .. 64 wg + 63. A
    // thread's accumulator fragment: registers 4j + {0, 1} hold its row
    // r_lo, columns 8j + 2 (lane % 4) + {0, 1}; registers 4j + {2, 3} the
    // same of row r_lo + 8 (h = 1) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int r_lo = wg * 64 + warp * 16 + (lane >> 2);
    float na[2], best[4], sec[4];
    int arg[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) na[h] = nav1[(size_t)pair * T1 * ROWS + row0 + r_lo + 8 * h];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        best[q] = sec[q] = BIG_F;
        arg[q] = 0;
    }
    float acc[64], dot[64];
    float2 nb[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    const uint32_t a_base = smem_u32(sA) + wg * 64 * 128;
    const float* nb_pair = nav2 + (size_t)pair * T2 * TILE + 2 * (lane & 3);
    u64* ck = TOP2 ? nullptr : colkey + (size_t)pair * N2;
    mbar_wait(afull, 0);
    int it = 0, pend = -1;        // the tile whose epilogue is still to run
    for (int t = 0; t < T2; ++t) {
        if (!f2[t]) continue;
#pragma unroll 1
        for (int kc = 0; kc < NKC; ++kc, ++it) {
            const int s = it % STAGES;
            // warpgroup 1 starts half a stage late, so that each
            // warpgroup's sums and epilogue run under the other's products
            if (it == 0 && wg == 1) mbar_wait(go, 0);
            mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
            fence_acc(acc);
            asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
            const uint32_t b_hi = smem_u32(sB + s * STAGE_BYTES), b_lo = b_hi + BOX_BYTES;
            const uint32_t a_hi = a_base + 2 * kc * BOX_BYTES, a_lo = a_hi + BOX_BYTES;
            // the stage's 32 dimensions, 8 (32 bytes) a k-step: the small
            // cross products first, then hi.hi, so that only the four hi.hi
            // steps add to a large sum
#pragma unroll
            for (int ks = 0; ks < KCH / 8; ++ks)
                wgmma_tf32(acc, sw128_desc(a_hi + 32 * ks), sw128_desc(b_lo + 32 * ks), ks > 0);
#pragma unroll
            for (int ks = 0; ks < KCH / 8; ++ks)
                wgmma_tf32(acc, sw128_desc(a_lo + 32 * ks), sw128_desc(b_hi + 32 * ks), 1);
#pragma unroll
            for (int ks = 0; ks < KCH / 8; ++ks)
                wgmma_tf32(acc, sw128_desc(a_hi + 32 * ks), sw128_desc(b_hi + 32 * ks), 1);
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
            if (kc == 0 && pend >= 0) {
                // the previous tile's epilogue runs while this tile's first
                // products do
                tile_epilogue<TOP2>(dot, nb, pend * TILE, na, best, sec, arg, row0 + r_lo,
                                    lane, ck, N2);
            }
            if (kc == NKC - 1) {
                // this tile's |b|^2, loaded while its last products run
                pend = t;
#pragma unroll
                for (int j = 0; j < 16; ++j)
                    nb[j] = *reinterpret_cast<const float2*>(nb_pair + t * TILE + 8 * j);
            }
            asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
            fence_acc(acc);
            mbar_arrive(empty0 + 8 * s);
            if (it == 0 && wg == 0 && (tid & 127) == 0) mbar_arrive(go);
            // the tensor cores truncate each step's sum; the stage's partial
            // a.b joins the dot product with one rounding to nearest
            if (kc == 0) {
#pragma unroll
                for (int i = 0; i < 64; ++i) dot[i] = acc[i];
            } else {
#pragma unroll
                for (int i = 0; i < 64; ++i) dot[i] += acc[i];
            }
        }
    }
    if (pend >= 0)
        tile_epilogue<TOP2>(dot, nb, pend * TILE, na, best, sec, arg, row0 + r_lo, lane,
                            ck, N2);

    // the row's two column-parity chains, then the 4 lanes of a quad
    // (disjoint columns of the same rows)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float d = best[2 * h], s = sec[2 * h];
        int j = arg[2 * h];
        merge_best(d, j, s, best[2 * h + 1], arg[2 * h + 1], sec[2 * h + 1]);
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
            merge_best(d, j, s, __shfl_xor_sync(0xffffffffu, d, off),
                       __shfl_xor_sync(0xffffffffu, j, off),
                       __shfl_xor_sync(0xffffffffu, s, off));
        const int i = row0 + r_lo + 8 * h;
        const bool rv = na[h] < INFINITY;
        if ((lane & 3) == 0 && i < N1) {
            const size_t o = (size_t)pair * N1 + i;
            best_d[o] = rv ? d : BIG_F;
            nn12[o] = rv ? j : 0;
            if (TOP2) second_d[o] = rv ? s : BIG_F;
        }
    }
}

// The scratch of one call, carved from one buffer in this order (each
// piece 256-byte aligned): hi and lo of each side as (2, P, N, 128) float32;
// |x|^2 or +inf (invalid slot or past the end) as (P, T * 128) float32 per
// side (T tiles of 128);
// one valid-slot flag per tile as (P, T) int32 per side; K7's column keys
// (P, N2) uint64.
struct Scratch {
    float *hilo1, *hilo2, *nav1, *nav2;
    int *flags1, *flags2;
    u64* colkey;
};

static size_t carve(uintptr_t base, int P, int N1, int N2, Scratch* s) {
    const size_t T1 = (N1 + ROWS - 1) / ROWS, T2 = (N2 + TILE - 1) / TILE;
    size_t off = 0;
    auto take = [&](size_t bytes) {
        const uintptr_t p = base + off;
        off += (bytes + 255) & ~(size_t)255;
        return p;
    };
    s->hilo1 = (float*)take(2 * (size_t)P * N1 * DIM * 4);
    s->hilo2 = (float*)take(2 * (size_t)P * N2 * DIM * 4);
    s->nav1 = (float*)take((size_t)P * T1 * ROWS * 4);
    s->nav2 = (float*)take((size_t)P * T2 * TILE * 4);
    s->flags1 = (int*)take((size_t)P * T1 * 4);
    s->flags2 = (int*)take((size_t)P * T2 * 4);
    s->colkey = (u64*)take((size_t)P * N2 * 8);
    return off;
}

extern "C" size_t match_l2_scratch_bytes(int P, int N1, int N2) {
    Scratch s;
    return carve(0, P, N1, N2, &s);
}

// split pass and main kernel (K7's column keys are set to ~0 by the caller)
template <bool TOP2>
static int launch(const float* desc1, const float* desc2, const bool* valid1,
                  const bool* valid2, float* best_d, int* nn12, float* second_d,
                  const Scratch& sc, int P, int N1, int N2, cudaStream_t st) {
    const int T1 = (N1 + ROWS - 1) / ROWS, T2 = (N2 + TILE - 1) / TILE;
    if (P == 0 || T1 + T2 == 0) return 0;
    split_kernel<<<dim3(T1 + T2, P), TILE, 0, st>>>(desc1, desc2, valid1, valid2, sc.hilo1,
                                                    sc.hilo2, sc.nav1, sc.nav2, sc.flags1,
                                                    sc.flags2, P, N1, N2, T1, T2);
    if (N1 == 0) return (int)cudaGetLastError();
    CUtensorMap map1, map2;
    int rc = tensor_map_3d(&map1, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sc.hilo1, DIM, N1,
                           2 * (uint64_t)P, KCH, ROWS);
    if (rc == 0 && N2 > 0)
        rc = tensor_map_3d(&map2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sc.hilo2, DIM, N2,
                           2 * (uint64_t)P, KCH, TILE);
    else if (rc == 0)
        map2 = map1;                    // no column tiles: never read
    if (rc != 0) return rc;
    static unsigned long long attr_set = 0ull;  // per device, as the attribute
    rc = smem_attr_per_device(l2_tc_kernel<TOP2>, SMEM_BYTES, attr_set);
    if (rc != 0) return rc;
    l2_tc_kernel<TOP2><<<dim3(T1, P), NTHREADS, SMEM_BYTES, st>>>(
        map1, map2, sc.nav1, sc.nav2, sc.flags1, sc.flags2, best_d, nn12, second_d,
        sc.colkey, P, N1, N2);
    return (int)cudaGetLastError();
}

extern "C" int match_l2_launch(const float* desc1, const float* desc2, const bool* valid1,
                               const bool* valid2, float* best_d, int* nn12, int* nn21,
                               void* scratch, int P, int N1, int N2, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    Scratch sc;
    carve((uintptr_t)scratch, P, N1, N2, &sc);
    const int ncol = P * N2;
    if (ncol > 0) {
        cudaError_t e = cudaMemsetAsync(sc.colkey, 0xFF, (size_t)ncol * 8, st);
        if (e != cudaSuccess) return (int)e;
    }
    int rc = launch<false>(desc1, desc2, valid1, valid2, best_d, nn12, nullptr, sc, P, N1,
                           N2, st);
    if (rc != 0 || ncol == 0) return rc;
    finalize_cols<<<(ncol + 255) / 256, 256, 0, st>>>(sc.colkey, valid2, nn21, ncol);
    return (int)cudaGetLastError();
}

extern "C" int row_top2_l2_launch(const float* desc1, const float* desc2, const bool* valid1,
                                  const bool* valid2, float* d1, int* a1, float* d2,
                                  void* scratch, int P, int N1, int N2, void* stream) {
    Scratch sc;
    carve((uintptr_t)scratch, P, N1, N2, &sc);
    return launch<true>(desc1, desc2, valid1, valid2, d1, a1, d2, sc, P, N1, N2,
                        (cudaStream_t)stream);
}
