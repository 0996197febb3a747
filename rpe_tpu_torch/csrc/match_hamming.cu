// K3: Hamming mutual nearest neighbours of {0,1} descriptors, batched over
// pairs; and K6 in Hamming mode: per-row best, argbest and second-best
// distance for the Lowe ratio test (template flag TOP2).
//
// Replaces rpe_tpu/ops/match_pallas.py `_match_kernel` (:52, reached through
// `_mutual_nn` :180) and `_ratio_kernel` (:94, through `_row_top2` :111,
// norm="hamming"). Like them it takes the Gram product a.b on the matrix
// unit and uses popc(a ^ b) = |a| + |b| - 2 a.b: rows reduce |b| - 2 a.b and
// columns |a| - 2 a.b, and the constant term is restored after the
// reduction. Here the unit is Hopper's int8 tensor cores: the (P, N, 256)
// {0,1} bytes are u8 operands, K-major as 8-bit `wgmma` requires, and
// a.b <= 256 is exact in s32, so every distance is an exact integer.
//
// Bound on this card: operations. The chunk's 8 pairs of 4096 x 4096 are
// 2 * 256 operations per valid cell on the int8 tensor cores (1979 TOP/s
// dense): 0.0317 ms; its 16 MB of descriptors take 0.005 ms at 3.35 TB/s.
// What the design does about it:
// - Products: one CTA owns one (pair, 256-row tile): two consumer
//   warpgroups of 128 rows (two 64-row blocks each), one producer warp and
//   three helper warps. The A tile (64 KB) is loaded once; 128-column B
//   tiles (32 KB) stream through a ring of STAGES buffers, so each B byte
//   leaves L2 once per 256 rows: 128 MB for the chunk, which with 128-row
//   tiles was the limit. The producer issues TMA loads of
//   128-byte-swizzled boxes (a 256-byte descriptor is two boxes, one per K
//   half) completing on mbarriers; each consumer warpgroup runs sixteen
//   `wgmma.m64n128k32.s32.u8.u8` per tile, both operands read from shared
//   memory through 128-byte-swizzle descriptors. The warpgroups take turns
//   on the tensor cores, so one's epilogue overlaps the other's products,
//   and `setmaxnreg` moves the producer warpgroup's registers to them (two
//   64-register accumulators each). The chunk is 128 CTAs: one wave on 132
//   SMs.
// - Epilogue in registers, on 32-bit keys; it, not the products, bounds
//   the kernel (the integer units run 64 operations per clock per SM), so
//   a cell costs about three. The helper warps turn each descriptor of the
//   A tile, and of each B tile as it lands, into term = 2^31 | ((256 - |x|)
//   << 21) | (2^21 - 1 - index), or 0 when invalid or past the end, from
//   the tile in shared memory, while the products run (no prologue pass).
//   A row key is (dot << 22) + term_b: bit 31 marks a valid column, bits
//   21-30 hold 256 - |b| + 2 a.b = |a| + 256 - distance, the low bits the
//   column reversed, so the largest key is the
//   nearest column, the lowest on ties: one shift-add (LEA) per cell and a
//   three-way max (`__vimax3_u32`) per two cells. An invalid column's key
//   stays below 2^31, so it never wins (hence indices below 2^21). Columns
//   (K3) use term_a the same way; their maxima are reduced over the warp's
//   rows with shuffles, over warps with shared atomicMax, and leave the
//   CTA as one global atomicMax per column (on keys zeroed before the
//   launch), issued by the producer warp once the consumers release the
//   tile.
// - K6's second best is the second largest key of the row, so it is the
//   minimum distance over every other valid column and equals the best
//   when the best is tied at another index; an invalid row gives (_BIG, 0,
//   _BIG).
// - Canonical outputs as the reference's (`_mutual_nn`): best_d = _BIG and
//   index 0 for an invalid row or a row without valid columns; index 0 for
//   an invalid column or a column without valid rows.
// TMA, mbarrier and descriptor helpers: sm90.cuh.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"
#include "sm90.cuh"

#define ROWS 256                  // rows per CTA
#define TILE 128                  // columns per streamed tile
#define STAGES 4                  // B tiles in flight
#define KBYTES 256                // descriptor bytes: the product's depth
#define BOX_BYTES 128             // one TMA box: a K half, one swizzle span
#define NCONSUMER 256             // two consumer warpgroups
#define NTHREADS (NCONSUMER + 128)  // + a producer warp and three helper warps
#define NHELPER 96                // the helper warps' threads
#define IDX_MASK 0x1FFFFFu        // 21 index bits
#define VALID 0x80000000u         // keys below it carry no valid partner
#define BIG_F 3.0e38f

constexpr int HALF_BYTES = TILE * BOX_BYTES;        // one K half of a B tile
constexpr int TILE_BYTES = TILE * KBYTES;           // a B tile: 32 KB
constexpr int A_HALF = ROWS * BOX_BYTES;            // one K half of the A tile
constexpr int A_BYTES = ROWS * KBYTES;              // 64 KB
constexpr int SMEM_BYTES = 1024                     // alignment slack
                           + A_BYTES                // A
                           + STAGES * TILE_BYTES    // B ring
                           + 2 * STAGES * TILE * 4  // B terms, column maxima
                           + ROWS * 4               // A terms
                           + (3 * STAGES + 4) * 8;  // mbarriers

__device__ __forceinline__ void fence_acc(uint32_t (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 rows x 128 columns, s32) (+)= A (64 x 32 u8) . B (128 x 32 u8)^T
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "setp.ne.b32 p, %66, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// |x| of row r of a tile in shared memory ([2 K halves][rows][128 B]). The
// swizzle stores 16-byte chunk c of row r at c ^ (r % 8), so reading chunk
// c ^ (r % 8) in step c spreads the 8 rows of a quarter warp over all
// banks, and the row's sum ignores the order; each byte lane of s adds at
// most 64 ones.
__device__ __forceinline__ uint32_t row_ones(const uint8_t* tile, int half_bytes, int r) {
    uint32_t s = 0;
    // few loads in flight: the helpers run on 40 registers (setmaxnreg)
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
        const uint4* row = reinterpret_cast<const uint4*>(tile + h * half_bytes + r * BOX_BYTES);
#pragma unroll 4
        for (int c = 0; c < BOX_BYTES / 16; ++c) {
            const uint4 v = row[c ^ (r & 7)];
            s += v.x + v.y + v.z + v.w;
        }
    }
    return __dp4a(s, 0x01010101u, 0u);
}

// the key term of a valid descriptor i with `ones` set bits (see the header)
__device__ __forceinline__ uint32_t make_term(uint32_t ones, int i) {
    return VALID | ((256u - ones) << 21) | (IDX_MASK - (uint32_t)i);
}

// the producer's hand-off of one tile's column maxima to the global keys
__device__ __forceinline__ void flush_cols(uint32_t* scol, uint32_t* colkey, int N2,
                                           int col0, int lane) {
#pragma unroll
    for (int k = 0; k < TILE / 32; ++k) {
        const int c = lane + 32 * k;
        const uint32_t v = scol[c];
        scol[c] = 0u;
        if (v >= VALID && col0 + c < N2) atomicMax(colkey + col0 + c, v);
    }
}

template <bool TOP2>
__global__ void __launch_bounds__(NTHREADS, 1)
hamming_tc_kernel(const __grid_constant__ CUtensorMap map1,
                  const __grid_constant__ CUtensorMap map2,
                  const bool* __restrict__ valid1, const bool* __restrict__ valid2,
                  float* __restrict__ best_d, int* __restrict__ nn12,
                  float* __restrict__ second_d, uint32_t* __restrict__ colkey, int N1,
                  int N2) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint8_t* sA = smem;                                  // [2 halves][256 rows][128 B]
    uint8_t* sB = sA + A_BYTES;                          // [STAGES][2][128][128 B]
    uint32_t* sBterm = reinterpret_cast<uint32_t*>(sB + STAGES * TILE_BYTES);
    uint32_t* sCol = sBterm + STAGES * TILE;             // K3's per-tile column maxima
    uint32_t* sAterm = sCol + STAGES * TILE;
    uint64_t* bars = reinterpret_cast<uint64_t*>(sAterm + ROWS);
    // full: a B tile landed; ready: its terms are written; empty: the
    // consumers released it; afull / aready: the same of the A tile; turn:
    // one per warpgroup, its turn on the tensor cores
    const uint32_t full0 = smem_u32(bars), ready0 = smem_u32(bars + STAGES),
                   empty0 = smem_u32(bars + 2 * STAGES),
                   afull = smem_u32(bars + 3 * STAGES),
                   aready = smem_u32(bars + 3 * STAGES + 1),
                   turn0 = smem_u32(bars + 3 * STAGES + 2);

    const int tid = threadIdx.x;
    const int pair = blockIdx.y;
    const int row0 = blockIdx.x * ROWS;
    const int ntiles = (N2 + TILE - 1) / TILE;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(ready0 + 8 * s, NHELPER);
            mbar_init(empty0 + 8 * s, NCONSUMER);
        }
        mbar_init(afull, 1);
        mbar_init(aready, NHELPER);
        mbar_init(turn0, 1);
        mbar_init(turn0 + 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (!TOP2)
        for (int i = tid; i < STAGES * TILE; i += NTHREADS) sCol[i] = 0u;
    __syncthreads();

    if (tid >= NCONSUMER) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
        if (tid >= NCONSUMER + 32) {
            // ---- helpers: warps 1-3 of the last warpgroup write the terms
            // of the A tile (rows h + 96 k), then of each B tile as it lands
            // (columns h and h + 96). Each validity flag is loaded before
            // the wait, so its latency hides behind it; invalid rows and
            // rows past the end (TMA zero-filled) get 0 ----
            const int h = tid - (NCONSUMER + 32);
            const bool* v1 = valid1 + (size_t)pair * N1;
            const bool* v2 = valid2 + (size_t)pair * N2;
            bool ok[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const int i = row0 + h + NHELPER * k;
                ok[k] = h + NHELPER * k < ROWS && i < N1 && v1[i];
            }
            mbar_wait(afull, 0);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const int r = h + NHELPER * k;
                if (r < ROWS)
                    sAterm[r] = ok[k] ? make_term(row_ones(sA, A_HALF, r), row0 + r) : 0u;
            }
            mbar_arrive(aready);
            const int h1 = h + NHELPER;           // a second column for h < 32
            for (int t = 0; t < ntiles; ++t) {
                const int s = t % STAGES, i0 = t * TILE;
                const bool ok0 = i0 + h < N2 && v2[i0 + h];
                const bool ok1 = h1 < TILE && i0 + h1 < N2 && v2[i0 + h1];
                mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
                const uint8_t* b = sB + s * TILE_BYTES;
                uint32_t* bt = sBterm + s * TILE;
                bt[h] = ok0 ? make_term(row_ones(b, HALF_BYTES, h), i0 + h) : 0u;
                if (h1 < TILE)
                    bt[h1] = ok1 ? make_term(row_ones(b, HALF_BYTES, h1), i0 + h1) : 0u;
                mbar_arrive(ready0 + 8 * s);
            }
            return;
        }
        // ---- producer: the first warp of the last warpgroup ----
        const int lane = tid - NCONSUMER;
        uint32_t* ck = TOP2 ? nullptr : colkey + (size_t)pair * N2;
        if (lane == 0) {
            mbar_expect_tx(afull, A_BYTES);
            for (int h = 0; h < 2; ++h)
                tma_box(smem_u32(sA + h * A_HALF), &map1, afull, h * BOX_BYTES, row0, pair);
        }
        for (int t = 0; t < ntiles; ++t) {
            const int s = t % STAGES;
            if (t >= STAGES) {
                // the consumers released this stage's previous tile
                mbar_wait(empty0 + 8 * s, ((t / STAGES) - 1) & 1);
                if (!TOP2) flush_cols(sCol + s * TILE, ck, N2, (t - STAGES) * TILE, lane);
                __syncwarp();
            }
            if (lane == 0) {
                const uint32_t fb = full0 + 8 * s;
                mbar_expect_tx(fb, TILE_BYTES);
                for (int h = 0; h < 2; ++h)
                    tma_box(smem_u32(sB + s * TILE_BYTES + h * HALF_BYTES), &map2, fb,
                            h * BOX_BYTES, t * TILE, pair);
            }
        }
        if (!TOP2) {
            for (int t = ntiles > STAGES ? ntiles - STAGES : 0; t < ntiles; ++t) {
                const int s = t % STAGES;
                mbar_wait(empty0 + 8 * s, (t / STAGES) & 1);
                flush_cols(sCol + s * TILE, ck, N2, t * TILE, lane);
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg holds tile rows 128 wg .. 128 wg + 127
    // as two 64-row blocks mb, accumulated in acc[mb] ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    // a block's accumulator fragment: registers 4j + {0, 1} hold its row
    // 16 warp + lane / 4, columns 8j + 2 (lane % 4) + {0, 1}; registers
    // 4j + {2, 3} the same of the row 8 below. The thread's four rows are
    // indexed q = 2 mb + h: tile row r_lo + 64 mb + 8 h.
    const int r_lo = wg * 128 + warp * 16 + (lane >> 2);
    uint32_t acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0u;

    const uint32_t a_base = smem_u32(sA) + wg * (128 * BOX_BYTES);
    mbar_wait(afull, 0);
    mbar_wait(aready, 0);
    uint32_t rt[4], best[4], sec[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        rt[q] = sAterm[r_lo + 64 * (q >> 1) + 8 * (q & 1)];
        best[q] = sec[q] = 0u;
    }
    for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
        // the warpgroups take turns on the tensor cores (warpgroup 0 first),
        // so that one's epilogue overlaps the other's products
        if (wg == 1) mbar_wait(turn0 + 8, t & 1);
        else if (t > 0) mbar_wait(turn0, (t - 1) & 1);
        const uint32_t b_base = smem_u32(sB + s * TILE_BYTES);
        fence_acc(acc0);
        fence_acc(acc1);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < KBYTES / 32; ++ks) {
            const uint32_t k_off = (ks & 3) * 32;
            const uint64_t db = sw128_desc(b_base + (ks >> 2) * HALF_BYTES + k_off);
            const uint32_t a_off = a_base + (ks >> 2) * A_HALF + k_off;
            wgmma_u8(acc0, sw128_desc(a_off), db, ks > 0);
            wgmma_u8(acc1, sw128_desc(a_off + 64 * BOX_BYTES), db, ks > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if ((tid & 127) == 0) mbar_arrive(turn0 + 8 * (1 - wg));
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(acc0);
        fence_acc(acc1);
        mbar_wait(ready0 + 8 * s, (t / STAGES) & 1);

        const uint32_t* bt = sBterm + s * TILE;
        uint32_t colp[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const uint2 ct = *reinterpret_cast<const uint2*>(bt + 8 * j + 2 * (lane & 3));
            // row q = 2 mb + h: columns 8j + 2 (lane % 4) + {0, 1}
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = 4 * j + 2 * (q & 1);
                const uint32_t k0 = (((q >> 1) ? acc1[r] : acc0[r]) << 22) + ct.x;
                const uint32_t k1 = (((q >> 1) ? acc1[r + 1] : acc0[r + 1]) << 22) + ct.y;
                if (TOP2) {
                    const uint32_t hi = max(k0, k1), lo = min(k0, k1);
                    sec[q] = __vimax3_u32(sec[q], lo, min(best[q], hi));
                    best[q] = max(best[q], hi);
                } else {
                    best[q] = __vimax3_u32(best[q], k0, k1);
                }
            }
            if (!TOP2) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const uint32_t c0 = (acc0[4 * j + e] << 22) + rt[0];
                    const uint32_t c1 = (acc0[4 * j + 2 + e] << 22) + rt[1];
                    const uint32_t c2 = (acc1[4 * j + e] << 22) + rt[2];
                    const uint32_t c3 = (acc1[4 * j + 2 + e] << 22) + rt[3];
                    colp[2 * j + e] = __vimax3_u32(c0, c1, max(c2, c3));
                }
            }
        }
        if (!TOP2) {
            // reduce-scatter (max) over the 8 lanes that hold the same 32 columns
            // (lane bits 2-4): afterwards lane l holds fragment columns
            // q = 4 (l >> 2) + k, k < 4, reduced over the warp's 32 rows
            const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                const uint32_t send = b4 ? colp[k] : colp[k + 16];
                const uint32_t keep = b4 ? colp[k + 16] : colp[k];
                colp[k] = max(keep, __shfl_xor_sync(0xffffffffu, send, 16));
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const uint32_t send = b3 ? colp[k] : colp[k + 8];
                const uint32_t keep = b3 ? colp[k + 8] : colp[k];
                colp[k] = max(keep, __shfl_xor_sync(0xffffffffu, send, 8));
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uint32_t send = b2 ? colp[k] : colp[k + 4];
                const uint32_t keep = b2 ? colp[k + 4] : colp[k];
                colp[k] = max(keep, __shfl_xor_sync(0xffffffffu, send, 4));
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int q = 4 * (lane >> 2) + k;     // q = 2 j + e
                const int c = 8 * (q >> 1) + 2 * (lane & 3) + (q & 1);
                if (colp[k] >= VALID) atomicMax(sCol + s * TILE + c, colp[k]);
            }
        }
        mbar_arrive(empty0 + 8 * s);
    }

    // the 4 lanes of a quad hold disjoint columns of the same rows
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint32_t o = __shfl_xor_sync(0xffffffffu, best[q], off);
            if (TOP2) {
                const uint32_t so = __shfl_xor_sync(0xffffffffu, sec[q], off);
                sec[q] = __vimax3_u32(sec[q], so, min(best[q], o));
            }
            best[q] = max(best[q], o);
        }
    }
    if ((lane & 3) == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int i = row0 + r_lo + 64 * (q >> 1) + 8 * (q & 1);
            if (i >= N1) continue;
            // distance = |a| + 256 - key field, |a| = 256 - the row term's field
            const bool rv = rt[q] >= VALID;
            const int base = 512 - (int)((rt[q] >> 21) & 1023u);
            const bool ok = rv && best[q] >= VALID;
            const size_t o = (size_t)pair * N1 + i;
            best_d[o] = ok ? (float)(base - (int)((best[q] >> 21) & 1023u)) : BIG_F;
            nn12[o] = ok ? (int)(IDX_MASK - (best[q] & IDX_MASK)) : 0;
            if (TOP2)
                second_d[o] = (rv && sec[q] >= VALID)
                                  ? (float)(base - (int)((sec[q] >> 21) & 1023u))
                                  : BIG_F;
        }
    }
}

// K3's column keys -> nn21, with the canonical 0 for an invalid column or a
// column without valid rows
__global__ void finalize_cols32(const uint32_t* __restrict__ colkey,
                                const bool* __restrict__ valid2, int* __restrict__ nn21,
                                int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t k = colkey[i];
    nn21[i] = (valid2[i] && k >= VALID) ? (int)(IDX_MASK - (k & IDX_MASK)) : 0;
}

// (P, N, 256) bytes as 128-byte x `rows` boxes, 128-byte swizzle; rows
// past N read as zeros
static int tensor_map(CUtensorMap* map, const uint8_t* bits, int P, int N, int rows) {
    return tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bits, KBYTES, N, P,
                         BOX_BYTES, rows);
}

// the main kernel (K3's column keys are zeroed by the caller)
template <bool TOP2>
static int launch(const uint8_t* bits1, const uint8_t* bits2, const bool* valid1,
                  const bool* valid2, float* best_d, int* nn12, float* second_d,
                  uint32_t* colkey, int P, int N1, int N2, cudaStream_t s) {
    if (P * N1 == 0) return 0;
    CUtensorMap map1, map2;
    int rc = tensor_map(&map1, bits1, P, N1, ROWS);
    if (rc == 0 && N2 > 0) rc = tensor_map(&map2, bits2, P, N2, TILE);
    else if (rc == 0) map2 = map1;      // no column tiles: never read
    if (rc != 0) return rc;
    static unsigned long long attr_set = 0ull;  // per device, as the attribute
    rc = smem_attr_per_device(hamming_tc_kernel<TOP2>, SMEM_BYTES, attr_set);
    if (rc != 0) return rc;
    hamming_tc_kernel<TOP2><<<dim3((N1 + ROWS - 1) / ROWS, P), NTHREADS, SMEM_BYTES, s>>>(
        map1, map2, valid1, valid2, best_d, nn12, second_d, colkey, N1, N2);
    return (int)cudaGetLastError();
}

extern "C" int match_hamming_launch(const uint8_t* bits1, const uint8_t* bits2,
                                    const bool* valid1, const bool* valid2,
                                    float* best_d, int* nn12, int* nn21, uint32_t* colkey,
                                    int P, int N1, int N2, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int ncol = P * N2;
    if (ncol == 0) return launch<false>(bits1, bits2, valid1, valid2, best_d, nn12,
                                        nullptr, colkey, P, N1, N2, s);
    cudaError_t e = cudaMemsetAsync(colkey, 0, (size_t)ncol * sizeof(uint32_t), s);
    if (e != cudaSuccess) return (int)e;
    int rc = launch<false>(bits1, bits2, valid1, valid2, best_d, nn12, nullptr, colkey, P,
                           N1, N2, s);
    if (rc != 0) return rc;
    finalize_cols32<<<(ncol + 255) / 256, 256, 0, s>>>(colkey, valid2, nn21, ncol);
    return (int)cudaGetLastError();
}

extern "C" int row_top2_hamming_launch(const uint8_t* bits1, const uint8_t* bits2,
                                       const bool* valid1, const bool* valid2, float* d1,
                                       int* a1, float* d2, int P, int N1, int N2,
                                       void* stream) {
    return launch<true>(bits1, bits2, valid1, valid2, d1, a1, d2, nullptr, P, N1, N2,
                        (cudaStream_t)stream);
}
