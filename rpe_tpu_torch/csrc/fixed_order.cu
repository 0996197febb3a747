// P2: fixed-order batched products and row sums for the geometry layer.
//
// No TPU kernel of its own: on the TPU the reference's small batched
// products (the 8-point and DLT normal matrices over the matches, the
// refits' and pose recovery's small matrix products) are XLA's dots. On
// this card the plain versions are cuBLAS's batched GEMMs and PyTorch's
// reductions, which choose their kernel -- a split of the sum over k across
// threads or blocks, and so its summation order -- by the batch size: the
// same pair got other bits in a chunk of another size. Here every output
// element is summed by one thread over k in ascending order, whatever the
// batch:
//
//   C[b, i, j] = sum_k A[b, i, k] * B[b, k, j]      (product)
//   C[b, i]    = sum_k A[b, i, k]                   (row sum)
//   C[b, i, j] = sum_k A[b, i, k] * I[b, k, j],     (chain, U (D Vt):
//   I[b, k, j] = f32(sum_p A2[b, k, p] * B[b, p, j]) I rounded as a
//                                                    product of its own)
//
// b runs over up to four batch dimensions, each with its own stride in
// every operand (0 where an operand broadcasts); the operands may be any
// strided view, C is contiguous. The sum is carried in float64 and rounded
// once to float32: a product of two float32 values is exact in float64, so
// each output is f32(sum over k ascending of f64(a) f64(b)), which a
// serial float64 loop over k reproduces bit for bit
// (tests/torch_judges.py `p2_serial`).
//
// One launch takes a group of up to four such jobs (the products one
// function forms from operands that are ready together: E v0 and E v1,
// the two rotations U W Vt and U W^T Vt, ...), each with its own blocks.
// A block owns a tile of a job's problems (batch elements): it stages
// their operands' k rows into shared memory with cp.async, a pass of `kc`
// rows while the thread of each output sums the pass before, so the
// serial float64 chain of a long k (the normal matrices' 500-1000
// matches) runs on shared memory and not on dependent loads through L1.
// A tile holds one problem where there are few (8 normal matrices of
// k = 1000 take 8 blocks) and up to 256 outputs where there are many
// (28 3 x 3 products a block).
//
// Bound on this card: the geometry's shapes are small (9 x 9 outputs over
// 500-1000 matches per pair and hypothesis set, 3 x 3 products) and the
// calls are launch-bound, hence the groups; otherwise bytes (each operand
// read once).

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_JOBS = 4;
constexpr int BUF = 4096;           // floats per staging buffer (two)

}  // namespace

// One job of a group: operand strides (elements), shapes and the tiling
// the wrapper chose (geometry/_products.py `_job`).
struct Job {
    long long sa[4], sb[4], s2[4];  // batch strides of A, B and A2
    long long sam, sak;             // A (m x k): row and k strides
    long long sbk, sbn;             // B (k x n, or k2 x n): row, column
    long long s2k, s2p;             // A2 (k x k2): row and column strides
    long long nb[4];                // batch sizes, outermost first
    long long m, n, k, k2;          // k2 > 0 only for a chain
    long long problems;             // nb[0] * nb[1] * nb[2] * nb[3]
    int ppb;                        // problems per block
    int kc;                         // k rows staged per pass
    int mode;                       // 0 product, 1 row sum, 2 chain
    int blocks;                     // this job's blocks
};

struct GroupArgs {
    Job job[MAX_JOBS];
    int njobs;
};

namespace {

struct Params {
    GroupArgs g;
    const float* a[MAX_JOBS];
    const float* b[MAX_JOBS];
    const float* a2[MAX_JOBS];
    float* c[MAX_JOBS];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [k0, k0 + kn) of np problems' operand X (rows x cols,
// element (r, c) at off[p] + r * sr + c * sc) into dst[p * per + r * cols
// + c], walking X in the order of its smaller stride so that neighbouring
// threads read neighbouring addresses.
__device__ __forceinline__ void stage(float* dst, const float* x,
                                      const long long* off, int np, int per,
                                      long long k0, int kn, int cols,
                                      long long sr, long long sc) {
    const int each = kn * cols, total = np * each;
    const bool rows_inner = sr < sc;
    for (int e = threadIdx.x; e < total; e += THREADS) {
        const int p = e / each, rem = e - p * each;
        int r, c;
        if (rows_inner) {
            c = rem / kn;
            r = rem - c * kn;
        } else {
            r = rem / cols;
            c = rem - r * cols;
        }
        cp_async4(dst + p * per + r * cols + c,
                  x + off[p] + (k0 + r) * sr + c * sc);
    }
}

__global__ void __launch_bounds__(THREADS)
group_bmm_kernel(const __grid_constant__ Params P) {
    __shared__ __align__(16) float buf[2][BUF];
    __shared__ long long s_oa[THREADS], s_ob[THREADS], s_o2[THREADS];
    int bid = blockIdx.x, jb = 0;
    while (jb + 1 < P.g.njobs && bid >= P.g.job[jb].blocks) {
        bid -= P.g.job[jb].blocks;
        ++jb;
    }
    const Job& g = P.g.job[jb];
    const float* __restrict__ A = P.a[jb];
    const float* __restrict__ B = P.b[jb];
    const float* __restrict__ A2 = P.a2[jb];
    const long long p0 = (long long)bid * g.ppb;
    const int np = (int)min((long long)g.ppb, g.problems - p0);
    for (int t = threadIdx.x; t < np; t += THREADS) {
        long long r = p0 + t, oa = 0, ob = 0, o2 = 0;
#pragma unroll
        for (int d = 3; d >= 0; --d) {
            const long long bd = r % g.nb[d];
            r /= g.nb[d];
            oa += bd * g.sa[d];
            ob += bd * g.sb[d];
            o2 += bd * g.s2[d];
        }
        s_oa[t] = oa;
        s_ob[t] = ob;
        s_o2[t] = o2;
    }
    __syncthreads();
    const int m = (int)g.m, n = (int)g.n, mn = m * n;
    const int pl = threadIdx.x / mn, e = threadIdx.x - pl * mn;
    const int i = e / n, j = e - (e / n) * n;
    const bool active = pl < np;
    double acc = 0.0;
    if (g.mode == 2) {
        // chain: A (k x m as staged), A2 (k x k2), B (k2 x n), then I
        const int k = (int)g.k, k2 = (int)g.k2;
        const int oA2 = k * m, oB = oA2 + k * k2, oI = oB + k2 * n;
        const int per = oI + k * n;
        float* s = buf[0];
        stage(s, A, s_oa, np, per, 0, k, m, g.sak, g.sam);
        stage(s + oA2, A2, s_o2, np, per, 0, k, k2, g.s2k, g.s2p);
        stage(s + oB, B, s_ob, np, per, 0, k2, n, g.sbk, g.sbn);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int x = threadIdx.x; x < np * k * n; x += THREADS) {
            const int p = x / (k * n), rem = x - p * (k * n);
            const int q = rem / n, jj = rem - q * n;
            const float* a2 = s + p * per + oA2 + q * k2;
            const float* b = s + p * per + oB + jj;
            double t = 0.0;
            for (int u = 0; u < k2; ++u)
                t = fma((double)a2[u], (double)b[u * n], t);
            s[p * per + oI + q * n + jj] = (float)t;
        }
        __syncthreads();
        if (active) {
            const float* a = s + pl * per + i;
            const float* b = s + pl * per + oI + j;
            for (int q = 0; q < k; ++q)
                acc = fma((double)a[q * m], (double)b[q * n], acc);
        }
    } else {
        const bool prod = g.mode == 0;
        const int kc = g.kc, per = kc * (m + (prod ? n : 0));
        const long long K = g.k;
        const int passes = (int)((K + kc - 1) / kc);
        auto load = [&](int pass) {
            const long long k0 = (long long)pass * kc;
            const int kn = (int)min((long long)kc, K - k0);
            float* s = buf[pass & 1];
            stage(s, A, s_oa, np, per, k0, kn, m, g.sak, g.sam);
            if (prod)
                stage(s + kc * m, B, s_ob, np, per, k0, kn, n, g.sbk, g.sbn);
            cp_async_commit();
        };
        if (passes > 0) load(0);
        for (int pass = 0; pass < passes; ++pass) {
            if (pass + 1 < passes) {
                load(pass + 1);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const int kn = (int)min((long long)kc, K - (long long)pass * kc);
            const float* a = buf[pass & 1] + pl * per + i;
            if (active) {
                if (prod) {
                    const float* b = buf[pass & 1] + pl * per + kc * m + j;
                    for (int q = 0; q < kn; ++q)
                        acc = fma((double)a[q * m], (double)b[q * n], acc);
                } else {
                    for (int q = 0; q < kn; ++q) acc += (double)a[q * m];
                }
            }
            __syncthreads();            // the buffer is refilled next pass
        }
    }
    if (active) P.c[jb][(p0 + pl) * mn + e] = (float)acc;
}

}  // namespace

// A group of g->njobs jobs, one launch; a[j], b[j], a2[j], c[j] job j's
// operands and output (b null for a row sum, a2 null but for a chain).
// `g` is read on the host and passed by value.
extern "C" int fixed_order_group_launch(
        const GroupArgs* g, const float* a0, const float* b0,
        const float* x0, float* c0, const float* a1, const float* b1,
        const float* x1, float* c1, const float* a2, const float* b2,
        const float* x2, float* c2, const float* a3, const float* b3,
        const float* x3, float* c3, void* stream) {
    if (g->njobs < 1 || g->njobs > MAX_JOBS) return (int)cudaErrorInvalidValue;
    Params P;
    P.g = *g;
    const float* as[] = {a0, a1, a2, a3};
    const float* bs[] = {b0, b1, b2, b3};
    const float* xs[] = {x0, x1, x2, x3};
    float* cs[] = {c0, c1, c2, c3};
    long long blocks = 0;
    for (int j = 0; j < g->njobs; ++j) {
        const Job& q = g->job[j];
        const long long mn = q.m * q.n;
        const bool chain = q.mode == 2;
        const long long per = chain
            ? q.k * q.m + q.k * q.k2 + q.k2 * q.n + q.k * q.n
            : q.kc * (q.m + (q.mode == 0 ? q.n : 0));
        if (mn < 1 || q.ppb < 1 || q.ppb * mn > THREADS || q.ppb > THREADS
                || q.ppb * per > BUF || (!chain && q.kc < 1)
                || q.mode < 0 || q.mode > 2 || (q.mode == 1 && q.n != 1)
                || (chain) != (xs[j] != nullptr)
                || (q.mode == 1) != (bs[j] == nullptr)
                || q.blocks != (q.problems + q.ppb - 1) / q.ppb)
            return (int)cudaErrorInvalidValue;
        P.a[j] = as[j];
        P.b[j] = bs[j];
        P.a2[j] = xs[j];
        P.c[j] = cs[j];
        blocks += q.blocks;
    }
    if (blocks <= 0) return 0;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    group_bmm_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(P);
    return (int)cudaGetLastError();
}

// The size of GroupArgs and the kernel's limits, so the wrapper can hold
// its ctypes layout and its tiling to the source's.
extern "C" int fixed_order_args_size() { return (int)sizeof(GroupArgs); }
extern "C" int fixed_order_threads() { return THREADS; }
extern "C" int fixed_order_buffer() { return BUF; }
