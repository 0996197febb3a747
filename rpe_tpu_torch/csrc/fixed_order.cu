// P2: fixed-order batched products and row sums for the geometry layer.
//
// No TPU kernel of its own: on the TPU the reference's small batched
// products (the 8-point and DLT normal matrices over the matches, the
// refits' and pose recovery's small matrix products) are XLA's dots. On
// this card the plain versions are cuBLAS's batched GEMMs and PyTorch's
// reductions, which choose their kernel -- a split of the sum over k across
// threads or blocks, and so its summation order -- by the batch size: the
// same pair got other bits in a chunk of another size. Here one thread owns
// one output element and sums k in ascending order, whatever the batch.
//
//   C[b, i, j] = sum_k A[b, i, k] * B[b, k, j]      (product mode)
//   C[b, i]    = sum_k A[b, i, k]                   (row-sum mode, B null)
//
// b runs over up to four batch dimensions, each with its own stride in A
// and in B (0 where an operand broadcasts); A and B may be any strided
// view, C is contiguous. The sum is carried in float64 and rounded once to
// float32, so that the fixed order costs no accuracy against the library's
// blocked float32 sums (chip_smoke.py holds the two within 1e-6 of
// sum_k |a| |b| per element).
//
// Bound on this card: the geometry's shapes are small (9 x 9 outputs over
// 500 matches per pair and hypothesis set, 3 x 3 products) and the calls
// are launch-bound; otherwise bytes (each operand read once: A read by
// every j, B by every i, from L1/L2).

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

struct BmmArgs {
    long long sa[4];     // A's batch strides (elements)
    long long sb[4];     // B's batch strides
    long long sam, sak;  // A's row and k strides
    long long sbk, sbn;  // B's k and column strides
    long long nb[4];     // batch sizes, outermost first
    long long m, n, k;
};

__global__ void __launch_bounds__(256)
bmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ c, BmmArgs g, long long total) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const long long j = idx % g.n;
    long long r = idx / g.n;
    const long long i = r % g.m;
    r /= g.m;
    long long oa = i * g.sam, ob = j * g.sbn;
#pragma unroll
    for (int d = 3; d >= 0; --d) {
        const long long bd = r % g.nb[d];
        r /= g.nb[d];
        oa += bd * g.sa[d];
        ob += bd * g.sb[d];
    }
    double acc = 0.0;
    if (b == nullptr) {
        for (long long q = 0; q < g.k; ++q) acc += (double)a[oa + q * g.sak];
    } else {
        for (long long q = 0; q < g.k; ++q)
            acc = fma((double)a[oa + q * g.sak], (double)b[ob + q * g.sbk], acc);
    }
    c[idx] = (float)acc;
}

// C (nb0 * nb1 * nb2 * nb3, m, n) contiguous; b may be null (row sums,
// n = 1). `g` is read on the host and passed by value.
extern "C" int fixed_order_bmm_launch(const float* a, const float* b, float* c,
                                      const BmmArgs* g, void* stream) {
    const long long total = g->nb[0] * g->nb[1] * g->nb[2] * g->nb[3] * g->m * g->n;
    if (total <= 0) return 0;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    bmm_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a, b, c,
                                                                       *g, total);
    return (int)cudaGetLastError();
}

// The size of BmmArgs, so the wrapper can hold its ctypes layout to it.
extern "C" int fixed_order_args_size() { return (int)sizeof(BmmArgs); }
