// Hopper building blocks shared by the tensor-core matchers (match_hamming.cu,
// match_l2.cu): shared-memory addresses, mbarriers, TMA box loads, the
// 128-byte-swizzle `wgmma` operand descriptor and the host-side tensor map.
//
// The tensor maps come from `cuTensorMapEncodeTiled`, reached through the
// runtime's `cudaGetDriverEntryPointByVersion` (no libcuda at link time).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// one box of a 3-D tensor map at coordinates (x, y, z), completing on `bar`
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int x, int y, int z) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
        : "memory");
}

// K-major operand in 8-row x 128-byte swizzled atoms, as TMA writes them:
// start address >> 4, leading offset unused (1), 1024 bytes between atoms,
// layout SWIZZLE_128B
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A (z, y, x) row-major tensor of `elem`-byte values as a 3-D tensor map of
// (box_x, box_y, 1) boxes with 128-byte swizzle (box_x * elem = 128); rows
// past y read as zeros. Returns 0 or a cudaError_t.
static int tensor_map_3d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                         const void* base, uint64_t x, uint64_t y, uint64_t z, int box_x,
                         int box_y) {
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                                         12000, cudaEnableDefault, &q);
#else
        cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
        if (e != cudaSuccess) return (int)e;
        if (q != cudaDriverEntryPointSuccess || fn == nullptr)
            return (int)cudaErrorSymbolNotFound;
        encode = (EncodeTiled)fn;
    }
    const cuuint64_t dims[3] = {x, y, z};
    const cuuint64_t strides[2] = {x * elem, x * y * elem};
    const cuuint32_t box[3] = {(cuuint32_t)box_x, (cuuint32_t)box_y, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Allow `kernel` `bytes` of dynamic shared memory (above the default 48 KB)
// on the current device. The attribute is per device, so `done` keeps one
// bit per device it was set on (devices past 63 set it on every call).
// Returns 0 or a cudaError_t.
template <typename Kernel>
static int smem_attr_per_device(Kernel kernel, int bytes, unsigned long long& done) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64 && (done >> dev & 1ull)) return 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) done |= 1ull << dev;
    return 0;
}
