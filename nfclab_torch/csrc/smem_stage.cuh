// Staging samples into shared memory on Hopper (sm_90): mbarriers in
// shared memory and cp.async copies that arrive on them.
// Shared by the scans that stage their input (ff_scan_kernel,
// v2_scan_kernel), the probes that hand their envelope from one warp to
// another (serial_probe_kernel, pair_probe_kernel) and the two masks, which
// stage their lookback rows (v2_mask_kernel, ff_mask_kernel).

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void *p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t *bar)
{
    asm volatile("{\n\t.reg .b64 st;\n\t"
                 "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity)
{
    uint32_t done;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

__device__ __forceinline__ void cp_async16(float *dst, const float *src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float *dst, const float *src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// the mbarrier counts one arrival of this thread once all of its earlier
// cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t *bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

