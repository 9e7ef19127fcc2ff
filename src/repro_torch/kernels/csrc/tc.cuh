// Tensor-core building blocks shared by the bf16 routes of K1, K2 and K3:
// 16-byte cp.async copies into shared memory (with zero-fill), ldmatrix
// loads of mma fragments, and mma.sync.m16n8k16 with bf16 operands and f32
// accumulators.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), as the PTX ISA defines them:
//   A (16 x 16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                      a3 (g+8, 2t+8..), two bf16 per register;
//   B (16 x 8, col):   b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8.., n = g);
//   C (16 x 8, f32):   c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1).
// The C layout of two neighbouring n-tiles is the A layout of one k-step,
// so a product's result feeds the next product without shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarrier in shared memory that completes a phase after ``count`` arrivals
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// one arrival on ``bar`` once every cp.async this thread issued so far has
// landed (the arrival is counted in the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
      smem_addr(bar)));
}

// wait until the phase of ``bar`` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b, one m16n8k16 product.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two f32 rounded to bf16 and packed (x in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return pack(__float2bfloat16(x), __float2bfloat16(y));
}

// the split v = hi + lo of two f32 values: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16(x), hy = __float2bfloat16(y);
  hi = pack(hx, hy);
  lo = pack_bf16(x - __bfloat162float(hx), y - __bfloat162float(hy));
}

// Set a kernel attribute once per device, at the kernel's first launch
// there; later launches (those captured into a CUDA graph among them) skip
// the call. ``done`` holds one bit per device ordinal.
inline cudaError_t set_attr_once(const void* kernel, cudaFuncAttribute attr,
                                 int value,
                                 std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// Raise a kernel's dynamic shared-memory limit once per device.
inline cudaError_t set_smem_once(const void* kernel, size_t bytes,
                                 std::atomic<unsigned long long>& done) {
  return set_attr_once(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes), done);
}

}  // namespace tc
