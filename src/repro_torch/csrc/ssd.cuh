// Tile helpers of the SSD scan's bf16 Hopper kernels (ssd.cu, ssd_bwd.cu):
// 64 x 64 bf16 tiles of 128-byte rows in TMA's 128-byte swizzle, their
// cp.async fill for views a tensor map cannot describe, 8 x 8 matrix moves
// between such tiles and the mma fragment layout, and bf16 pair unpacking.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int kTileRows = 64;            // rows of a tile (one chunk)
constexpr int kTileRow = 128;            // bytes of a swizzled row: 64 bf16
constexpr int kTileBytes = kTileRows * kTileRow;   // 8 KB
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of element (r, col) in a swizzled tile of 64-element rows
// (TMA's 128-byte swizzle: 16-byte chunk col / 8 stored at chunk ^ r % 8)
__device__ __forceinline__ int swz(int r, int col) {
  return r * kTileRow + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) << 1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// One 64 x 64 tile of a bf16 tensor by the block's kThreads threads: rows
// r < rows at `src + r * ld`, columns c < cols; zeros elsewhere.  Thread t
// copies column pair 2 (t % 32) of rows t / 32 + (kThreads / 32) k: 4-byte
// cp.async where the source allows, 2-byte loads elsewhere.
template <int kThreads>
__device__ __forceinline__ void fetch_tile(uint8_t* dst,
                                           const unsigned short* src,
                                           long long ld, int rows, int cols) {
  const int c = 2 * (threadIdx.x % 32);
  for (int r = threadIdx.x / 32; r < kTileRows; r += kThreads / 32) {
    uint8_t* d = dst + swz(r, c);
    const unsigned short* p = src + r * ld + c;
    if (r < rows && c + 1 < cols && ((uintptr_t)p & 3) == 0) {
      cp_async4(d, p);
    } else {
      const uint32_t lo = r < rows && c < cols ? p[0] : 0u;
      const uint32_t hi = r < rows && c + 1 < cols ? p[1] : 0u;
      *reinterpret_cast<uint32_t*>(d) = lo | (hi << 16);
    }
  }
}

// Four 8 x 8 bf16 matrices from registers (the mma fragment layout) into
// shared memory transposed: lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void stmatrix_t(uint32_t addr, uint32_t r0,
                                           uint32_t r1, uint32_t r2,
                                           uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, transposed, into the mma
// fragment layout: lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t pair) {
  return __uint_as_float(pair << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

}  // namespace
