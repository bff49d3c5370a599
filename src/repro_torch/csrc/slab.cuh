// The shared-weight kernels' slab loader: how a CTA's block of rows and
// columns of a row-major plane (weights, or a rule's four planes viewed as
// (4 N, M)) reaches shared memory and leaves it.  Shared by the rollout
// window (rollout_shared.cu) and the per-step kernels (shared_step.cu): 2-D
// TMA boxes on an mbarrier where the 16-byte rules hold, else cp.async of
// the widest piece the alignment allows (zeros past the owned columns), or
// of the 4-byte words covering each row's span; write-back by vector stores
// of the route's width.  The kernels' plans (fused.py shared_route,
// kernel.py step_route) pick each plane's route.
#pragma once

#include <cstring>

#include "hopper.cuh"
#include "plasticity.cuh"

namespace {

// How a plane reaches shared memory (fused.py ROUTES, kernel.py
// STEP_ROUTES): a TMA box, cp.async pieces, cp.async of the 4-byte words
// covering each row's span (repacked), through L2 (not staged by the copy
// engines), none (a frozen layer's rule), or one 1-D bulk copy of a
// contiguous block.
enum Route { kTma = 0, kCpAsync = 1, kWords = 2, kL2 = 3, kNone = 4,
             kBulk = 5 };

// One box {c columns, rows} of a 2-D map at (col, row); completion is
// reported to `bar` in bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
         "r"(row)
      : "memory");
}

// ---- cp.async -----------------------------------------------------------
// `src_bytes` < `width` zero-fills the rest (0: nothing is read).
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int width, int src_bytes) {
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Byte offset in device memory of element (r, col) of a row-major plane.
__device__ __forceinline__ const unsigned char* at(const void* base, int r,
                                                   int m, int col, int e) {
  return (const unsigned char*)base + ((long)r * m + col) * e;
}

// The owned block [0, rows) x [col0, col0 + own) of a row-major (rows, m)
// plane of `e`-byte elements, by cp.async: kCpAsync copies pieces of
// `width` bytes into dst[rows][c] (zeros past `own`); kWords copies the
// 4-byte words covering each row's span into rows of `pitch` bytes (the
// span starts at byte (address & 3) of its row).  Issued by threads
// [0, nt) (every thread where nt is 0).
__device__ void copy_async(unsigned char* dst, const void* src, int rows,
                           int m, int c, int own, int col0, int e, int route,
                           int width, int pitch, int nt = 0) {
  if (nt == 0) nt = blockDim.x;
  if (route == kCpAsync) {
    const int per_row = c * e / width, own_pieces = own * e / width;
    for (int o = threadIdx.x; o < rows * per_row; o += nt) {
      const int r = o / per_row, p = o - r * per_row;
      const unsigned char* row = at(src, r, m, col0, e);
      cp_async(smem_u32(dst + (long)o * width),
               p < own_pieces ? row + p * width : row, width,
               p < own_pieces ? width : 0);
    }
  } else {
    const int words = pitch / 4;
    for (int o = threadIdx.x; o < rows * words; o += nt) {
      const int r = o / words, q = o - r * words;
      const uintptr_t start = (uintptr_t)at(src, r, m, col0, e);
      const uintptr_t first = start & ~(uintptr_t)3, word = first + 4 * q;
      const uintptr_t end = start + (uintptr_t)own * e;
      const int bytes = word >= end ? 0 : end - word >= 4 ? 4
                                                          : (int)(end - word);
      cp_async(smem_u32(dst + (long)r * pitch + 4 * q),
               (const void*)(bytes ? word : first), 4, bytes);
    }
  }
}

// Vector stores of the owned block from src[rows][c] (e-byte elements) to
// a row-major (rows, m) plane, `width` bytes a piece.
__device__ void store_pieces(void* dst, const unsigned char* src, int rows,
                             int m, int c, int own, int col0, int e,
                             int width) {
  const int per_row = c * e / width, own_pieces = own * e / width;
  for (int o = threadIdx.x; o < rows * per_row; o += blockDim.x) {
    const int r = o / per_row, p = o - r * per_row;
    if (p >= own_pieces) continue;
    unsigned char* g = (unsigned char*)at(dst, r, m, col0, e) + p * width;
    const unsigned char* s = src + (long)o * width;
    if (width == 16) *(uint4*)g = *(const uint4*)s;
    else if (width == 8) *(uint2*)g = *(const uint2*)s;
    else *(uint32_t*)g = *(const uint32_t*)s;
  }
}

// Loads and stores of V consecutive elements as one access.
template <int Bytes> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = unsigned; };
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<1> { using T = unsigned char; };

template <int V, typename X>
__device__ __forceinline__ void ld_vec(X* dst, const X* src) {
  using R = typename Raw<V * sizeof(X)>::T;
  const R raw = *reinterpret_cast<const R*>(src);
  memcpy(dst, &raw, sizeof(R));
}

template <int V, typename X>
__device__ __forceinline__ void st_vec(X* dst, const X* src) {
  using R = typename Raw<V * sizeof(X)>::T;
  R raw;
  memcpy(&raw, src, sizeof(R));
  *reinterpret_cast<R*>(dst) = raw;
}

// A 2-D map over a row-major (rows, m) plane of `e`-byte elements, boxes of
// {c columns, box rows}, zeros outside the plane.
bool encode(CUtensorMap* map, const void* ptr, int rows, int m, int e, int c,
            int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type =
      e == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
             : e == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)m * e};
  const cuuint32_t boxes[2] = {(cuuint32_t)c, (cuuint32_t)box};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, boxes, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
