// Shared pieces of the probe kernels (flash_probe.cu, int8_qk.cu): the
// tiles of the flash kernel K1 (csrc/flash_attention.cu) at the probes'
// head dim D = 32, and the few PTX wrappers K1 does not need (the ones
// column's m64n8k16, the int8 products). Raw PTX for sm_90a, as
// ../hopper.cuh; no CUDA header beyond the runtime.
#pragma once

#include "../hopper.cuh"

#include <math.h>
#include <stdint.h>

namespace said {
namespace probe {

constexpr int kD = 32;  // the probes' head dim (the UNet's)
constexpr float kLn2 = 0.69314718055994530942f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d^-1/2 · log2(e) at D = 32 in double, rounded to f32: K1's Q scale
static inline float q_scale() { return (float)(pow((double)kD, -0.5) * 1.4426950408889634); }

// ------------------------------------------------ f32: K1's 3xTF32 tiles

constexpr int kF32Rows = 64;  // 4 warps × 16 query rows
constexpr int kF32Keys = 64;  // keys per staged tile
constexpr int kF32Threads = 128;
constexpr int kF32Stride = kD + 4;  // floats per staged row: 16 bytes of pad
constexpr int kF32Tile = kF32Keys * kF32Stride;
constexpr size_t kF32Smem = sizeof(float) * 4 * kF32Tile;  // two stages of K and V: 36,864 bytes

// ------------------------------------------------- bf16: K1's wgmma tiles

constexpr int kRows = 64;     // one warpgroup: wgmma's 64-row tile
constexpr int kKeys = 128;    // keys per staged tile: S is m64n128
constexpr int kThreads = 128;
constexpr int kRowBytes = kD * 2;          // 64-byte rows under the 64-byte swizzle
constexpr uint32_t kSwizzle = 2;
constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: the stride byte offset
constexpr int kRowChunks = kRowBytes / 16;
constexpr int kQBytes = kRows * kRowBytes;
constexpr int kTileBytes = kKeys * kRowBytes;
constexpr int kOnesBytes = 1024;  // the ones column's B operand (every element 1)

// a 1024-byte aligned base inside the dynamic shared memory (which has
// 1024 bytes of slack for it)
__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// Fill n bytes of shared memory with bf16 ones (n a multiple of 4).
__device__ __forceinline__ void fill_bf16_ones(unsigned char* p, int n) {
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(p)[i] = 0x3f803f80u;
}

// The descriptor of the ones column's B operand: a no-swizzle (interleave)
// descriptor into kOnesBytes of bf16 ones. Every element it can address is
// 1, so which element lands where does not matter: an m64n8k16 product of
// P with it adds Σ_k p to each of its 8 columns, as the JAX probes' ones
// column of V does, on the tensor cores and in f32.
__device__ __forceinline__ uint64_t ones_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// d += A·B for one m64n8k16 tile: A (bf16) from registers, B (MN-major) from shared memory
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// ---------------------------------------------------------------- int8

constexpr int kI8RowBytes = kD;            // 32-byte rows under the 32-byte swizzle
constexpr uint32_t kI8Swizzle = 3;
constexpr int kI8GroupBytes = 8 * kI8RowBytes;

// byte offset of 16-byte chunk c (0 or 1) of row r in a tile of 32-byte
// rows under the 32-byte swizzle (Swizzle<1,4,3>): the layout the
// descriptor's mode 3 names
__device__ __forceinline__ int swizzle32(int r, int c) { return r * 32 + ((c ^ ((r >> 2) & 1)) << 4); }

// d = A·B for one m64n128k32 tile of int8, exact int32 sums: A and B
// (K-major) from shared memory. At D = 32 one instruction covers the depth.
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(uint32_t (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d += a·b, one m16n8k32 tile of int8 on mma.sync, exact int32 sums
__device__ __forceinline__ void mma_s8(uint32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace probe
}  // namespace said
