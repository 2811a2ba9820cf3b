// QK^T in int8 inside the flash kernel: the Hopper counterpart of the TPU
// probe tools/int8_qk_probe.py::build (:54, pallas_call :139). Per-head
// layout (B·H, T, D = 32); five stages:
//   dot_bf16       S = Q·K^T in bf16 (Q pre-folded by the caller), f32 sums;
//                  out = Σ over key tiles of S's first D columns.
//   dot_int8       S = Q·K^T in int8, exact int32 sums; out as dot_bf16.
//   full_bf16      the exp2 online softmax (max from −2^30, as the JAX
//                  stage), P rounded to bf16, O = α·O + P·[V | 1].
//   full_int8qk    int8 S; the running max in raw int units; p = exp2((s −
//                  m)·dequant_log2); PV in bf16 as full_bf16.
//   full_int8qkpv  as full_int8qk, then p quantized to rint(p·127) in int8
//                  and PV in int8 against int8 V with a ones column of 127,
//                  exact int32 sums a tile, joined in f32; out = O·pv_scale
//                  / its ones column.
// The dot stages do not read V: they time the product alone.
//
// Products, one instruction family: QK^T is wgmma in both types —
// m64n128k16 bf16 (two for D = 32) and m64n128k32 .s8.s8 (one covers the
// depth) — from K-major shared-memory tiles (Q and K rows hold D
// contiguous values: 64-byte rows under the 64-byte swizzle in bf16,
// 32-byte rows under the 32-byte swizzle in int8), so dot_int8 against
// dot_bf16 is the card's int8/bf16 ratio at this shape. The bf16 PV is
// K1's (P packed in registers as the A operand of m64n32k16 against V,
// plus the ones column as m64n8k16 against a constant tile of ones). The
// int8 PV runs on mma.sync.m16n8k32 (each warp its 16 rows, P from
// registers): wgmma with int8 wants V K-major, i.e. transposed, so V is
// staged transposed through shared memory either way, and mma.sync takes
// the score accumulator's fragments in place: P's 32 keys of a step are
// read in the order the accumulator holds them (key 2t, 2t+1, 2t+8,
// 2t+9 in slots 4t…4t+3, the same +16 in slots 16+4t…) and V is
// transposed into that key order (rows padded to 132 bytes: no bank
// conflicts); the ones column is the constant 0x7f7f7f7f operand.
//
// What bounds it: the products (bf16 2·D FLOP a pair at 989e12/s; int8 at
// 1979e12 op/s) and, for the full stages, one exp2 a pair at the special-
// function rate, which the int8 products do not shrink.
//
// Design: K1's (one warpgroup per 64 query rows, 128-key tiles, a two-stage
// cp.async ring, one __syncthreads a tile, and one more for the int8 V
// transpose). T must be a multiple of 64, S of 128: no masking (the JAX
// probe's shapes are block multiples too).
#include "probe.cuh"

namespace said {
namespace probe {

enum Int8Stage : int { kDotBf16 = 0, kDotInt8 = 1, kFullBf16 = 2, kFullInt8QK = 3, kFullInt8QKPV = 4 };
constexpr int kVtStride = 132;  // bytes per transposed V row (a head dim): 128 key slots + 4 of pad
constexpr int kVtBytes = 5120;  // 32 × 132, rounded up to a multiple of 1024
constexpr float kMaxInit = -1073741824.0f;  // −2^30

// slot of key r (0…127) in the transposed V tile: the order in which the
// score accumulator holds P for mma.sync's A operand
__device__ __forceinline__ int key_slot(int r) {
  const int c = r >> 5, x = r & 31;
  return 32 * c + 16 * (x >> 4) + 4 * ((x >> 1) & 3) + 2 * ((x >> 3) & 1) + (x & 1);
}

__device__ __forceinline__ uint32_t quant127(float p) {
  return (uint32_t)(__float2int_rn(p * 127.0f) & 0xff);
}
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return a | (b << 8) | (c << 16) | (d << 24);
}

template <int STAGE>
__global__ void __launch_bounds__(kThreads)
int8_qk_kernel(const void* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int T_len, int S_len, float dequant_log2, float pv_scale) {
  constexpr bool kI8QK = STAGE == kDotInt8 || STAGE == kFullInt8QK || STAGE == kFullInt8QKPV;
  constexpr bool kI8PV = STAGE == kFullInt8QKPV;
  constexpr bool kDot = STAGE == kDotBf16 || STAGE == kDotInt8;
  constexpr int kQKRow = kI8QK ? kI8RowBytes : kRowBytes;   // bytes of a Q or K row
  constexpr int kVRow = kI8PV ? kD : kRowBytes;             // bytes of a V row
  constexpr int NB = kKeys / 8;
  constexpr int OR = kD / 2;
  const float scale = kI8QK ? dequant_log2 : 1.0f;  // raw score -> exp2 units

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  unsigned char* qs = base;                     // [64][Q row], swizzled
  unsigned char* ones = qs + kQBytes;           // the bf16 ones column's B operand
  unsigned char* vt = ones + kOnesBytes;        // int8 V, transposed: [D][kVtStride]
  unsigned char* kvs = vt + kVtBytes;           // [stage][K | V][128][row]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const unsigned char* qb = static_cast<const unsigned char*>(q);
  const unsigned char* kb = static_cast<const unsigned char*>(k);
  const unsigned char* vb = static_cast<const unsigned char*>(v);

  auto swz = [](int r, int c) { return kI8QK ? swizzle32(r, c) : swizzle64(r, c); };
  auto load_tile = [&](int tile, int stage) {
    const size_t k0 = (size_t)bh * S_len + (size_t)tile * kKeys;
    unsigned char* ks = kvs + stage * 2 * kTileBytes;
    unsigned char* vs = ks + kTileBytes;
    for (int i = tid; i < kKeys * kQKRow / 16; i += kThreads) {
      const int r = i / (kQKRow / 16), c = i % (kQKRow / 16);
      cp_async16(smem_addr(ks + swz(r, c)), kb + (k0 + r) * kQKRow + 16 * c, true);
    }
    if constexpr (!kDot) {
      for (int i = tid; i < kKeys * kVRow / 16; i += kThreads) {
        const int r = i / (kVRow / 16), c = i % (kVRow / 16);
        // bf16 V: K1's swizzled MN-major B operand; int8 V: plain rows for the transpose
        const int at = kI8PV ? r * kVRow + 16 * c : swizzle64(r, c);
        cp_async16(smem_addr(vs + at), vb + (k0 + r) * kVRow + 16 * c, true);
      }
    }
    cp_async_commit();
  };
  const int n_tiles = S_len / kKeys;
  load_tile(0, 0);

  for (int i = tid; i < kRows * kQKRow / 16; i += kThreads) {
    const int r = i / (kQKRow / 16), c = i % (kQKRow / 16);
    cp_async16(smem_addr(qs + swz(r, c)), qb + ((size_t)bh * T_len + q0 + r) * kQKRow + 16 * c, true);
  }
  cp_async_commit();
  if constexpr (!kDot && !kI8PV) fill_bf16_ones(ones, kOnesBytes);
  const uint64_t desc_q = kI8QK ? gmma_desc(smem_addr(qs), kI8GroupBytes, kI8Swizzle)
                                : gmma_desc(smem_addr(qs), kGroupBytes, kSwizzle);
  const uint64_t desc_ones = ones_desc(smem_addr(ones));

  // o: the dot stages' sum of D columns, or P·V; on: P·[ones]; element
  // 4j + 2·half + e is row 16·warp + g + 8·half, column 8j + 2·t4 + e
  float m[2] = {kMaxInit, kMaxInit}, o[OR], on[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < OR; ++i) o[i] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, (tile + 1) & 1);
    const uint32_t ks = smem_addr(kvs + (tile & 1) * 2 * kTileBytes);
    const uint32_t vs = ks + kTileBytes;

    float s[NB * 4];
    if constexpr (kI8QK) {
      uint32_t si[NB * 4];
      wgmma_fence();
      wgmma_m64n128k32_s8_ss(si, desc_q, gmma_desc(ks, kI8GroupBytes, kI8Swizzle));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(si);  // every score stays
#pragma unroll
      for (int i = 0; i < NB * 4; ++i) s[i] = (float)(int)si[i];  // exact: |s| < 2^24
    } else {
      const uint64_t desc_k = gmma_desc(ks, kGroupBytes, kSwizzle);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) wgmma_m64n128k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
    }
    if constexpr (kDot) {
#pragma unroll
      for (int i = 0; i < OR; ++i) o[i] += s[i];
      continue;
    }

    // online softmax in exp2 units: p = exp2((s − m)·scale), p in place in s
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kMaxInit;
#pragma unroll
      for (int j = 0; j < NB; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      alpha[hf] = fast_exp2((m[hf] - m_new) * scale);
      m[hf] = m_new;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        s[4 * j + 2 * hf] = fast_exp2((s[4 * j + 2 * hf] - m_new) * scale);
        s[4 * j + 2 * hf + 1] = fast_exp2((s[4 * j + 2 * hf + 1] - m_new) * scale);
      }
    }
#pragma unroll
    for (int i = 0; i < OR; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) on[i] *= alpha[i >> 1];

    if constexpr (kI8PV) {
      // V's int8 tile, transposed into the accumulator's key order
      {
        const unsigned char* row = kvs + (tile & 1) * 2 * kTileBytes + kTileBytes + tid * kD;
        const uint4 lo = *reinterpret_cast<const uint4*>(row), hi = *reinterpret_cast<const uint4*>(row + 16);
        const unsigned char* bytes_lo = reinterpret_cast<const unsigned char*>(&lo);
        const unsigned char* bytes_hi = reinterpret_cast<const unsigned char*>(&hi);
        const int slot = key_slot(tid);
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          vt[n * kVtStride + slot] = bytes_lo[n];
          vt[(n + 16) * kVtStride + slot] = bytes_hi[n];
        }
      }
      __syncthreads();
      uint32_t acc[kD / 8 + 1][4] = {};
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // 32 keys a step: blocks j = 4c … 4c + 3
        const int j = 4 * c;
        uint32_t a[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          a[hf] = pack4(quant127(s[4 * j + 2 * hf]), quant127(s[4 * j + 2 * hf + 1]),
                        quant127(s[4 * (j + 1) + 2 * hf]), quant127(s[4 * (j + 1) + 2 * hf + 1]));
          a[2 + hf] = pack4(quant127(s[4 * (j + 2) + 2 * hf]), quant127(s[4 * (j + 2) + 2 * hf + 1]),
                            quant127(s[4 * (j + 3) + 2 * hf]), quant127(s[4 * (j + 3) + 2 * hf + 1]));
        }
#pragma unroll
        for (int nt = 0; nt < kD / 8; ++nt) {
          const unsigned char* col = vt + (8 * nt + g) * kVtStride + 32 * c + 4 * t4;
          mma_s8(acc[nt], a, *reinterpret_cast<const uint32_t*>(col), *reinterpret_cast<const uint32_t*>(col + 16));
        }
        mma_s8(acc[kD / 8], a, 0x7f7f7f7fu, 0x7f7f7f7fu);  // the ones column: 127
      }
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * nt + e] += (float)(int)acc[nt][e];
#pragma unroll
      for (int e = 0; e < 4; ++e) on[e] += (float)(int)acc[kD / 8][e];
    } else {
      uint32_t pa[NB / 2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < NB; ++j) pa[j / 2][2 * (j & 1) + hf] = pack_bf16(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]);
      const uint64_t desc_v = gmma_desc(vs, kGroupBytes, kSwizzle);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        wgmma_m64n32k16_rs(o, pa[kk], desc_v + kk * (2 * kGroupBytes >> 4));
        wgmma_m64n8k16_rs(on, pa[kk], desc_ones);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(on);
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) fence_regs(pa[kk]);
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + 16 * warp + g + 8 * hf;
    __nv_bfloat16* dst = out + ((size_t)bh * T_len + row) * kD + 2 * t4;
    const float den = on[2 * hf];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      float x0 = o[4 * j + 2 * hf], x1 = o[4 * j + 2 * hf + 1];
      if constexpr (kI8PV) x0 *= pv_scale, x1 *= pv_scale;
      if constexpr (!kDot) x0 /= den, x1 /= den;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <int STAGE>
static int launch(const void* q, const void* k, const void* v, void* out, int BH, int T_len, int S_len,
                  float dequant_log2, float pv_scale, cudaStream_t st) {
  constexpr size_t smem = kQBytes + kOnesBytes + kVtBytes + 4 * kTileBytes + 1024;  // 44,032 bytes
  const dim3 grid(T_len / kRows, BH);
  int8_qk_kernel<STAGE><<<grid, kThreads, smem, st>>>(q, k, v, static_cast<__nv_bfloat16*>(out), T_len, S_len,
                                                      dequant_log2, pv_scale);
  return (int)cudaGetLastError();
}

}  // namespace probe
}  // namespace said

// q (BH, T, 32), k (BH, S, 32): bf16 for stages 0 and 2, int8 for 1, 3, 4;
// v (BH, S, 32): null for 0 and 1, bf16 for 2 and 3, int8 for 4; out (BH,
// T, 32) bf16; contiguous, 16-byte aligned; T % 64 == 0, S % 128 == 0.
extern "C" int said_probe_int8_qk(const void* q, const void* k, const void* v, void* out, int BH, int T, int S,
                                  int stage, float dequant_log2, float pv_scale, void* stream) {
  using namespace said::probe;
  if (BH <= 0 || BH > 65535 || T <= 0 || S <= 0 || T % kRows || S % kKeys) return (int)cudaErrorInvalidValue;
  if ((stage >= kFullBf16) != (v != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kDotBf16: return launch<kDotBf16>(q, k, v, out, BH, T, S, dequant_log2, pv_scale, st);
    case kDotInt8: return launch<kDotInt8>(q, k, v, out, BH, T, S, dequant_log2, pv_scale, st);
    case kFullBf16: return launch<kFullBf16>(q, k, v, out, BH, T, S, dequant_log2, pv_scale, st);
    case kFullInt8QK: return launch<kFullInt8QK>(q, k, v, out, BH, T, S, dequant_log2, pv_scale, st);
    case kFullInt8QKPV: return launch<kFullInt8QKPV>(q, k, v, out, BH, T, S, dequant_log2, pv_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
