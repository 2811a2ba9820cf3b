// Flash attention over packed (B, T, H·D) projections, for Hopper.
//
// Replaces both TPU kernels of said_tpu/ops/pallas_attention.py:
// _flash_tpu_packed (:186, K1: the whole key axis per grid step) and
// _flash_tpu_packed_blocked (:322, K2: the key axis streamed in blocks
// under a precomputed exp2 shift). Here every key length is streamed in
// key tiles with an online softmax (running max, running sum and the
// output accumulator in f32 registers, one division at the end), so one
// kernel serves both: the split existed only for the TPU's VMEM.
//
// Numerics, as K1: Q is scaled by d^-1/2 · log2(e) in f32 and rounded to
// the input dtype before the product; scores are f32 sums of products;
// p = exp2(s − m); p is rounded to V's dtype before the PV product and the
// denominator sums the same rounded p. Optional (B,) lengths: keys at or
// past a row's length are masked and the tiles past it skipped, query rows
// at or past it are written as 0, and a length-0 row gives zeros (never
// 0/0). Offsets are 64-bit.
//
// What bounds it on the card: operations, never device memory (q, k, v and
// out are read and written once per query tile). In bf16 at the UNet's
// D = 32 the exp2 work binds (B·H·T·S exp2 at ~3.9e12/s on the special-
// function units, ahead of 4·B·H·T·S·D FLOP at 989e12/s); at the
// encoder's D = 64 the two are even. In f32 the FLOP bind, at the 3xTF32
// rate (three TF32 products per f32 product: 495/3 ≈ 165e12/s). A kernel
// on the FMA pipes cannot beat 67 TFLOP/s in either dtype, so both dtypes
// run their products on the tensor cores. PERF.md holds the times beside
// SDPA's and the bound (chip_smoke.py, phase 2).
//
// bf16: wgmma, one warpgroup (128 threads) per 64 query rows, 128-key
// tiles. S = Q·K^T is one m64n128k16 wgmma per 16 head dims with both
// operands read from shared memory through matrix descriptors; Q is
// staged there once, scaled and rounded, and K and V arrive in the
// swizzled layout (128-byte rows at D = 64, 64-byte at D = 32) that the
// descriptors name, so no bank conflicts. The f32 score accumulator is
// packed to bf16 pairs in registers, which is exactly the layout of
// wgmma's register A operand (the FlashAttention-2/3 register trick), so
// O += P·V is m64n{D}k16 wgmmas with P from registers and V from shared
// memory as a transposed (MN-major) B operand: no shared-memory round trip
// for P. The denominator sums the same rounded p per thread, reduced across
// the quad of lanes that share a row once, at the end; O is rescaled only
// when the row max moved. Three blocks fit on an SM (~130 registers a
// thread, 72 KB of shared memory at D = 64), so one block's softmax runs
// while another's wgmmas do.
//
// f32: 3xTF32 on mma.sync.m16n8k8.tf32, 4 warps × 16 query rows, 64-key
// tiles. Each operand x is split into hi = tf32(x) and lo = tf32(x − hi),
// both rounded to nearest, and a·b ≈ hi·hi + hi·lo + lo·hi with f32
// accumulation: about 1e-6 relative error, where single-pass TF32 keeps
// about three digits. The score accumulator's layout is not the tf32 A
// layout, so the PV product reads its 8 keys in the order the accumulator
// holds them (key 2t in slot t, key 2t+1 in slot t+4) and takes V's rows
// in the same order: no shuffle. Each tile's PV product starts from zero
// and joins O by an f32 FMA: a tensor-core accumulation chain over every
// key of a long row drifts (its adds are not IEEE-rounded; at 21600 keys
// it left the f32 bound). Rows of the K and V tiles are padded by 16 bytes,
// which keeps the fragment reads free of bank conflicts.
//
// Both: K and V tiles flow through a ring of two shared-memory stages
// filled by cp.async, so tile j+1 loads while tile j is multiplied, one
// __syncthreads per tile. Keys past the valid length are filled with zeros
// by the copy (V must not carry NaN into a p of 0). exp2 is ex2.approx.
#include "hopper.cuh"

#include <math.h>

namespace said {

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the JAX kernels' scale: d^-1/2 · log2(e) in double, rounded to f32
static float q_scale_for(int D) { return (float)(pow((double)D, -0.5) * 1.4426950408889634); }

// A tile of query rows wholly at or past the row's length: zeros, nothing computed.
template <typename T, int D>
__device__ __forceinline__ void zero_rows(T* out, int b, int q0, int rows, int T_len, size_t inner, size_t head) {
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    if (q0 + r < T_len) out[((size_t)b * T_len + q0 + r) * inner + head + d] = from_f32<T>(0.0f);
  }
}

// --------------------------------------------------------- f32: 3xTF32

constexpr int kF32Rows = 64;     // 4 warps × 16 query rows
constexpr int kF32Keys = 64;     // keys per staged tile
constexpr int kF32Threads = 128;

template <int D>
struct F32Layout {
  static constexpr int kStride = D + 4;  // floats per staged row: 16 bytes of pad
  static constexpr int kTile = kF32Keys * kStride;
  static constexpr size_t kSmem = sizeof(float) * 4 * kTile;  // two stages of K and V
};

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           const int* __restrict__ lengths, int T_len, int S_len, int H, float q_scale) {
  using L = F32Layout<D>;
  constexpr int NT = kF32Keys / 8, DT = D / 8;  // score and output n-tiles
  extern __shared__ __align__(16) float smem[];  // [stage][K | V][key][kStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column group
  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t inner = (size_t)H * D;
  const size_t head = (size_t)h * D;

  int q_len = T_len, kv_len = S_len;
  if (lengths != nullptr) {
    const int n = max(lengths[b], 0);
    q_len = min(n, T_len);
    kv_len = min(n, S_len);
  }
  if (q0 >= q_len) {
    zero_rows<float, D>(out, b, q0, kF32Rows, T_len, inner, head);
    return;
  }

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kF32Keys;
    float* ks = smem + stage * 2 * L::kTile;
    float* vs = ks + L::kTile;
    for (int i = tid; i < kF32Keys * D / 4; i += kF32Threads) {
      const int r = i / (D / 4), c = 4 * (i % (D / 4));
      const bool ok = k0 + r < kv_len;
      const size_t off = ok ? ((size_t)b * S_len + k0 + r) * inner + head + c : 0;
      cp_async16(smem_addr(ks + r * L::kStride + c), k + off, ok);
      cp_async16(smem_addr(vs + r * L::kStride + c), v + off, ok);
    }
    cp_async_commit();
  };
  const int n_tiles = (kv_len + kF32Keys - 1) / kF32Keys;
  load_tile(0, 0);

  // this thread's query rows: ra = q0 + 16·warp + g and rb = ra + 8
  const int ra = q0 + 16 * warp + g, rb = ra + 8;
  auto q_at = [&](int row, int d) -> float {  // scaled (f32 rounding is the identity), 0 past T_len
    return row < T_len ? q[((size_t)b * T_len + row) * inner + head + d] * q_scale : 0.0f;
  };
  // Q as m16n8k8 A fragments, one per 8 head dims
  float qf[D / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    qf[kk][0] = q_at(ra, 8 * kk + t4);
    qf[kk][1] = q_at(rb, 8 * kk + t4);
    qf[kk][2] = q_at(ra, 8 * kk + t4 + 4);
    qf[kk][3] = q_at(rb, 8 * kk + t4 + 4);
  }

  // running max (exp2 units) and this thread's part of the row sum, rows ra and rb
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, o[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    // tile's copies have landed, and every warp is done with the stage the
    // next copy overwrites (tile − 1's)
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, (tile + 1) & 1);
    const float* ks = smem + (tile & 1) * 2 * L::kTile;
    const float* vs = ks + L::kTile;
    const int k0 = tile * kF32Keys;

    // S = Q K^T: s[nt] holds rows (ra, rb) × keys k0 + 8nt + (2t4, 2t4+1)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const float* krow = ks + (8 * nt + g) * L::kStride;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) mma_3xtf32(s[nt], qf[kk], krow[8 * kk + t4], krow[8 * kk + t4 + 4]);
    }
    if (k0 + kF32Keys > kv_len) {  // keys at or past kv_len (only in the last tile)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * nt + 2 * t4 + (e & 1) >= kv_len) s[nt][e] = -INFINITY;
    }

    // online softmax: p = exp2(s − m_new) in place
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      // m_new = -inf only if every key so far was masked: keep the (zero)
      // state instead of forming exp2(-inf − -inf) = NaN
      alpha[hf] = m_new == -INFINITY ? 1.0f : fast_exp2(m[hf] - m_new);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      m[hf] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][2 * hf] = fast_exp2(s[nt][2 * hf] - m_use);
        s[nt][2 * hf + 1] = fast_exp2(s[nt][2 * hf + 1] - m_use);
        sum += s[nt][2 * hf] + s[nt][2 * hf + 1];
      }
      l[hf] = l[hf] * alpha[hf] + sum;
    }

    // O = alpha·O + P V, 8 keys per step in the accumulator's order
    float pv[DT][4];
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[dn][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float* v0 = vs + (8 * kk + 2 * t4) * L::kStride + g;
      const float* v1 = v0 + L::kStride;
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) mma_3xtf32(pv[dn], a, v0[8 * dn], v1[8 * dn]);
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = fmaf(o[dn][e], alpha[e >> 1], pv[dn][e]);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float den = l[hf];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int row = hf ? rb : ra;
    if (row >= T_len) continue;
    const bool live = row < q_len && den > 0.0f;
    const float inv = live ? 1.0f / den : 0.0f;
    float* dst = out + ((size_t)b * T_len + row) * inner + head + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      *reinterpret_cast<float2*>(dst + 8 * dn) =
          make_float2(live ? o[dn][2 * hf] * inv : 0.0f, live ? o[dn][2 * hf + 1] * inv : 0.0f);
  }
}

template <int D>
static int launch_flash_f32(const void* q, const void* k, const void* v, void* out, const int* lengths,
                            int B, int T_len, int S_len, int H, cudaStream_t stream) {
  constexpr size_t smem = F32Layout<D>::kSmem;
  auto kernel = flash_attention_f32_kernel<D>;
  // Set once per process (a thread-safe static): at D = 64 the tiles need
  // 68 KB, above the 48 KB a launch gets without opting in.
  static const cudaError_t attr_err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const dim3 grid((T_len + kF32Rows - 1) / kF32Rows, H, B);
  kernel<<<grid, kF32Threads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                              static_cast<const float*>(v), static_cast<float*>(out), lengths,
                                              T_len, S_len, H, q_scale_for(D));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16: wgmma

template <int D>
struct Bf16Cfg {
  static constexpr int kRows = 64;     // one warpgroup: wgmma's 64-row tile
  static constexpr int kKeys = 128;    // keys per staged tile: S is m64n128
  static constexpr int kThreads = 128;
  static constexpr int kRowBytes = D * 2;              // a swizzle atom's row: 64 or 128 bytes
  static constexpr uint32_t kSwizzle = D == 64 ? 1 : 2;
  static constexpr int kGroupBytes = 8 * kRowBytes;    // 8 rows: the stride byte offset
  static constexpr int kRowChunks = kRowBytes / 16;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kKeys * kRowBytes;
  static constexpr size_t kSmem = kQBytes + 4 * kTileBytes + 1024;  // + slack to align the base
};

// byte offset of 16-byte chunk c of row r in a swizzled tile: 128-byte
// rows at D = 64, 64-byte rows at D = 32
template <int D>
__device__ __forceinline__ int swizzled(int r, int c) {
  if constexpr (D == 64) return swizzle128(r, c);
  else return swizzle64(r, c);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            const int* __restrict__ lengths, int T_len, int S_len, int H, float q_scale) {
  using C = Bf16Cfg<D>;
  constexpr int NB = C::kKeys / 8;  // 8-key blocks of the score tile
  constexpr int OR = D / 2;         // output accumulator registers
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);  // 1024-byte aligned
  unsigned char* qs = base;                  // [64][D], swizzled
  unsigned char* kvs = base + C::kQBytes;    // [stage][K | V][128][D], swizzled

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * C::kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t inner = (size_t)H * D;
  const size_t head = (size_t)h * D;

  int q_len = T_len, kv_len = S_len;
  if (lengths != nullptr) {
    const int n = max(lengths[b], 0);
    q_len = min(n, T_len);
    kv_len = min(n, S_len);
  }
  if (q0 >= q_len) {
    zero_rows<__nv_bfloat16, D>(out, b, q0, C::kRows, T_len, inner, head);
    return;
  }

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * C::kKeys;
    unsigned char* ks = kvs + stage * 2 * C::kTileBytes;
    unsigned char* vs = ks + C::kTileBytes;
    for (int i = tid; i < C::kKeys * C::kRowChunks; i += C::kThreads) {
      const int r = i / C::kRowChunks, c = i % C::kRowChunks;
      const bool ok = k0 + r < kv_len;
      const size_t off = ok ? ((size_t)b * S_len + k0 + r) * inner + head + 8 * c : 0;
      const int at = swizzled<D>(r, c);
      cp_async16(smem_addr(ks + at), k + off, ok);
      cp_async16(smem_addr(vs + at), v + off, ok);
    }
    cp_async_commit();
  };
  const int n_tiles = (kv_len + C::kKeys - 1) / C::kKeys;
  load_tile(0, 0);

  // the scaled Q tile, rounded to bf16, in the swizzled layout wgmma reads
  // (0 past T_len); made visible by the first tile's fence and barrier
  for (int idx = tid; idx < C::kRows * D / 2; idx += C::kThreads) {
    const int r = idx / (D / 2), d = 2 * (idx % (D / 2));
    float x0 = 0.0f, x1 = 0.0f, unused = 0.0f;
    if (q0 + r < T_len) {
      const __nv_bfloat162 pair =
          *reinterpret_cast<const __nv_bfloat162*>(q + ((size_t)b * T_len + q0 + r) * inner + head + d);
      x0 = __bfloat162float(pair.x) * q_scale;
      x1 = __bfloat162float(pair.y) * q_scale;
    }
    *reinterpret_cast<uint32_t*>(qs + swizzled<D>(r, d / 8) + 2 * (d % 8)) = pack_bf16(x0, x1, unused);
  }
  const uint64_t desc_q = gmma_desc(smem_addr(qs), C::kGroupBytes, C::kSwizzle);

  // this thread's rows: 16·warp + g (half 0) and + 8 (half 1) of the 64;
  // accumulator element 4j + 2·half + e is column 8j + 2·t4 + e
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[OR];
#pragma unroll
  for (int i = 0; i < OR; ++i) o[i] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, (tile + 1) & 1);
    const uint32_t ks = smem_addr(kvs + (tile & 1) * 2 * C::kTileBytes);
    const uint32_t vs = ks + C::kTileBytes;
    const int k0 = tile * C::kKeys;

    // S = Q K^T, 16 head dims per step: +32 bytes along the swizzled rows
    float s[NB * 4];
    const uint64_t desc_k = gmma_desc(ks, C::kGroupBytes, C::kSwizzle);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n128k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (k0 + C::kKeys > kv_len) {  // keys at or past kv_len (only in the last tile)
#pragma unroll
      for (int i = 0; i < NB * 4; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= kv_len) s[i] = -INFINITY;
    }

    // online softmax; P packed to bf16 in place as the A fragments of PV:
    // fragment kk holds the 16 keys of 8-key blocks 2kk and 2kk + 1
    uint32_t pa[NB / 2][4];
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      // m_new = -inf only if every key so far was masked: keep the (zero)
      // state instead of forming exp2(-inf − -inf) = NaN
      alpha[hf] = m_new == -INFINITY ? 1.0f : fast_exp2(m[hf] - m_new);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      m[hf] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        pa[j / 2][2 * (j & 1) + hf] =
            pack_bf16(fast_exp2(s[4 * j + 2 * hf] - m_use), fast_exp2(s[4 * j + 2 * hf + 1] - m_use), sum);
      l[hf] = l[hf] * alpha[hf] + sum;
    }
    if (alpha[0] != 1.0f || alpha[1] != 1.0f) {
#pragma unroll
      for (int i = 0; i < OR; ++i) o[i] *= alpha[(i >> 1) & 1];
    }

    // O += P V, 16 keys per step: V is the transposed (MN-major) B operand,
    // two 8-row groups further on per step
    const uint64_t desc_v = gmma_desc(vs, C::kGroupBytes, C::kSwizzle);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      if constexpr (D == 64) wgmma_m64n64k16_rs(o, pa[kk], desc_v + kk * (2 * C::kGroupBytes >> 4));
      else wgmma_m64n32k16_rs(o, pa[kk], desc_v + kk * (2 * C::kGroupBytes >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) fence_regs(pa[kk]);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float den = l[hf];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int row = q0 + 16 * warp + g + 8 * hf;
    if (row >= T_len) continue;
    const bool live = row < q_len && den > 0.0f;
    const float inv = live ? 1.0f / den : 0.0f;
    __nv_bfloat16* dst = out + ((size_t)b * T_len + row) * inner + head + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(live ? o[4 * j + 2 * hf] * inv : 0.0f, live ? o[4 * j + 2 * hf + 1] * inv : 0.0f);
  }
}

template <int D>
static int launch_flash_bf16(const void* q, const void* k, const void* v, void* out, const int* lengths,
                             int B, int T_len, int S_len, int H, cudaStream_t stream) {
  using C = Bf16Cfg<D>;
  auto kernel = flash_attention_bf16_kernel<D>;
  // at D = 64 the tiles need 73 KB, above the 48 KB a launch gets without opting in
  static const cudaError_t attr_err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const dim3 grid((T_len + C::kRows - 1) / C::kRows, H, B);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lengths, T_len, S_len, H,
      q_scale_for(D));
  return (int)cudaGetLastError();
}

}  // namespace said

// q, out (B, T, H·D); k, v (B, S, H·D); all contiguous, 16-byte aligned,
// one dtype; lengths: null or (B,) int32 on the device. D ∈ {32, 64}.
extern "C" int said_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, const void* lengths, int B, int T,
                                    int S, int H, int D, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || H > 65535 || B > 65535 || (D != 32 && D != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == said::kFloat32)
    return D == 32 ? said::launch_flash_f32<32>(q, k, v, out, lens, B, T, S, H, st)
                   : said::launch_flash_f32<64>(q, k, v, out, lens, B, T, S, H, st);
  if (dtype == said::kBFloat16)
    return D == 32 ? said::launch_flash_bf16<32>(q, k, v, out, lens, B, T, S, H, st)
                   : said::launch_flash_bf16<64>(q, k, v, out, lens, B, T, S, H, st);
  return (int)cudaErrorInvalidValue;
}
