// The flash kernel K1 cut open: one body for four TPU probes, the Hopper
// counterpart of tools/attn_probe.py::build (:29, pallas_call :105; the
// per-head layout), tools/attn_probe2.py::packed_kernel_factory (:33,
// pallas_call :91; the packed layout), tools/fullk_bound_probe.py::
// fullk_bound (:52, pallas_call :115; the full-K kernel under a
// precomputed shift) and tools/vpu_probe.py::blocked_variant (:95,
// pallas_call :250; the key-blocked kernel with one knob changed).
//
// The body is K1's loop (csrc/flash_attention.cu, at D = 32), templated on
// three knobs, so the stage deltas (P1, P2) and the variant deltas (P3,
// P5) are all measured on this one body.
//
// STAGE, where the body is cut (probes/flash_stages.py). What the step
// computed is kept alive and reduced into the output, as the JAX stage
// does, so the compiler cannot drop the work:
//   copy            the K and V tiles stream through the cp.async ring and
//                   nothing is computed; out = q.
//   qk              + S = Q·K^T per key tile; out = Σ over tiles of the
//                   tile's first D score columns (natural units).
//   qk_max          + the running row max; out = it (natural units), on D
//                   columns.
//   qk_max_exp      + p = exp2(s − m) over the whole tile; out = Σ over
//                   tiles of p's first D columns (no rescale, as in JAX).
//   qk_max_exp_sum  + the running sum l = l·α + Σp; out = that Σ / l.
//   full            + O = α·O + P·V: softmax attention.
// The partial outputs exist only to keep the work alive and depend on the
// key tile (128 keys bf16, 64 f32); the plain version takes the tile
// (probes/flash_stages.py::flash_stages_plain).
//
// VAR, the exp2 shift of the full body (probes/flash_shift.py):
//   prod   the online row max and the α rescale of K1/K2;
//   nomax  a constant shift C = 16: no max, no α;
//   bf16s  the score tile rounded to bf16 before the mask, the max, the
//          subtraction (rounded again) and exp2 (its p rounded to bf16);
//   noexp  exp2 replaced by the identity: p = s − m on live keys, 0 on
//          masked ones (a defined output; it times exp2's share);
//   bound  a per-row shift A (B, T, H) from the caller: p = exp2(max(s − A,
//          floor)), masked to 0 after the exp2; no max, no α.
// The partial stages run prod's max.
//
// ONES, the denominator: false is K1's register sum of the p that PV takes
// (the stages); true is the JAX probes' ones column of V (P3, P5), here a
// product of P with a constant tile of ones on the tensor cores (bf16: one
// m64n8k16 wgmma per 16 keys beside the m64n32k16 of V; f32: one more
// 8-column n-tile of the 3xTF32 product). The stages' full and the shift
// probes' prod differ in this knob alone.
//
// Layouts as strides: rows of H·D elements with the head at column h·D.
// The packed layout (B, T, H·D) is K1's; the per-head layout (B·H, T, D)
// is the same addressing with H = 1 (rows of D elements).
//
// Scores are in exp2 units inside the kernel, as in K1: Q is scaled by
// d^-1/2·log2 e in f32 and rounded to the input dtype on staging (the JAX
// shift probes fold it outside the kernel: the same values); the stages
// that output scores or maxima multiply by ln 2 on the way out. P is
// rounded to V's dtype before the PV product; the denominator sums the
// same rounded p.
//
// Shapes: the stages (no ones column) take whole tiles, T a multiple of 64
// and S of the key tile, as the JAX stage probes' shapes are block
// multiples, and compile no bounds checks. The shift probes (ones column)
// take any T and S (fullk_bound's T = 3600 is ragged at 128 keys): keys
// past S are zero-filled by the copy and masked, rows past T not written;
// a tile that reaches past S takes a masked copy of the softmax code, the
// others an unmasked one, so the mask costs nothing before the last tile.
// (Compiled into the stages, the checks cost them 6-12% in bf16 on an H100.)
//
// What bounds it: as K1, operations, never memory: the product FLOP (2·D
// a pair for QK^T, 2·D for PV and 2·8 more with the ones tile) at the
// tensor cores' rate (bf16 989e12/s; f32 as 3xTF32, 165e12/s) and, from
// qk_max_exp on and but for noexp, one exp2 a (query, key) pair at the
// special-function rate. The stage deltas say which of those steps holds
// K1; the variants delete the max pass and the α rescale (nomax, bound) or
// the exp2 (noexp).
//
// Design: K1's, unchanged: bf16 on wgmma (one warpgroup per 64 query rows,
// 128-key tiles in 64-byte swizzled shared memory, S = m64n128k16 ×2 from
// shared memory, P packed into the register A operand of m64n32k16 against
// V), f32 3xTF32 on mma.sync.m16n8k8 (4 warps × 16 rows, 64-key tiles), a
// two-stage cp.async ring of K and V tiles, one __syncthreads a tile.
#include "probe.cuh"

#include <type_traits>

namespace said {
namespace probe {

enum Stage : int { kCopy = 0, kQK = 1, kQKMax = 2, kQKMaxExp = 3, kQKMaxExpSum = 4, kFull = 5 };
enum Variant : int { kProd = 0, kNoMax = 1, kBf16S = 2, kNoExp = 3, kBound = 4 };
constexpr float kNoMaxShift = 16.0f;

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16(x)); }

// p of one score x (exp2 units; −inf where masked, which only a tile
// reaching past S holds) under the variant
template <int V, bool kTail>
__device__ __forceinline__ float p_of(float x, float m_use, float shift, float floor_) {
  if constexpr (V == kProd) return fast_exp2(x - m_use);
  if constexpr (V == kNoMax) return fast_exp2(x - kNoMaxShift);
  if constexpr (V == kBf16S) return bf16r(fast_exp2(bf16r(x - m_use)));
  float p = 0.0f;
  if constexpr (V == kNoExp) p = x - m_use;
  if constexpr (V == kBound) p = fast_exp2(fmaxf(x - shift, floor_));
  if constexpr (kTail) p = x == -INFINITY ? 0.0f : p;  // masked after the shift: −inf must not meet the clamp
  return p;
}
__host__ __device__ constexpr bool uses_max(int v) { return v == kProd || v == kBf16S || v == kNoExp; }
// the stages whose output sums the tile's first D columns of s or p
__host__ __device__ constexpr bool sums_columns(int stage) {
  return stage == kQK || stage == kQKMaxExp || stage == kQKMaxExpSum;
}

// out = q over a 64-row tile: the copy stage's output
template <typename T>
__device__ __forceinline__ void copy_rows(const T* q, T* out, int b, int q0, int T_len, size_t inner, size_t head) {
  for (int idx = threadIdx.x; idx < 64 * kD; idx += blockDim.x) {
    const size_t at = ((size_t)b * T_len + q0 + idx / kD) * inner + head + idx % kD;
    out[at] = q[at];
  }
}

// the stage's output from the row's state: x the accumulator (or the
// column sum), m the running max, den the denominator
template <int STAGE>
__device__ __forceinline__ float finish(float x, float m, float den) {
  if constexpr (STAGE == kQK) return x * kLn2;
  if constexpr (STAGE == kQKMax) return m * kLn2;
  if constexpr (STAGE == kQKMaxExpSum || STAGE == kFull) return x / den;
  return x;
}

// --------------------------------------------------------- f32: 3xTF32

template <int STAGE, int V, bool ONES>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ shift, float* __restrict__ out, int T_len, int S_len, int H,
                 float q_scale, float floor_) {
  constexpr int NT = kF32Keys / 8, DT = kD / 8;
  constexpr bool kRagged = ONES;  // the shift probes take ragged T and S, the stages whole tiles
  extern __shared__ __align__(16) float smem[];  // [stage][K | V][key][kF32Stride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t inner = (size_t)H * kD;
  const size_t head = (size_t)h * kD;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kF32Keys;
    float* ks = smem + stage * 2 * kF32Tile;
    float* vs = ks + kF32Tile;
    for (int i = tid; i < kF32Keys * kD / 4; i += kF32Threads) {
      const int r = i / (kD / 4), c = 4 * (i % (kD / 4));
      const bool ok = !kRagged || k0 + r < S_len;
      const size_t off = ok ? ((size_t)b * S_len + k0 + r) * inner + head + c : 0;
      cp_async16(smem_addr(ks + r * kF32Stride + c), k + off, ok);
      cp_async16(smem_addr(vs + r * kF32Stride + c), v + off, ok);
    }
    cp_async_commit();
  };
  const int n_tiles = kRagged ? (S_len + kF32Keys - 1) / kF32Keys : S_len / kF32Keys;
  load_tile(0, 0);

  const int ra = q0 + 16 * warp + g, rb = ra + 8;
  auto q_at = [&](int row, int d) -> float {
    return !kRagged || row < T_len ? q[((size_t)b * T_len + row) * inner + head + d] * q_scale : 0.0f;
  };
  float qf[kD / 8][4];
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    qf[kk][0] = q_at(ra, 8 * kk + t4);
    qf[kk][1] = q_at(rb, 8 * kk + t4);
    qf[kk][2] = q_at(ra, 8 * kk + t4 + 4);
    qf[kk][3] = q_at(rb, 8 * kk + t4 + 4);
  }
  float a_row[2] = {0.0f, 0.0f};  // bound: this thread's rows' shifts
  if constexpr (V == kBound) {
    if (ra < T_len) a_row[0] = shift[((size_t)b * T_len + ra) * H + h];
    if (rb < T_len) a_row[1] = shift[((size_t)b * T_len + rb) * H + h];
  }

  // m: running max (exp2 units); l: this thread's part of the row sum (the
  // register denominator); on: P·ones (the ones column, each of its 8
  // columns the same sum); o: P·V, or the stage's sum of D columns, in the
  // fragment layout o[dn][e]: row ra / rb, column 8dn + 2t4 + e
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, on[4] = {0.0f, 0.0f, 0.0f, 0.0f}, o[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, (tile + 1) & 1);
    if constexpr (STAGE == kCopy) continue;
    const float* ks = smem + (tile & 1) * 2 * kF32Tile;
    const float* vs = ks + kF32Tile;
    const int k0 = tile * kF32Keys;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const float* krow = ks + (8 * nt + g) * kF32Stride;
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) mma_3xtf32(s[nt], qf[kk], krow[8 * kk + t4], krow[8 * kk + t4 + 4]);
    }

    float alpha[2] = {1.0f, 1.0f}, sum[2] = {0.0f, 0.0f};
    if constexpr (STAGE != kQK) {
      auto softmax = [&](auto tail_tag) {
        constexpr bool kTail = decltype(tail_tag)::value;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (V == kBf16S) s[nt][e] = bf16r(s[nt][e]);
            if constexpr (kTail) {
              if (k0 + 8 * nt + 2 * t4 + (e & 1) >= S_len) s[nt][e] = -INFINITY;
            }
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float m_use = 0.0f;
          if constexpr (uses_max(V)) {
            float mx = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[hf], mx);
            alpha[hf] = m_new == -INFINITY ? 1.0f : fast_exp2(m[hf] - m_new);
            m_use = m_new == -INFINITY ? 0.0f : m_new;
            m[hf] = m_new;
          }
          if constexpr (STAGE == kQKMax) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            s[nt][2 * hf] = p_of<V, kTail>(s[nt][2 * hf], m_use, a_row[hf], floor_);
            s[nt][2 * hf + 1] = p_of<V, kTail>(s[nt][2 * hf + 1], m_use, a_row[hf], floor_);
            if constexpr (!ONES) sum[hf] += s[nt][2 * hf] + s[nt][2 * hf + 1];
          }
        }
      };
      if (kRagged && k0 + kF32Keys > S_len) softmax(std::integral_constant<bool, kRagged>{});
      else softmax(std::false_type{});
    }
    if constexpr (STAGE == kQKMax) continue;
    if constexpr (!ONES && STAGE != kQK && STAGE != kQKMaxExp) {
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];
    }
    if constexpr (sums_columns(STAGE)) {
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] += s[dn][e];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) fence_regs(s[nt]);  // every column's work stays
      continue;
    }

    float pv[DT][4], p1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[dn][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float* v0 = vs + (8 * kk + 2 * t4) * kF32Stride + g;
      const float* v1 = v0 + kF32Stride;
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) mma_3xtf32(pv[dn], a, v0[8 * dn], v1[8 * dn]);
      if constexpr (ONES) mma_3xtf32(p1, a, 1.0f, 1.0f);  // the ones column
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) o[dn][e] = fmaf(o[dn][e], alpha[e >> 1], pv[dn][e]);
      if constexpr (ONES) on[e] = fmaf(on[e], alpha[e >> 1], p1[e]);
    }
  }

  if constexpr (STAGE == kCopy) {
    copy_rows<float>(q, out, b, q0, T_len, inner, head);
    return;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float den = on[2 * hf];
    if constexpr (!ONES) {
      den = l[hf];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
    }
    const int row = hf ? rb : ra;
    if (kRagged && row >= T_len) continue;
    float* dst = out + ((size_t)b * T_len + row) * inner + head + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      *reinterpret_cast<float2*>(dst + 8 * dn) =
          make_float2(finish<STAGE>(o[dn][2 * hf], m[hf], den), finish<STAGE>(o[dn][2 * hf + 1], m[hf], den));
  }
}

// ---------------------------------------------------------------- bf16: wgmma

template <int STAGE, int V, bool ONES>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ shift,
                  __nv_bfloat16* __restrict__ out, int T_len, int S_len, int H, float q_scale, float floor_) {
  constexpr int NB = kKeys / 8;  // 8-key blocks of the score tile
  constexpr int OR = kD / 2;     // output accumulator registers
  constexpr bool kRagged = ONES;  // the shift probes take ragged T and S, the stages whole tiles
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  unsigned char* qs = base;                                // [64][D], swizzled
  unsigned char* ones = base + kQBytes;                    // the ones column's B operand (ONES)
  unsigned char* kvs = ones + (ONES ? kOnesBytes : 0);     // [stage][K | V][128][D], swizzled

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t inner = (size_t)H * kD;
  const size_t head = (size_t)h * kD;

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kKeys;
    unsigned char* ks = kvs + stage * 2 * kTileBytes;
    unsigned char* vs = ks + kTileBytes;
    for (int i = tid; i < kKeys * kRowChunks; i += kThreads) {
      const int r = i / kRowChunks, c = i % kRowChunks;
      const bool ok = !kRagged || k0 + r < S_len;
      const size_t off = ok ? ((size_t)b * S_len + k0 + r) * inner + head + 8 * c : 0;
      const int at = swizzle64(r, c);
      cp_async16(smem_addr(ks + at), k + off, ok);
      cp_async16(smem_addr(vs + at), v + off, ok);
    }
    cp_async_commit();
  };
  const int n_tiles = kRagged ? (S_len + kKeys - 1) / kKeys : S_len / kKeys;
  load_tile(0, 0);

  if constexpr (ONES) fill_bf16_ones(ones, kOnesBytes);
  for (int idx = tid; idx < kRows * kD / 2; idx += kThreads) {
    const int r = idx / (kD / 2), d = 2 * (idx % (kD / 2));
    float x0 = 0.0f, x1 = 0.0f;
    if (!kRagged || q0 + r < T_len) {
      const __nv_bfloat162 pair =
          *reinterpret_cast<const __nv_bfloat162*>(q + ((size_t)b * T_len + q0 + r) * inner + head + d);
      x0 = __bfloat162float(pair.x) * q_scale;
      x1 = __bfloat162float(pair.y) * q_scale;
    }
    *reinterpret_cast<uint32_t*>(qs + swizzle64(r, d / 8) + 2 * (d % 8)) = pack_bf16(x0, x1);
  }
  const uint64_t desc_q = gmma_desc(smem_addr(qs), kGroupBytes, kSwizzle);
  const uint64_t desc_ones = ones_desc(smem_addr(ones));

  const int row0 = q0 + 16 * warp + g;
  float a_row[2] = {0.0f, 0.0f};
  if constexpr (V == kBound) {
    if (row0 < T_len) a_row[0] = shift[((size_t)b * T_len + row0) * H + h];
    if (row0 + 8 < T_len) a_row[1] = shift[((size_t)b * T_len + row0 + 8) * H + h];
  }

  // m, l, on as the f32 kernel's; o: P·V or the stage's sum of D columns;
  // element 4j + 2·half + e is row 16·warp + g + 8·half, column 8j + 2·t4 + e
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, on[4] = {0.0f, 0.0f, 0.0f, 0.0f}, o[OR];
#pragma unroll
  for (int i = 0; i < OR; ++i) o[i] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, (tile + 1) & 1);
    if constexpr (STAGE == kCopy) continue;
    const uint32_t ks = smem_addr(kvs + (tile & 1) * 2 * kTileBytes);
    const uint32_t vs = ks + kTileBytes;
    const int k0 = tile * kKeys;

    float s[NB * 4];
    const uint64_t desc_k = gmma_desc(ks, kGroupBytes, kSwizzle);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) wgmma_m64n128k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);  // every score stays

    uint32_t pa[NB / 2][4];
    float alpha[2] = {1.0f, 1.0f}, sum[2] = {0.0f, 0.0f};
    if constexpr (STAGE != kQK) {
      auto softmax = [&](auto tail_tag) {
        constexpr bool kTail = decltype(tail_tag)::value;
#pragma unroll
        for (int i = 0; i < NB * 4; ++i) {
          if constexpr (V == kBf16S) s[i] = bf16r(s[i]);
          if constexpr (kTail) {
            if (k0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= S_len) s[i] = -INFINITY;
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float m_use = 0.0f;
          if constexpr (uses_max(V)) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < NB; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[hf], mx);
            alpha[hf] = m_new == -INFINITY ? 1.0f : fast_exp2(m[hf] - m_new);
            m_use = m_new == -INFINITY ? 0.0f : m_new;
            m[hf] = m_new;
          }
          if constexpr (STAGE == kQKMax) continue;
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const float x0 = p_of<V, kTail>(s[4 * j + 2 * hf], m_use, a_row[hf], floor_);
            const float x1 = p_of<V, kTail>(s[4 * j + 2 * hf + 1], m_use, a_row[hf], floor_);
            if constexpr (STAGE == kFull) {  // p packed to bf16 as PV's A operand
              pa[j / 2][2 * (j & 1) + hf] = ONES ? pack_bf16(x0, x1) : pack_bf16(x0, x1, sum[hf]);
            } else {
              s[4 * j + 2 * hf] = x0;
              s[4 * j + 2 * hf + 1] = x1;
              sum[hf] += x0 + x1;
            }
          }
        }
      };
      if (kRagged && k0 + kKeys > S_len) softmax(std::integral_constant<bool, kRagged>{});
      else softmax(std::false_type{});
    }
    if constexpr (STAGE == kQKMax) continue;
    if constexpr (!ONES && STAGE != kQK && STAGE != kQKMaxExp) {
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];
    }
    if constexpr (sums_columns(STAGE)) {
#pragma unroll
      for (int i = 0; i < OR; ++i) o[i] += s[i];
      fence_regs(s);  // every column's work stays
      continue;
    }
    if constexpr (uses_max(V)) {
      if (alpha[0] != 1.0f || alpha[1] != 1.0f) {
#pragma unroll
        for (int i = 0; i < OR; ++i) o[i] *= alpha[(i >> 1) & 1];
        if constexpr (ONES) {
#pragma unroll
          for (int i = 0; i < 4; ++i) on[i] *= alpha[i >> 1];
        }
      }
    }
    const uint64_t desc_v = gmma_desc(vs, kGroupBytes, kSwizzle);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      wgmma_m64n32k16_rs(o, pa[kk], desc_v + kk * (2 * kGroupBytes >> 4));
      if constexpr (ONES) wgmma_m64n8k16_rs(on, pa[kk], desc_ones);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (ONES) fence_regs(on);
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) fence_regs(pa[kk]);
  }

  if constexpr (STAGE == kCopy) {
    copy_rows<__nv_bfloat16>(q, out, b, q0, T_len, inner, head);
    return;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float den = on[2 * hf];
    if constexpr (!ONES) {
      den = l[hf];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
    }
    const int row = row0 + 8 * hf;
    if (kRagged && row >= T_len) continue;
    __nv_bfloat16* dst = out + ((size_t)b * T_len + row) * inner + head + 2 * t4;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          finish<STAGE>(o[4 * j + 2 * hf], m[hf], den), finish<STAGE>(o[4 * j + 2 * hf + 1], m[hf], den));
  }
}

template <int STAGE, int V, bool ONES>
static int launch(const void* q, const void* k, const void* v, const float* shift, void* out, int B, int T_len,
                  int S_len, int H, float floor_, int dtype, cudaStream_t st) {
  if (dtype == kFloat32) {
    if (!ONES && (T_len % kF32Rows || S_len % kF32Keys)) return (int)cudaErrorInvalidValue;
    const dim3 grid((T_len + kF32Rows - 1) / kF32Rows, H, B);
    flash_f32_kernel<STAGE, V, ONES><<<grid, kF32Threads, kF32Smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), shift,
        static_cast<float*>(out), T_len, S_len, H, q_scale(), floor_);
  } else if (dtype == kBFloat16) {
    if (!ONES && (T_len % kRows || S_len % kKeys)) return (int)cudaErrorInvalidValue;
    // 37,888 bytes (38,912 with the ones tile): no opt-in needed
    constexpr size_t smem = kQBytes + (ONES ? kOnesBytes : 0) + 4 * kTileBytes + 1024;
    const dim3 grid((T_len + kRows - 1) / kRows, H, B);
    flash_bf16_kernel<STAGE, V, ONES><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), shift, static_cast<__nv_bfloat16*>(out), T_len, S_len, H, q_scale(),
        floor_);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace probe
}  // namespace said

// q, out (B, T, H·32); k, v (B, S, H·32); contiguous, 16-byte aligned, one
// dtype. The per-head layout (B·H, T, 32) is B·H batches of H = 1.
// stage: 0 copy, 1 qk, 2 qk_max, 3 qk_max_exp, 4 qk_max_exp_sum, 5 full;
// variant: 0 prod, 1 nomax, 2 bf16s, 3 noexp, 4 bound; ones: the
// ones-column denominator. A stage before full takes prod and no ones
// column; every variant but prod takes the ones column, as the JAX probes
// that define them. Without the ones column T must be a multiple of 64
// and S of the key tile. shift: (B, T, H) f32 for bound, else null; floor:
// bound's clamp.
extern "C" int said_probe_flash(const void* q, const void* k, const void* v, const void* shift, void* out, int B,
                                int T, int S, int H, int stage, int variant, int ones, float floor_, int dtype,
                                void* stream) {
  using namespace said::probe;
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if ((variant == kBound) != (shift != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(shift);
  if (!ones) {
    if (variant != kProd) return (int)cudaErrorInvalidValue;
    switch (stage) {
      case kCopy: return launch<kCopy, kProd, false>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
      case kQK: return launch<kQK, kProd, false>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
      case kQKMax: return launch<kQKMax, kProd, false>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
      case kQKMaxExp: return launch<kQKMaxExp, kProd, false>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
      case kQKMaxExpSum: return launch<kQKMaxExpSum, kProd, false>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
      case kFull: return launch<kFull, kProd, false>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (stage != kFull) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kProd: return launch<kFull, kProd, true>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
    case kNoMax: return launch<kFull, kNoMax, true>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
    case kBf16S: return launch<kFull, kBf16S, true>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
    case kNoExp: return launch<kFull, kNoExp, true>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
    case kBound: return launch<kFull, kBound, true>(q, k, v, a, out, B, T, S, H, floor_, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
