// Fused GEGLU feed-forward for the UNet transformer blocks, on Hopper's
// tensor cores.
//
// Replaces the TPU kernel geglu_ffn_pallas (said_tpu/ops/pallas_ffn.py:87):
//   h = x @ W1^T + b1          (C -> 2I, f32 accumulation)
//   y = a * gelu_erf(g)        (a = h[:, :I], g = h[:, I:], f32)
//   out = y @ W2^T + b2        (I -> C, f32 accumulation)
// with the (rows, 2I) projection kept on chip: it never goes to device
// memory, which is what the TPU kernel exists to do. For bf16 inputs y is
// rounded to bf16 before the second product, as the plain twin does.
// Weights are read in torch's layout (W1 (2I, C), W2 (C, I)).
//
// What bounds it on the card: the products' FLOP (2·M·C·2I + 2·M·I·C; at
// 43200 rows, 8.6 GFLOP against 33 MB of activations and 0.6–1.2 MB of
// weights), at 989 TFLOP/s in bf16 and, in f32, at the 3xTF32 rate
// (495/3 TFLOP/s). The shape is flash attention's: W1's chunk plays K, the
// gate takes the softmax's place and W2's chunk plays V. So both dtypes
// run their products on the tensor cores, a block keeps its rows' output
// in f32 registers over the whole inner axis, and the weights stream
// through shared memory in chunks of inner units.
//
// Inner-unit order: the inner axis is summed over by the second product,
// so units may be taken in any order between the two products. The staged
// W1 tile interleaves each unit's a-row and g-row, in the order that puts
// a_u and g_u side by side in a thread's accumulator and y_u exactly where
// the second product's A fragment wants it. y never passes through
// shared memory, and W2's chunk is staged in its natural order.
//
// bf16 (wgmma): one warpgroup per 64 rows, one or two warpgroups a block
// (64 or 128 rows; both share the staged weights); chunks of 64 units.
// x is staged once, swizzled (three 64-channel subtiles of 128-byte rows).
// Per chunk the first product is two m64n64k16 wgmma chains from shared
// memory (K-major W1 rows as B, 12 k-steps over C = 192), committed
// separately: the gate of the first half runs while the second half's
// products do, and the second product of each half (m64n192k16, y packed
// to bf16 as the register A operand, W2's chunk K-major as B) runs while
// the next half is gated. Output: 96 f32 registers a thread.
//
// f32 (3xTF32 on mma.sync.m16n8k8): 64 rows a block in 4 row groups of
// 16, chunks of 32 units; two warps per row group, each taking half of a
// chunk's units through both products (two warps on each scheduler to
// hide the mma latency), their two output tiles added in shared memory at
// the end in a fixed order. Each operand x is split into hi and lo = x −
// hi, both masked to tf32's top 19 bits, and a·b ≈ hi·hi + hi·lo + lo·hi
// (about 1e-6 relative error); the A operands (x, then y) are split once
// per k-step and reused across the n-tiles. Within each 8-wide k-step, k
// is permuted so that a thread's two values are adjacent (one 8-byte
// shared-memory load); rows are padded to 200 / 40 floats, which keeps
// those loads free of bank conflicts. Each chunk's second product starts
// from zero, four 8-column tiles at a time, and joins the output by an
// f32 add, so no tensor-core accumulation chain runs over the inner axis.
//
// Both: a ring of two shared-memory stages (W1's and W2's chunk) filled
// by cp.async, so chunk i+1 loads while chunk i is multiplied; one block
// per SM (168–193 KB bf16, 210 KB f32). Filling the card: where the row
// tiles would leave SMs idle, a thread-block cluster of 2 or 4 blocks
// splits the inner units of one tile; the partial 64/128×192 f32 tiles
// meet in the stage buffers and are added through distributed shared
// memory in rank order (no atomics, one launch, bit-identical from run to
// run). The plan (rows per block, cluster size) is chosen on the host by
// a cost model: ops/ffn.py::geglu_plan.
#include "hopper.cuh"

#include <cooperative_groups.h>

namespace said {

namespace cg = cooperative_groups;

constexpr int kFfnWidth = 192;                   // C: the UNet's model_channels, the only width on the path
constexpr int kPartialStride = kFfnWidth + 8;    // floats per row of a partial tile (float2 writes conflict-free)

// The cluster's sum: every rank has left its partial R×192 tile in its
// shared memory (part); rank r adds rows [r·R/CL, (r+1)·R/CL) of every
// rank's partial, in rank order, adds b2 and stores. Nothing else is in
// flight when a block calls it.
template <typename T, int R, int Threads>
__device__ __forceinline__ void cluster_sum(float* part, int cl, const float* __restrict__ b2, T* __restrict__ out,
                                           int m0, int M) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();  // every rank's partial is written
  const float* src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) src[q] = q < cl ? cluster.map_shared_rank(part, q) : nullptr;
  const int rows = R / cl, r0 = rank * rows;
  for (int idx = threadIdx.x; idx < rows * (kFfnWidth / 4); idx += Threads) {
    const int r = r0 + idx / (kFfnWidth / 4), c = 4 * (idx % (kFfnWidth / 4));
    float4 s = *reinterpret_cast<const float4*>(src[0] + r * kPartialStride + c);
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      if (q < cl) {
        const float4 p = *reinterpret_cast<const float4*>(src[q] + r * kPartialStride + c);
        s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
      }
    }
    const int m = m0 + r;
    if (m < M) {
      T* dst = out + (size_t)m * kFfnWidth + c;
      dst[0] = from_f32<T>(s.x + b2[c]);
      dst[1] = from_f32<T>(s.y + b2[c + 1]);
      dst[2] = from_f32<T>(s.z + b2[c + 2]);
      dst[3] = from_f32<T>(s.w + b2[c + 3]);
    }
  }
  cluster.sync();  // no rank leaves while another still reads its shared memory
}

// ------------------------------------------------------------------ bf16: wgmma

template <int WG>
struct Bf16Ffn {
  static constexpr int kRows = 64 * WG;                  // one warpgroup per 64 rows
  static constexpr int kThreads = 128 * WG;
  static constexpr int kUnits = 64;                      // inner units per chunk
  static constexpr int kW1Rows = 2 * kUnits;             // staged a- and g-rows, interleaved
  static constexpr int kSub = kFfnWidth / 64;            // 64-channel subtiles of 128-byte rows
  static constexpr int kXSub = kRows * 128;              // bytes of one x subtile
  static constexpr int kW1Sub = kW1Rows * 128;           // bytes of one W1 subtile
  static constexpr int kXBytes = kSub * kXSub;
  static constexpr int kW1Bytes = kSub * kW1Sub;         // 48 KB
  static constexpr int kW2Bytes = kFfnWidth * 128;       // 192 rows × 64 units: 24 KB
  static constexpr int kStageBytes = kW1Bytes + kW2Bytes;
  static constexpr size_t kSmem = kXBytes + 2 * kStageBytes + 1024;  // + slack to align the base
  static_assert(kRows * kPartialStride * 4 <= 2 * kStageBytes, "the partial tile reuses the stages");
};

// the local unit of staged W1 row n (its parity says a or g): thread
// quad-lane t of the accumulator's 8-column block j then holds a and g of
// unit 16·(j/4) + 8·((j/2)%2) + 2t + j%2, and blocks 4k..4k+3 give the A
// fragment of the second product's k-step k in natural unit order
__device__ __forceinline__ int bf16_staged_unit(int n) {
  const int j = n >> 3, t = (n >> 1) & 3;
  return 16 * (j >> 2) + 8 * ((j >> 1) & 1) + 2 * t + (j & 1);
}

template <int WG>
__global__ void __launch_bounds__(128 * WG, 1)
geglu_ffn_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                      const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                      const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int M, int I, int cl) {
  using L = Bf16Ffn<WG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);  // 1024-byte aligned
  unsigned char* xs = base;                   // [sub][rows][128 B], swizzled
  unsigned char* stages = base + L::kXBytes;  // [stage][W1: sub][128][128 B] [W2: 192][128 B], swizzled

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int tile = blockIdx.x / cl, rank = blockIdx.x % cl;
  const int m0 = tile * L::kRows;
  const int n_chunks = I / L::kUnits;
  const int c_begin = rank * n_chunks / cl, c_end = (rank + 1) * n_chunks / cl;

  auto load_chunk = [&](int chunk, int stage, bool with_x) {
    const int c0 = chunk * L::kUnits;
    unsigned char* w1s = stages + stage * L::kStageBytes;
    unsigned char* w2s = w1s + L::kW1Bytes;
    if (with_x) {
      for (int i = tid; i < L::kRows * 24; i += L::kThreads) {
        const int r = i / 24, c = i % 24;
        const bool ok = m0 + r < M;
        cp_async16(smem_addr(xs + (c >> 3) * L::kXSub + swizzle128(r, c & 7)),
                   x + (ok ? (size_t)(m0 + r) * kFfnWidth + 8 * c : 0), ok);
      }
    }
    for (int i = tid; i < L::kW1Rows * 24; i += L::kThreads) {
      const int n = i / 24, c = i % 24;
      const size_t row = (size_t)(n & 1) * I + c0 + bf16_staged_unit(n);
      cp_async16(smem_addr(w1s + (c >> 3) * L::kW1Sub + swizzle128(n, c & 7)), w1 + row * kFfnWidth + 8 * c, true);
    }
    for (int i = tid; i < kFfnWidth * 8; i += L::kThreads) {
      const int n = i >> 3, c = i & 7;
      cp_async16(smem_addr(w2s + swizzle128(n, c)), w2 + (size_t)n * I + c0 + 8 * c, true);
    }
    cp_async_commit();
  };
  if (c_begin < c_end) load_chunk(c_begin, 0, true);

  const uint64_t desc_x = gmma_desc(smem_addr(xs + wg * 64 * 128), 1024, 1);
  float acc[96];  // rows 16·warp + g (+8): element 4j + 2·half + e is column 8j + 2·t4 + e
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.0f;

  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int stage = (chunk - c_begin) & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (chunk + 1 < c_end) load_chunk(chunk + 1, stage ^ 1, false);
    const uint32_t w1s = smem_addr(stages + stage * L::kStageBytes);
    const uint64_t desc_w1 = gmma_desc(w1s, 1024, 1);
    const uint64_t desc_w2 = gmma_desc(w1s + L::kW1Bytes, 1024, 1);
    const int c0 = chunk * L::kUnits;

    // first product, two halves of 64 staged rows (32 units), each 12
    // k-steps of 16 channels: subtile kk/4, +32 bytes along its rows per step
    float h[2][32];
    wgmma_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int kk = 0; kk < 12; ++kk) {
        const uint32_t xo = ((kk >> 2) * L::kXSub + (kk & 3) * 32) >> 4;
        const uint32_t wo = ((kk >> 2) * L::kW1Sub + half * 64 * 128 + (kk & 3) * 32) >> 4;
        wgmma_m64n64k16_ss(h[half], desc_x + xo, desc_w1 + wo, kk);
      }
      wgmma_commit();
    }

    // per half: gate, pack y as the A fragments of k-steps 2·half and
    // 2·half + 1, and start their share of the second product
    uint32_t ya[4][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // half 0: its first product is done, half 1's may still run; half 1:
      // its first product is done, half 0's second product may still run
      wgmma_wait<1>();
      fence_regs(h[half]);
      float y[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * half + jj;
        const int u = c0 + bf16_staged_unit(8 * j + 2 * t4);
        const float ba = __ldg(b1 + u), bg = __ldg(b1 + I + u);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          y[jj][hf] = (h[half][4 * jj + 2 * hf] + ba) * gelu_erf(h[half][4 * jj + 2 * hf + 1] + bg);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        uint32_t (&a)[4] = ya[2 * half + k];
        a[0] = pack_bf16(y[4 * k][0], y[4 * k + 1][0]);
        a[1] = pack_bf16(y[4 * k][1], y[4 * k + 1][1]);
        a[2] = pack_bf16(y[4 * k + 2][0], y[4 * k + 3][0]);
        a[3] = pack_bf16(y[4 * k + 2][1], y[4 * k + 3][1]);
      }
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k) wgmma_m64n192k16_rs(acc, ya[2 * half + k], desc_w2 + 2 * (2 * half + k));
      wgmma_commit();
    }
    wgmma_wait<0>();  // before the barrier that lets the next copy overwrite this stage
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) fence_regs(ya[k]);
  }

  const int row0 = 64 * wg + 16 * warp + g;  // + 8·half
  if (cl == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + row0 + 8 * hf;
      if (m >= M) continue;
      __nv_bfloat16* dst = out + (size_t)m * kFfnWidth + 2 * t4;
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int c = 8 * j + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hf] + b2[c], acc[4 * j + 2 * hf + 1] + b2[c + 1]);
      }
    }
    return;
  }
  __syncthreads();  // every warpgroup is done with the stages the partial tile overwrites
  float* part = reinterpret_cast<float*>(stages);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < 24; ++j)
      *reinterpret_cast<float2*>(part + (row0 + 8 * hf) * kPartialStride + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
  cluster_sum<__nv_bfloat16, L::kRows, L::kThreads>(part, cl, b2, out, m0, M);
}

// ------------------------------------------------------------------ f32: 3xTF32

struct F32Ffn {
  static constexpr int kRows = 64;        // 4 row groups × 16 rows
  static constexpr int kThreads = 256;    // 8 warps: two per row group, each taking half of a chunk's units
  static constexpr int kUnits = 32;       // inner units per chunk
  static constexpr int kW1Rows = 2 * kUnits;
  static constexpr int kStride = kFfnWidth + 8;  // floats per staged x / W1 row
  static constexpr int kW2Stride = kUnits + 8;   // floats per staged W2 row
  static constexpr int kX = kRows * kStride;     // floats
  static constexpr int kW1 = kW1Rows * kStride;
  static constexpr int kStage = kW1 + kFfnWidth * kW2Stride;
  static constexpr size_t kSmem = sizeof(float) * (kX + 2 * kStage);
  static_assert(kRows * kPartialStride <= 2 * kStage, "the partial tile reuses the stages");
};

// the local unit of staged W1 row n (its parity says a or g): lane t of
// n-tile nt then holds a and g of unit 8·(nt/2) + 2t + nt%2, so n-tiles
// 2k and 2k+1 give the second product's k-step k
__device__ __forceinline__ int f32_staged_unit(int n) {
  const int nt = n >> 3, t = (n >> 1) & 3;
  return 8 * (nt >> 1) + 2 * t + (nt & 1);
}

__global__ void __launch_bounds__(F32Ffn::kThreads, 1)
geglu_ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int M,
                     int I, int cl) {
  using L = F32Ffn;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // [64][kStride]
  float* stages = smem + L::kX;  // [stage][W1: 64][kStride] [W2: 192][kW2Stride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kh = warp >> 2;  // which half of each chunk's units: n-tiles 4kh..4kh+3, k-steps 2kh, 2kh+1
  const int tile = blockIdx.x / cl, rank = blockIdx.x % cl;
  const int m0 = tile * L::kRows;
  const int n_chunks = I / L::kUnits;
  const int c_begin = rank * n_chunks / cl, c_end = (rank + 1) * n_chunks / cl;

  auto load_chunk = [&](int chunk, int stage, bool with_x) {
    const int c0 = chunk * L::kUnits;
    float* w1s = stages + stage * L::kStage;
    float* w2s = w1s + L::kW1;
    if (with_x) {
      for (int i = tid; i < L::kRows * 48; i += L::kThreads) {
        const int r = i / 48, c = 4 * (i % 48);
        const bool ok = m0 + r < M;
        cp_async16(smem_addr(xs + r * L::kStride + c), x + (ok ? (size_t)(m0 + r) * kFfnWidth + c : 0), ok);
      }
    }
    for (int i = tid; i < L::kW1Rows * 48; i += L::kThreads) {
      const int n = i / 48, c = 4 * (i % 48);
      const size_t row = (size_t)(n & 1) * I + c0 + f32_staged_unit(n);
      cp_async16(smem_addr(w1s + n * L::kStride + c), w1 + row * kFfnWidth + c, true);
    }
    for (int i = tid; i < kFfnWidth * 8; i += L::kThreads) {
      const int n = i >> 3, c = 4 * (i & 7);
      cp_async16(smem_addr(w2s + n * L::kW2Stride + c), w2 + (size_t)n * I + c0 + c, true);
    }
    cp_async_commit();
  };
  if (c_begin < c_end) load_chunk(c_begin, 0, true);

  // this thread's rows: ra = 16·(warp % 4) + g and rb = ra + 8; the output
  // accumulator o[nt] holds columns 8nt + 2·t4 (+1) of ra (0, 1) and rb (2, 3)
  const int ra = 16 * (warp & 3) + g, rb = ra + 8;
  float o[24][4];
#pragma unroll
  for (int nt = 0; nt < 24; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;

  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int stage = (chunk - c_begin) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (chunk + 1 < c_end) load_chunk(chunk + 1, stage ^ 1, false);
    const float* w1s = stages + stage * L::kStage;
    const float* w2s = w1s + L::kW1;
    const int c0 = chunk * L::kUnits;

    // first product: h[i] holds staged rows 8·(4kh + i) + 2·t4 (a) and + 1
    // (g); logical k = t4 and t4 + 4 of each 8-channel step are channels
    // 8kk + 2·t4 and + 1
    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[i][e] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kFfnWidth / 8; ++kk) {
      const float2 xa = *reinterpret_cast<const float2*>(xs + ra * L::kStride + 8 * kk + 2 * t4);
      const float2 xb = *reinterpret_cast<const float2*>(xs + rb * L::kStride + 8 * kk + 2 * t4);
      const float a[4] = {xa.x, xb.x, xa.y, xb.y};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32_trunc(a[e], ah[e], al[e]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 w =
            *reinterpret_cast<const float2*>(w1s + (8 * (4 * kh + i) + g) * L::kStride + 8 * kk + 2 * t4);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_trunc(w.x, bh0, bl0);
        split_tf32_trunc(w.y, bh1, bl1);
        mma_3xtf32(h[i], ah, al, bh0, bl0, bh1, bl1);
      }
    }

    // gate; y of n-tiles 2k and 2k+1 is the A fragment of k-step k
    uint32_t yh[2][4], yl[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nt = 4 * kh + i;
      const int u = c0 + f32_staged_unit(8 * nt + 2 * t4);
      const float ba = __ldg(b1 + u), bg = __ldg(b1 + I + u);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float y = (h[i][2 * hf] + ba) * gelu_erf(h[i][2 * hf + 1] + bg);
        const int slot = 2 * (nt & 1) + hf;  // a[0] ra k, a[1] rb k, a[2] ra k+4, a[3] rb k+4
        split_tf32_trunc(y, yh[i >> 1][slot], yl[i >> 1][slot]);
      }
    }

    // second product over this warp's two k-steps, four 8-column tiles at
    // a time (independent chains), each from a fresh accumulator joined to
    // the output by an f32 add
#pragma unroll
    for (int ng = 0; ng < 6; ++ng) {
      float p[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(w2s + (8 * (4 * ng + j) + g) * L::kW2Stride +
                                                            8 * (2 * kh + k) + 2 * t4);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32_trunc(w.x, bh0, bl0);
          split_tf32_trunc(w.y, bh1, bl1);
          mma_3xtf32(p[j], yh[k], yl[k], bh0, bl0, bh1, bl1);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * ng + j][e] += p[j][e];
    }
  }

  // the two halves of each row group meet in the stages, in a fixed order
  __syncthreads();  // every warp is done with the stages
  float* part = stages;
  auto at = [&](int hf, int nt) { return part + (hf ? rb : ra) * kPartialStride + 8 * nt + 2 * t4; };
  if (kh == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int nt = 0; nt < 24; ++nt)
        *reinterpret_cast<float2*>(at(hf, nt)) = make_float2(o[nt][2 * hf], o[nt][2 * hf + 1]);
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + (hf ? rb : ra);
#pragma unroll
      for (int nt = 0; nt < 24; ++nt) {
        const float2 q = *reinterpret_cast<const float2*>(at(hf, nt));
        const float s0 = o[nt][2 * hf] + q.x, s1 = o[nt][2 * hf + 1] + q.y;
        if (cl > 1) {
          *reinterpret_cast<float2*>(at(hf, nt)) = make_float2(s0, s1);  // this CTA's partial tile
        } else if (m < M) {
          const int c = 8 * nt + 2 * t4;
          *reinterpret_cast<float2*>(out + (size_t)m * kFfnWidth + c) = make_float2(s0 + b2[c], s1 + b2[c + 1]);
        }
      }
    }
  }
  if (cl > 1) cluster_sum<float, L::kRows, L::kThreads>(part, cl, b2, out, m0, M);
}

// ------------------------------------------------------------------ launch

template <typename T, auto kernel>
static int launch_geglu(int rows, int threads, size_t smem, const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, int M, int I, int cl, cudaStream_t stream) {
  // the opt-in to more than 48 KB of shared memory is set once per
  // process and kernel (a thread-safe static)
  static const cudaError_t attr_err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(((M + rows - 1) / rows) * cl));
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cl > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x), static_cast<const T*>(w1),
                                             static_cast<const float*>(b1), static_cast<const T*>(w2),
                                             static_cast<const float*>(b2), static_cast<T*>(out), M, I, cl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace said

// x (M, C); w1 (2I, C); b1 (2I,) f32; w2 (C, I); b2 (C,) f32; out (M, C);
// all contiguous, x, w1, w2 and out 16-byte aligned. C = 192, I a multiple
// of 64. The plan: rows per block (64, or 128 for bf16) and cluster size
// (1, 2 or 4 blocks sharing one row tile's inner units).
extern "C" int said_geglu_ffn(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                              void* out, int M, int C, int I, int dtype, int tile_rows, int cluster,
                              void* stream) {
  if (M <= 0 || C != said::kFfnWidth || I <= 0 || I % 64 != 0 || (cluster != 1 && cluster != 2 && cluster != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == said::kFloat32 && tile_rows == 64)
    return said::launch_geglu<float, said::geglu_ffn_f32_kernel>(64, said::F32Ffn::kThreads, said::F32Ffn::kSmem,
                                                                 x, w1, b1, w2, b2, out, M, I, cluster, s);
  if (dtype == said::kBFloat16 && tile_rows == 64)
    return said::launch_geglu<__nv_bfloat16, said::geglu_ffn_bf16_kernel<1>>(
        64, said::Bf16Ffn<1>::kThreads, said::Bf16Ffn<1>::kSmem, x, w1, b1, w2, b2, out, M, I, cluster, s);
  if (dtype == said::kBFloat16 && tile_rows == 128)
    return said::launch_geglu<__nv_bfloat16, said::geglu_ffn_bf16_kernel<2>>(
        128, said::Bf16Ffn<2>::kThreads, said::Bf16Ffn<2>::kSmem, x, w1, b1, w2, b2, out, M, I, cluster, s);
  return (int)cudaErrorInvalidValue;
}
