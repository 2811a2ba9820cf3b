// Stride-2 VALID conv1d + exact-erf GELU for the wav2vec2 feature
// extractor (conv_1 ... conv_6: K in {2, 3}, 512 -> 512 channels, no bias),
// on Hopper's tensor cores.
//
// Replaces the TPU kernel strided_conv_gelu_pallas
// (said_tpu/ops/pallas_conv.py:133): out[b, t] = gelu(Σ_j x[b, 2t + j] @ W_j)
// with f32 accumulation and the GELU in f32, stored in x's dtype.
//
// Layout: the TPU kernel merges sample pairs into lanes (X2 = x viewed as
// (B, T_in/2, 2·C_in); h = X2[:, t] @ W01 + X2[:, t+1, :C_in] @ W2). In
// device memory the same thing is simpler still: the K·C_in inputs of
// output row t are ONE contiguous run, x[b, 2t : 2t+K, :] (pair row t and
// the first half of pair row t+1), and neighbouring rows start 2·C_in
// apart. So the conv is a plain GEMM whose A rows are overlapping windows
// of x, read in place with 16-byte cp.async copies (no gather, no im2col),
// against the weight packed once by the module as Wt (C_out, K·C_in),
// Wt[n, j·C_in + c] = kernel[j, c, n]: both operands K-major. The
// contraction is 1536 (K = 3) or 1024 (K = 2). A row past T_out is
// zero-filled (cp.async with src-size 0); a real row never reads past
// T_in, so an odd T_in's half pair needs nothing more.
//
// What bounds it on the card: the products. conv_1 of a 10-s clip is
// 2·15999·512·1536 = 25.2 GFLOP against 50 MB of f32 (25 bf16) traffic:
// 0.0255 ms at 989 TFLOP/s in bf16, 0.153 ms at the 3xTF32 rate in f32.
// Both dtypes therefore run on the tensor cores, with 128×128 output
// tiles (4 of them across C_out = 512, adjacent in the grid so that the
// four blocks sharing an A tile run together and read it from L2), a ring
// of shared-memory stages filled by cp.async so later stages load while
// the current one is multiplied, and two blocks an SM:
//
//   bf16 (wgmma): two warpgroups, 64 rows each; stages of 64 contraction
//   columns, A and B tiles as 128-byte rows under the 128-byte swizzle
//   that the wgmma descriptors name; four m64n128k16 products from
//   shared memory a stage; a ring of 3 stages (96 KB).
//
//   f32 (3xTF32 on mma.sync.m16n8k8): 8 warps, 64×32 outputs each; stages
//   of 16 columns in rows padded to 24 floats (the fragment loads are
//   free of bank conflicts); within each 8-wide k-step a thread's two
//   values are adjacent (one 8-byte load, the same permutation on A and
//   B). Each operand is split into hi and lo = x − hi, both masked to
//   tf32's 19 bits, and a·b ≈ lo·hi + hi·lo + hi·hi, into one tensor-core
//   accumulator chain over the contraction; a ring of 4 stages (96 KB).
//   The chain's accumulation is where the f32 route's error comes from:
//   about 1.2e-5 of max |plain| at 1536 columns on an NVIDIA H100 80GB
//   HBM3 at 700 W (chip_smoke.py phase 2), where the same arithmetic with round-to-nearest adds lands
//   under 1e-6 (emulated in tests/test_torch_ops.py). Joining each k-step's
//   products to the output by f32 adds, as the f32 GEGLU does, held the
//   error near the latter in trials, but its registers (spilled at two
//   blocks an SM) and adds made the kernel slower than the time it is held
//   to; the chain stays well inside the 1e-4 bound.
//
// The epilogue applies GELU (erff) in f32 to the accumulators and stores
// once in x's dtype. Filling the card: conv_4 … conv_6 of a 10-s clip have
// 64 down to 16 output tiles, which would leave SMs idle while each block
// walks the whole contraction (96 stages in f32). Where the tiles are fewer
// than 128, a thread-block cluster of 2, 4 or 8 blocks splits the
// contraction of one tile; the
// partial 128×128 f32 tiles meet in the stage buffers and are added
// through distributed shared memory in rank order before the GELU (one
// launch, no atomics). The host picks the split from the tile count
// (ops/conv.py::conv_plan). Widths the tiles do not take (C_in % 64 ≠ 0 or
// C_out % 128 ≠ 0: only the tiny test encoders) run a shared-memory SGEMM
// on the f32 FMA pipes, 64×64 tiles, chosen on the host by shape
// (ops/conv.py::conv_plan). No atomics: two calls give the same bits.
#include "hopper.cuh"

#include <cooperative_groups.h>

namespace said {

namespace cg = cooperative_groups;

constexpr int kConvTile = 128;  // output rows and columns a block (tensor-core routes)
constexpr int kPartStride = kConvTile + 4;  // floats a row of a partial tile

// The cluster's sum, for plans that split the contraction over a cluster
// of `split` blocks: every rank has left its partial 128×128 f32 tile in
// its shared memory (part); rank r adds rows [r·128/split, (r+1)·128/split)
// of every rank's tile, in rank order, applies the GELU and stores.
template <typename T>
__device__ __forceinline__ void cluster_gelu_store(const float* part, int split, T* __restrict__ out, int m0, int n0,
                                                   int M, int C_out) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial tile is written
  const int rank = (int)cluster.block_rank();
  const int rows = kConvTile / split, r0 = rank * rows;
  for (int idx = threadIdx.x; idx < rows * (kConvTile / 4); idx += blockDim.x) {
    const int r = r0 + idx / (kConvTile / 4), c = 4 * (idx % (kConvTile / 4));
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < split; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + r * kPartStride + c);
      sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
    }
    const int m = m0 + r;
    if (m < M) {
      T* dst = out + (size_t)m * C_out + n0 + c;
      dst[0] = from_f32<T>(gelu_erf(sum.x));
      dst[1] = from_f32<T>(gelu_erf(sum.y));
      dst[2] = from_f32<T>(gelu_erf(sum.z));
      dst[3] = from_f32<T>(gelu_erf(sum.w));
    }
  }
  cluster.sync();  // no rank leaves while another still reads its shared memory
}

// a row of the GEMM's A operand: where its window of x starts, and whether
// the row exists (rows past M are zero-filled)
struct ConvRow {
  const void* a;
  bool ok;
};

template <typename T>
__device__ __forceinline__ ConvRow conv_a_row(const T* x, int m, int M, int T_in, int T_out, int C_in) {
  if (m >= M) return {x, false};
  const int b = m / T_out, t = m - b * T_out;
  return {x + ((size_t)b * T_in + 2 * (size_t)t) * C_in, true};
}

// ------------------------------------------------------------------ bf16: wgmma

struct Bf16Conv {
  static constexpr int kBK = 64;                 // contraction columns a stage: one 128-byte row
  static constexpr int kStages = 3;
  static constexpr int kThreads = 256;           // two warpgroups
  static constexpr int kTileBytes = kConvTile * 128;
  static constexpr int kStageBytes = 2 * kTileBytes;  // A, then B
  static constexpr size_t kSmem = kStages * kStageBytes + 1024;  // + slack to align the base
  static_assert(kConvTile * kPartStride * 4 <= kStages * kStageBytes, "the partial tile reuses the stages");
};

__global__ void __launch_bounds__(Bf16Conv::kThreads, 2)
strided_conv_gelu_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                              __nv_bfloat16* __restrict__ out, int T_in, int T_out, int C_in, int C_out, int KD,
                              int M, int n_tiles, int split) {
  using L = Bf16Conv;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);  // 1024-byte aligned: [stage][A | B][128][128 B]

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tile = blockIdx.x / split, rank = blockIdx.x % split;
  const int m0 = (tile / n_tiles) * kConvTile, n0 = (tile % n_tiles) * kConvTile;

  // this thread's copies: chunk c of rows r0 + 32i, i < 4, of both tiles
  const int c = tid & 7, r0 = tid >> 3;
  const __nv_bfloat16* a_src[4];
  const __nv_bfloat16* b_src[4];
  bool a_ok[4];
  uint32_t dst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 32 * i;
    const ConvRow a = conv_a_row(x, m0 + r, M, T_in, T_out, C_in);
    a_src[i] = static_cast<const __nv_bfloat16*>(a.a) + 8 * c;
    a_ok[i] = a.ok;
    b_src[i] = w + (size_t)(n0 + r) * KD + 8 * c;
    dst[i] = swizzle128(r, c);
  }
  auto load = [&](int stage, int k0) {
    const uint32_t s = base + stage * L::kStageBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cp_async16(s + dst[i], a_src[i] + (a_ok[i] ? k0 : 0), a_ok[i]);
      cp_async16(s + L::kTileBytes + dst[i], b_src[i] + k0, true);
    }
  };

  // this rank's stages of the contraction
  const int k_begin = rank * (KD / L::kBK) / split, nk = (rank + 1) * (KD / L::kBK) / split - k_begin;
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < nk) load(s, (k_begin + s) * L::kBK);
    cp_async_commit();
  }

  float acc[64];  // rows 16·warp + g (+8): element 4j + 2·half + e is column 8j + 2·t4 + e
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<L::kStages - 2>();  // this thread's copies of stage kt have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have, and every warpgroup is done with stage kt − 1
    if (kt + L::kStages - 1 < nk)
      load((kt + L::kStages - 1) % L::kStages, (k_begin + kt + L::kStages - 1) * L::kBK);
    cp_async_commit();
    const uint32_t s = base + (kt % L::kStages) * L::kStageBytes;
    const uint64_t desc_a = gmma_desc(s + wg * 64 * 128, 1024, 1);
    const uint64_t desc_b = gmma_desc(s + L::kTileBytes, 1024, 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_ss(acc, desc_a + 2 * kk, desc_b + 2 * kk, 1);  // +32 bytes a k16 step
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  if (split == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + 16 * warp + g + 8 * h;
      if (m >= M) continue;
      __nv_bfloat16* row = out + (size_t)m * C_out + n0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(gelu_erf(acc[4 * j + 2 * h]), gelu_erf(acc[4 * j + 2 * h + 1]));
    }
    return;
  }
  __syncthreads();  // every warpgroup is done with the stages the partial tile overwrites
  float* part = reinterpret_cast<float*>(smem_raw + (base - raw));
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(part + (64 * wg + 16 * warp + g + 8 * h) * kPartStride + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  cluster_gelu_store(part, split, out, m0, n0, M, C_out);
}

// ------------------------------------------------------------------ f32: 3xTF32

struct F32Conv {
  static constexpr int kBK = 16;       // contraction columns a stage
  static constexpr int kStages = 4;
  static constexpr int kThreads = 256;  // 8 warps: 2 (rows) × 4 (columns), 64×32 outputs each
  static constexpr int kStride = 24;    // floats a staged row: 16 + 8 of pad
  static constexpr int kTile = kConvTile * kStride;
  static constexpr int kStage = 2 * kTile;  // A, then B
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(kConvTile * kPartStride <= kStages * kStage, "the partial tile reuses the stages");
};

__global__ void __launch_bounds__(F32Conv::kThreads, 2)
strided_conv_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                             int T_in, int T_out, int C_in, int C_out, int KD, int M, int n_tiles, int split) {
  using L = F32Conv;
  extern __shared__ __align__(16) float smem[];  // [stage][A | B][128][kStride]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // rows 64·wm, columns 32·wn of the tile
  const int tile = blockIdx.x / split, rank = blockIdx.x % split;
  const int m0 = (tile / n_tiles) * kConvTile, n0 = (tile % n_tiles) * kConvTile;

  // this thread's copies: chunk c of rows r0 + 64i, i < 2, of both tiles
  const int c = tid & 3, r0 = tid >> 2;
  const float* a_src[2];
  const float* b_src[2];
  bool a_ok[2];
  int dst[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 64 * i;
    const ConvRow a = conv_a_row(x, m0 + r, M, T_in, T_out, C_in);
    a_src[i] = static_cast<const float*>(a.a) + 4 * c;
    a_ok[i] = a.ok;
    b_src[i] = w + (size_t)(n0 + r) * KD + 4 * c;
    dst[i] = r * L::kStride + 4 * c;
  }
  auto load = [&](int stage, int k0) {
    float* s = smem + stage * L::kStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cp_async16(smem_addr(s + dst[i]), a_src[i] + (a_ok[i] ? k0 : 0), a_ok[i]);
      cp_async16(smem_addr(s + L::kTile + dst[i]), b_src[i] + k0, true);
    }
  };

  // this rank's stages of the contraction
  const int k_begin = rank * (KD / L::kBK) / split, nk = (rank + 1) * (KD / L::kBK) / split - k_begin;
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < nk) load(s, (k_begin + s) * L::kBK);
    cp_async_commit();
  }

  // acc[mt][nt]: rows 64·wm + 16·mt + g (elements 0, 1) and + 8 (2, 3),
  // columns 32·wn + 8·nt + 2·t4 (+1)
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // stage kt has landed for everyone; everyone is done with stage kt − 1
    if (kt + L::kStages - 1 < nk)
      load((kt + L::kStages - 1) % L::kStages, (k_begin + kt + L::kStages - 1) * L::kBK);
    cp_async_commit();
    const float* as = smem + (kt % L::kStages) * L::kStage + (64 * wm + g) * L::kStride + 2 * t4;
    const float* bs = smem + (kt % L::kStages) * L::kStage + L::kTile + (32 * wn + g) * L::kStride + 2 * t4;
#pragma unroll
    for (int ks = 0; ks < L::kBK / 8; ++ks) {
      // logical k = t4 and t4 + 4 of this k-step are columns 8·ks + 2·t4 and + 1
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 v = *reinterpret_cast<const float2*>(bs + 8 * nt * L::kStride + 8 * ks);
        split_tf32_trunc(v.x, bh[nt][0], bl[nt][0]);
        split_tf32_trunc(v.y, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float2 lo = *reinterpret_cast<const float2*>(as + 16 * mt * L::kStride + 8 * ks);
        const float2 hi = *reinterpret_cast<const float2*>(as + (16 * mt + 8) * L::kStride + 8 * ks);
        const float a[4] = {lo.x, hi.x, lo.y, hi.y};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_trunc(a[e], ah[e], al[e]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_3xtf32(acc[mt][nt], ah, al, bh[nt][0], bl[nt][0], bh[nt][1], bl[nt][1]);
      }
    }
  }

  if (split == 1) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wm + 16 * mt + g + 8 * h;
        if (m >= M) continue;
        float* row = out + (size_t)m * C_out + n0 + 32 * wn + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(row + 8 * nt) =
              make_float2(gelu_erf(acc[mt][nt][2 * h]), gelu_erf(acc[mt][nt][2 * h + 1]));
      }
    return;
  }
  __syncthreads();  // every warp is done with the stages the partial tile overwrites
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(smem + (64 * wm + 16 * mt + g + 8 * h) * kPartStride + 32 * wn + 8 * nt + 2 * t4) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  cluster_gelu_store(smem, split, out, m0, n0, M, C_out);
}

// ------------------------------------------------ any width: f32 FMA pipes

constexpr int kFmaBM = 64, kFmaBN = 64, kFmaBK = 16, kFmaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
strided_conv_gelu_fma_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int T_in,
                             int T_out, int C_in, int C_out, int KD, int M) {
  __shared__ float As[kFmaBK][kFmaBM + 4];  // transposed A tile: [k][m]
  __shared__ float Bs[kFmaBK][kFmaBN];      // [k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 x 16 threads, 4 x 4 outputs each
  const int m0 = blockIdx.y * kFmaBM, n0 = blockIdx.x * kFmaBN;

  // A loader: row a_row of the tile, 4 consecutive k from a_k
  const int a_row = tid / 4, a_k = (tid % 4) * 4;
  const ConvRow a = conv_a_row(x, m0 + a_row, M, T_in, T_out, C_in);
  const T* a_ptr = static_cast<const T*>(a.a);
  // B loader: k-row b_k of the tile, 4 consecutive n from b_n
  const int b_k = tid / 16, b_n = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < KD; k0 += kFmaBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + a_k + i;
      As[a_k + i][a_row] = (a.ok && k < KD) ? to_f32(a_ptr[k]) : 0.0f;
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + b_n + j;
      Bs[b_k][b_n + j] = (kb < KD && n < C_out) ? to_f32(w[(size_t)n * KD + kb]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < C_out) out[(size_t)m * C_out + n] = from_f32<T>(gelu_erf(acc[i][j]));
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename T, auto kernel>
static int launch_tiles(size_t smem, const void* x, const void* w, void* out, int T_in, int T_out, int C_in,
                        int C_out, int KD, int M, int split, cudaStream_t stream) {
  // the opt-ins (more than 48 KB of shared memory; all of the SM's
  // carve-out for it, so two blocks fit) are set once per process and kernel
  static const cudaError_t attr_err = [&] {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int n_tiles = C_out / kConvTile;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(((M + kConvTile - 1) / kConvTile) * n_tiles * split));
  config.blockDim = dim3(256);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x), static_cast<const T*>(w),
                                             static_cast<T*>(out), T_in, T_out, C_in, C_out, KD, M, n_tiles, split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_fma(const void* x, const void* w, void* out, int T_in, int T_out, int C_in, int C_out, int KD,
                      int M, cudaStream_t stream) {
  const dim3 grid((C_out + kFmaBN - 1) / kFmaBN, (M + kFmaBM - 1) / kFmaBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  strided_conv_gelu_fma_kernel<T><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), T_in, T_out, C_in, C_out, KD, M);
  return (int)cudaGetLastError();
}

}  // namespace said

// x (B, T_in, C_in); w (C_out, K·C_in), the (K, C_in, C_out) kernel packed
// K-major (w[n, j·C_in + c] = kernel[j, c, n]); out (B, T_out, C_out),
// T_out = (T_in − K) / 2 + 1; all contiguous. route 1: the tensor cores
// (C_in % 64 == 0, C_out % 128 == 0, x and w 16-byte aligned), the
// contraction split over clusters of `split` blocks (1, 2, 4 or 8);
// route 0: the FMA pipes (any width; split 1).
extern "C" int said_strided_conv_gelu(const void* x, const void* w, void* out, int B, int T_in, int T_out,
                                      int C_in, int C_out, int K, int dtype, int route, int split, void* stream) {
  if (B <= 0 || T_out <= 0 || C_in <= 0 || C_out <= 0 || K <= 0 || 2 * (T_out - 1) + K > T_in ||
      (long long)B * T_out > 0x7fffffffLL || (long long)K * C_in > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (route == 1 && (C_in % 64 != 0 || C_out % said::kConvTile != 0)) return (int)cudaErrorInvalidValue;
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
  if (split != 1 && (route != 1 || (split != 2 && split != 4 && split != 8))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T_out, KD = K * C_in;
  if (dtype == said::kFloat32) {
    if (route == 1)
      return said::launch_tiles<float, said::strided_conv_gelu_f32_kernel>(said::F32Conv::kSmem, x, w, out, T_in,
                                                                           T_out, C_in, C_out, KD, M, split, s);
    return said::launch_fma<float>(x, w, out, T_in, T_out, C_in, C_out, KD, M, s);
  }
  if (dtype == said::kBFloat16) {
    if (route == 1)
      return said::launch_tiles<__nv_bfloat16, said::strided_conv_gelu_bf16_kernel>(
          said::Bf16Conv::kSmem, x, w, out, T_in, T_out, C_in, C_out, KD, M, split, s);
    return said::launch_fma<__nv_bfloat16>(x, w, out, T_in, T_out, C_in, C_out, KD, M, s);
  }
  return (int)cudaErrorInvalidValue;
}
