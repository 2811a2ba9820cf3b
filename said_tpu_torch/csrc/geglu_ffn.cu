// Fused GEGLU feed-forward for the UNet transformer blocks.
//
// Replaces the TPU kernel geglu_ffn_pallas (said_tpu/ops/pallas_ffn.py:87):
//   h = x @ W1^T + b1          (C -> 2I, f32 accumulation)
//   y = a * gelu_erf(g)        (a = h[:, :I], g = h[:, I:], f32)
//   out = y @ W2^T + b2        (I -> C, f32 accumulation)
// with the (rows, 2I) projection kept on chip: it never goes to device
// memory, which is what the TPU kernel exists to do.
//
// What bounds it on the card: arithmetic. At the main path's shape
// (1200 rows, C=192, I=768) one call is 1.06 GFLOP against 0.9 MB of
// activations plus 1.8 MB of f32 weights, far above the ridge point;
// this first version runs on the f32 FMA pipes (no tensor cores), so
// the f32 path keeps full f32 products like the plain twin.
//
// Design: one block of 256 threads owns BM=16 rows and loops over the
// I inner units in chunks of BN=64. Per chunk it stages W1's a- and
// g-rows and W2's columns in shared memory (transposed, padded by one
// word against bank conflicts), forms a and g for its 16 rows x 64 units
// (4 rows x 1 unit x {a,g} per thread), applies the GELU gate in f32,
// parks y in shared memory, and accumulates y @ W2-chunk into a
// (16 x C) f32 register accumulator (4 rows x C/64 columns per thread).
// Weights are read in the torch layout (W1 (2I, C), W2 (C, I)), so no
// transpose is kept in device memory. For bf16 inputs y is rounded to
// bf16 before the second product, as the plain twin does.
#include "common.cuh"

namespace said {

constexpr int kFfnRows = 16;    // BM
constexpr int kFfnChunk = 64;   // BN, inner units per chunk
constexpr int kFfnThreads = 256;
constexpr int kFfnWidth = 192;  // C: the UNet's model_channels, the only width on the path

template <typename T>
__global__ void __launch_bounds__(kFfnThreads)
geglu_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int M,
                 int I) {
  constexpr int C = kFfnWidth;
  constexpr int NC = C / 64;  // output columns per thread
  constexpr int BM = kFfnRows, BN = kFfnChunk;
  constexpr int BNP = BN + 1;  // padded row of the transposed W1 chunk
  constexpr int CP = C + 1;    // padded row of the transposed W2 chunk
  extern __shared__ float smem[];
  float* xs = smem;                 // [BM][C]
  float* w1a = xs + BM * C;         // [C][BNP]
  float* w1g = w1a + C * BNP;       // [C][BNP]
  float* w2s = w1g + C * BNP;       // [BN][CP]
  float* ys = w2s + BN * CP;        // [BM][BN]

  const int tid = threadIdx.x;
  const int col = tid % BN;         // inner unit (phase A) / column (phase B)
  const int r0 = (tid / BN) * 4;    // first of this thread's 4 rows
  const int m0 = blockIdx.x * BM;

  for (int idx = tid; idx < BM * C; idx += kFfnThreads) {
    const int r = idx / C, k = idx % C;
    xs[idx] = (m0 + r < M) ? to_f32(x[(size_t)(m0 + r) * C + k]) : 0.0f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;

  for (int j0 = 0; j0 < I; j0 += BN) {
    for (int idx = tid; idx < BN * C; idx += kFfnThreads) {
      const int jj = idx / C, k = idx % C;
      w1a[k * BNP + jj] = to_f32(w1[(size_t)(j0 + jj) * C + k]);
      w1g[k * BNP + jj] = to_f32(w1[(size_t)(I + j0 + jj) * C + k]);
    }
    for (int idx = tid; idx < BN * C; idx += kFfnThreads) {
      const int c = idx / BN, jj = idx % BN;
      w2s[jj * CP + c] = to_f32(w2[(size_t)c * I + j0 + jj]);
    }
    __syncthreads();

    // Phase A: a and g for 4 rows x 1 inner unit, then the GELU gate.
    float a[4] = {0.f, 0.f, 0.f, 0.f}, g[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      const float wa = w1a[k * BNP + col];
      const float wg = w1g[k * BNP + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = xs[(r0 + i) * C + k];
        a[i] = fmaf(xv, wa, a[i]);
        g[i] = fmaf(xv, wg, g[i]);
      }
    }
    const float ba = b1[j0 + col], bg = b1[I + j0 + col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float y = (a[i] + ba) * gelu_erf(g[i] + bg);
      ys[(r0 + i) * BN + col] = to_f32(from_f32<T>(y));
    }
    __syncthreads();

    // Phase B: acc (4 rows x NC columns) += y (4 x BN) @ W2-chunk (BN x C).
#pragma unroll 4
    for (int k = 0; k < BN; ++k) {
      float wv[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) wv[n] = w2s[k * CP + col + 64 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float yv = ys[(r0 + i) * BN + k];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(yv, wv[n], acc[i][n]);
      }
    }
    __syncthreads();  // before the next chunk overwrites the staging buffers
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + i;
    if (m >= M) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = col + 64 * n;
      out[(size_t)m * C + c] = from_f32<T>(acc[i][n] + b2[c]);
    }
  }
}

template <typename T>
static int launch_geglu(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, int M,
                        int I, cudaStream_t stream) {
  constexpr int C = kFfnWidth;
  constexpr size_t smem =
      sizeof(float) * (kFfnRows * C + 2 * C * (kFfnChunk + 1) +
                       kFfnChunk * (C + 1) + kFfnRows * kFfnChunk);
  auto kernel = geglu_ffn_kernel<T>;
  // The opt-in to more than 48 KB of shared memory is set once per
  // process (a thread-safe static), not on every launch; the port runs on
  // one card, and a launch on another would fail and be reported.
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int grid = (M + kFfnRows - 1) / kFfnRows;
  kernel<<<grid, kFfnThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out), M, I);
  return (int)cudaGetLastError();
}

}  // namespace said

// x (M, C); w1 (2I, C); b1 (2I,) f32; w2 (C, I); b2 (C,) f32; out (M, C).
// C = 192, I a multiple of 64; all contiguous.
extern "C" int said_geglu_ffn(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out,
                              int M, int C, int I, int dtype, void* stream) {
  if (M <= 0 || C != said::kFfnWidth || I <= 0 || I % said::kFfnChunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == said::kFloat32)
    return said::launch_geglu<float>(x, w1, b1, w2, b2, out, M, I, s);
  if (dtype == said::kBFloat16)
    return said::launch_geglu<__nv_bfloat16>(x, w1, b1, w2, b2, out, M, I, s);
  return (int)cudaErrorInvalidValue;
}
