// Stride-2 VALID conv1d + exact-erf GELU for the wav2vec2 feature
// extractor (conv_1 ... conv_6: K in {2, 3}, 512 -> 512 channels, no bias).
//
// Replaces the TPU kernel strided_conv_gelu_pallas
// (said_tpu/ops/pallas_conv.py:133). Written as an implicit GEMM:
// output row t of batch b reads the CONTIGUOUS K*C_in slice that starts
// at x[b, 2t, 0] (channels-last input, stride 2), multiplied by the
// weight reshaped to (K*C_in, C_out), with GELU in the f32 epilogue:
//   out[b, t, :] = gelu( x[b, 2t : 2t+K, :].flatten() @ Wmat )
// For K=3 neighbouring rows overlap by one input frame; each block reads
// its own rows from device memory (the TPU kernel's halo carried across
// sequential grid steps has no counterpart: CUDA blocks run in no order).
//
// What bounds it on the card: arithmetic. conv_1 at a 32k-sample input
// is 2 x 16k x 512 x 1536 = 25 GFLOP against ~50 MB of f32 traffic.
// This first version is a classic shared-memory SGEMM on the f32 FMA
// pipes: 64x64 output tile per 256-thread block, 4x4 outputs per thread,
// K-steps of 16 staged in shared memory, so the f32 path keeps full f32
// products like the plain twin. Rows past M and columns past C_out are
// masked, so any T_in >= K and any C_out work.
#include "common.cuh"

namespace said {

constexpr int kConvBM = 64, kConvBN = 64, kConvBK = 16, kConvThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
strided_conv_gelu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ out, int T_in, int T_out, int C_in,
                         int C_out, int KD, int M) {
  __shared__ float As[kConvBK][kConvBM + 4];  // transposed A tile: [k][m]
  __shared__ float Bs[kConvBK][kConvBN];      // [k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 x 16 threads, 4 x 4 each
  const int m0 = blockIdx.y * kConvBM, n0 = blockIdx.x * kConvBN;

  // A loader: row a_row of the tile, 4 consecutive k from a_k.
  const int a_row = tid / 4, a_k = (tid % 4) * 4;
  const int m_a = m0 + a_row;
  const bool a_ok = m_a < M;
  const T* a_ptr = x;
  if (a_ok) {
    const int b = m_a / T_out, t = m_a % T_out;
    a_ptr = x + ((size_t)b * T_in + 2 * (size_t)t) * C_in;
  }
  // B loader: k-row b_k of the tile, 4 consecutive n from b_n.
  const int b_k = tid / 16, b_n = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < KD; k0 += kConvBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + a_k + i;
      As[a_k + i][a_row] = (a_ok && k < KD) ? to_f32(a_ptr[k]) : 0.0f;
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + b_n + j;
      Bs[b_k][b_n + j] =
          (kb < KD && n < C_out) ? to_f32(w[(size_t)kb * C_out + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kConvBK; ++kk) {
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

template <typename T>
static int launch_conv(const void* x, const void* w, void* out, int B,
                       int T_in, int T_out, int C_in, int C_out, int K,
                       cudaStream_t stream) {
  const int M = B * T_out;
  const dim3 grid((C_out + kConvBN - 1) / kConvBN, (M + kConvBM - 1) / kConvBM);
  strided_conv_gelu_kernel<T><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      T_in, T_out, C_in, C_out, K * C_in, M);
  return (int)cudaGetLastError();
}

}  // namespace said

// x (B, T_in, C_in); w (K*C_in, C_out) = the (K, C_in, C_out) kernel
// flattened; out (B, T_out, C_out), T_out = (T_in - K) / 2 + 1; all
// contiguous.
extern "C" int said_strided_conv_gelu(const void* x, const void* w, void* out,
                                      int B, int T_in, int T_out, int C_in,
                                      int C_out, int K, int dtype,
                                      void* stream) {
  if (B <= 0 || T_out <= 0 || C_in <= 0 || C_out <= 0 || K <= 0 ||
      2 * (T_out - 1) + K > T_in)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == said::kFloat32)
    return said::launch_conv<float>(x, w, out, B, T_in, T_out, C_in, C_out, K, s);
  if (dtype == said::kBFloat16)
    return said::launch_conv<__nv_bfloat16>(x, w, out, B, T_in, T_out, C_in,
                                            C_out, K, s);
  return (int)cudaErrorInvalidValue;
}
