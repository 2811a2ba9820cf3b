// Flash attention over packed (B, T, H·D) projections, for Hopper.
//
// Replaces both TPU kernels of said_tpu/ops/pallas_attention.py:
// _flash_tpu_packed (:186, K1: the whole key axis per grid step) and
// _flash_tpu_packed_blocked (:322, K2: the key axis streamed in blocks
// under a precomputed exp2 shift). Here every key length is streamed in
// 64-key tiles with an online softmax (running max, running sum and the
// output accumulator in f32 registers, one division at the end), so one
// kernel serves both: the split existed only for the TPU's VMEM.
//
// Numerics, as K1: Q is scaled by d^-1/2 · log2(e) in f32 and rounded to
// the input dtype before the product; scores are f32 sums of products;
// p = exp2(s − m); p is rounded to V's dtype before the PV product and the
// denominator sums the same rounded p (K1 gets it from a ones column of
// V). Optional (B,) lengths: keys at or past a row's length are masked and
// the tiles past it skipped, query rows at or past it are written as 0, and
// a length-0 row gives zeros (never 0/0).
//
// What bounds it on the card: arithmetic. At the UNet's (2, 3600, 6×32)
// one call is 4·B·H·T·S·D = 2.0e10 FLOP (0.30 ms at the 67 TFLOP/s f32 FMA
// rate) against 22 MB of q, k, v and out (7 µs at 3.35 TB/s); in bf16 the
// B·H·T·S = 1.6e8 exp2 at ~3.9e12/s (0.040 ms) bind, not the tensor
// cores (0.020 ms), because the head dim is 32. This first version runs
// both dtypes on the f32 FMA pipes (bf16 is widened when staged), so its
// ceiling is the f32 rate; mma.sync/wgmma for bf16 are later work.
//
// Design: one block of 128 threads per (64-row query tile, head, batch).
// The block stages its scaled Q tile once, then for each 64-key tile
// stages K and V (f32, zero past the valid keys) in shared memory. Thread
// (rg = tid / 8, cg = tid % 8) owns query rows rg + 16·i (i < 4), score
// columns cg + 8·j (j < 8), and output columns 4·cg + 32·q + e. Rows and
// columns are interleaved so that the float4 reads of Q, K, P and V fall
// on distinct banks; the 8 threads sharing a row are adjacent lanes, so a
// row's max and sum are three xor-shuffles. P goes through shared memory
// between the two products. Offsets into q/k/v/out are 64-bit.
#include "common.cuh"

#include <math.h>

namespace said {

constexpr int kAttnRows = 64;     // query rows per block
constexpr int kAttnKeys = 64;     // keys per staged tile
constexpr int kAttnThreads = 128;

template <int D>
struct AttnLayout {
  static constexpr int QST = D + 4;           // padded row strides, in floats
  static constexpr int KST = D + 4;           // (multiples of 4 for float4)
  static constexpr int VST = D;
  static constexpr int PST = kAttnKeys + 8;
  static constexpr int NQ = D / 32;           // float4 output groups per thread
  static constexpr size_t bytes =
      sizeof(float) * (kAttnRows * QST + kAttnKeys * KST + kAttnKeys * VST + kAttnRows * PST);
};

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const int* __restrict__ lengths, int T_len, int S_len,
                       int H, float q_scale) {
  using L = AttnLayout<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // [64][QST]
  float* ks = qs + kAttnRows * L::QST;        // [64][KST]
  float* vs = ks + kAttnKeys * L::KST;        // [64][VST]
  float* ps = vs + kAttnKeys * L::VST;        // [64][PST]

  const int tid = threadIdx.x;
  const int cg = tid & 7, rg = tid >> 3;
  const int q0 = blockIdx.x * kAttnRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t inner = (size_t)H * D;
  const size_t head = (size_t)h * D;

  int q_len = T_len, kv_len = S_len;
  if (lengths != nullptr) {
    const int n = max(lengths[b], 0);
    q_len = min(n, T_len);
    kv_len = min(n, S_len);
  }

  // A tile wholly at or past the row's length: zeros, nothing computed.
  if (q0 >= q_len) {
    for (int idx = tid; idx < kAttnRows * D; idx += kAttnThreads) {
      const int r = idx / D, d = idx % D;
      if (q0 + r < T_len)
        out[((size_t)b * T_len + q0 + r) * inner + head + d] = from_f32<T>(0.0f);
    }
    return;
  }

  for (int idx = tid; idx < kAttnRows * D; idx += kAttnThreads) {
    const int r = idx / D, d = idx % D;
    float x = 0.0f;
    if (q0 + r < T_len) {
      const float raw = to_f32(q[((size_t)b * T_len + q0 + r) * inner + head + d]);
      x = round_to(raw * q_scale, T{});
    }
    qs[r * L::QST + d] = x;
  }

  float m[4], l[4], o[4][4 * L::NQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * L::NQ; ++c) o[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kAttnKeys) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kAttnKeys * D; idx += kAttnThreads) {
      const int r = idx / D, d = idx % D;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < kv_len) {
        const size_t off = ((size_t)b * S_len + k0 + r) * inner + head + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[r * L::KST + d] = kx;
      vs[r * L::VST + d] = vx;
    }
    __syncthreads();

    // S = Q K^T for rows rg + 16i, columns cg + 8j (exp2 units).
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(rg + 16 * i) * L::QST + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[(cg + 8 * j) * L::KST + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // Online softmax update of each row; P (rounded to V's dtype) to smem.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (k0 + cg + 8 * j >= kv_len) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // m_new = -inf only if every key so far was masked: keep the state
      // (all zeros) instead of forming exp2(-inf - -inf) = NaN.
      const float alpha = (m_new == -INFINITY) ? 1.0f : exp2f(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.0f : round_to(exp2f(s[i][j] - m_new), T{});
        sum += p;
        ps[(rg + 16 * i) * L::PST + cg + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * L::NQ; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V for rows rg + 16i, columns 4cg + 32q + e.
#pragma unroll 2
    for (int j = 0; j < kAttnKeys; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(rg + 16 * i) * L::PST + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < L::NQ; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[(j + jj) * L::VST + 4 * cg + 32 * g]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
            o[i][4 * g + 0] = fmaf(p, vv.x, o[i][4 * g + 0]);
            o[i][4 * g + 1] = fmaf(p, vv.y, o[i][4 * g + 1]);
            o[i][4 * g + 2] = fmaf(p, vv.z, o[i][4 * g + 2]);
            o[i][4 * g + 3] = fmaf(p, vv.w, o[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= T_len) continue;
    const bool live = row < q_len && l[i] > 0.0f;
    const float inv = live ? 1.0f / l[i] : 0.0f;
    T* dst = out + ((size_t)b * T_len + row) * inner + head;
#pragma unroll
    for (int g = 0; g < L::NQ; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[4 * cg + 32 * g + e] = from_f32<T>(live ? o[i][4 * g + e] * inv : 0.0f);
  }
}

template <typename T, int D>
static int launch_flash(const void* q, const void* k, const void* v, void* out,
                        const int* lengths, int B, int T_len, int S_len, int H,
                        cudaStream_t stream) {
  constexpr size_t smem = AttnLayout<D>::bytes;
  auto kernel = flash_attention_kernel<T, D>;
  // Set once per process (a thread-safe static): at D = 64 the tiles
  // need 68 KB, above the 48 KB a launch gets without opting in.
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  // the JAX kernels' scale: d^-1/2 · log2(e) in double, rounded to f32
  const float q_scale = (float)(pow((double)D, -0.5) * 1.4426950408889634);
  const dim3 grid((T_len + kAttnRows - 1) / kAttnRows, H, B);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lengths, T_len, S_len, H, q_scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_head_dim(const void* q, const void* k, const void* v, void* out,
                             const int* lengths, int B, int T_len, int S_len, int H,
                             int D, cudaStream_t stream) {
  if (D == 32) return launch_flash<T, 32>(q, k, v, out, lengths, B, T_len, S_len, H, stream);
  if (D == 64) return launch_flash<T, 64>(q, k, v, out, lengths, B, T_len, S_len, H, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace said

// q, out (B, T, H·D); k, v (B, S, H·D); all contiguous, one dtype;
// lengths: null or (B,) int32 on the device. D ∈ {32, 64}.
extern "C" int said_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, const void* lengths, int B, int T,
                                    int S, int H, int D, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == said::kFloat32)
    return said::dispatch_head_dim<float>(q, k, v, out, lens, B, T, S, H, D, st);
  if (dtype == said::kBFloat16)
    return said::dispatch_head_dim<__nv_bfloat16>(q, k, v, out, lens, B, T, S, H, D, st);
  return (int)cudaErrorInvalidValue;
}
