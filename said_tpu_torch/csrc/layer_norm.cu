// LayerNorm over the last axis for Hopper: a group of lanes per row, the
// row held in registers, the reductions as shuffles within the group.
//
// Replaces the TPU kernel layer_norm_pallas (said_tpu/ops/pallas_norms.py:441,
// K7): per row, the f32 mean, then the variance as Σ(x − mean)²/C about it
// (two passes over the registers, never E[x²] − mean²), then
// y = (x − mean)·rstd·w + b with rstd = 1/sqrt(var + eps), f32 weight and
// bias, x and y in f32 or bf16.
//
// What bounds it on the card: device-memory bandwidth (about 8 flops an
// element): x is read once and y written once. On the path the tensors are
// small (the UNet's (2, T, 192) 12 times a step, 0.9 MB at 10 s in f32), so
// what a call costs there is latency: the launch, one round trip to memory,
// the reductions, the write. The design keeps that chain short and puts the
// whole tensor in flight at once:
//
//   - a row belongs to a group of `lanes` lanes of one warp (a power of two,
//     ≤ 32), each holding `chunks` 16-byte vectors of the row, chunk j of
//     lane l being the row's chunk l + j·lanes (neighbouring lanes read
//     neighbouring 16 bytes). At C = 192 that is 16 lanes × 3 float4 in f32
//     and 8 lanes × 3 in bf16; at C = 512 and 768 in f32, 32 × 4 and 32 × 6.
//     No lane is padded: 192 channels are 48 vectors, not a power-of-two
//     block of 256 lanes with a quarter masked;
//   - the row's loads are all issued before anything waits on them; the
//     sums are a lane's own adds, in the order of its elements, then an xor
//     butterfly over the group (every lane ends with the same bits);
//   - a block holds `rows` rows; the host (ops/norms.py::layer_norm_plan)
//     halves the rows a block until the launch has 2 × 132 blocks where the
//     rows allow it, so every SM holds some of the tensor's loads in flight;
//   - weight and bias are copied into shared memory once a block while the
//     row's loads fly, each thread's share of them issued at once.
//
// A row whose bytes are not whole 16-byte vectors (C·size % 16 ≠ 0) takes
// the scalar route: lanes hold single elements, element l + j·lanes of lane
// l, read from device memory once a pass (the second and third passes hit
// L1), weight and bias read where they are used. It is chosen by shape and
// serves any C ≥ 1. No atomics: two calls give the same bits. The plain
// twin of this reduction order is ops/norms.py::layer_norm_lanes_plain.
#include "common.cuh"

#include <stdint.h>

namespace said {

constexpr int kLnMaxChunks = 8;  // 16-byte vectors a lane holds in the vector route
constexpr int kLnMaxThreads = 256;
constexpr int kLnStageLoads = 8;  // float4 of weight and bias a thread has in flight at once

__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = 1; o < lanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the 16-byte vector q as f32 values, and back
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int V>
__global__ void __launch_bounds__(kLnMaxThreads)
layer_norm_vec_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
                      T* __restrict__ y, int rows, int C, float eps, int lanes) {
  constexpr int kVec = 16 / sizeof(T);  // elements a vector
  extern __shared__ float wb[];         // [C] weight, [C] bias
  const int n = C / kVec;               // vectors a row
  const int lane = threadIdx.x & (lanes - 1);
  const size_t row = (size_t)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const bool ok = row < (size_t)rows;
  const uint4* src = reinterpret_cast<const uint4*>(x) + row * n;

  uint4 raw[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int q = lane + j * lanes;
    raw[j] = (ok && q < n) ? src[q] : make_uint4(0u, 0u, 0u, 0u);
  }
  // weight, then bias, into shared memory (C is a multiple of 4 here): a
  // thread issues up to kLnStageLoads 16-byte loads before it stores any,
  // so the copy is one round trip to memory, overlapping the row's loads
  {
    const int n4 = C / 4;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float4* wb4 = reinterpret_cast<float4*>(wb);
    for (int i0 = threadIdx.x; i0 < 2 * n4; i0 += kLnStageLoads * blockDim.x) {
      float4 v[kLnStageLoads];
#pragma unroll
      for (int u = 0; u < kLnStageLoads; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < 2 * n4) v[u] = i < n4 ? __ldg(w4 + i) : __ldg(b4 + i - n4);
      }
#pragma unroll
      for (int u = 0; u < kLnStageLoads; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < 2 * n4) wb4[i] = v[u];
      }
    }
  }

  float f[V][kVec];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    unpack(raw[j], f[j]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) s += f[j][e];  // zeros where the row has no vector j
  }
  const float mean = group_sum(s, lanes) / (float)C;
  float q2 = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool in_row = lane + j * lanes < n;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      f[j][e] = in_row ? f[j][e] - mean : 0.0f;
      q2 += f[j][e] * f[j][e];
    }
  }
  const float rstd = 1.0f / sqrtf(group_sum(q2, lanes) / (float)C + eps);
  __syncthreads();  // weight and bias are in shared memory
  if (!ok) return;
  uint4* dst = reinterpret_cast<uint4*>(y) + row * n;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int q = lane + j * lanes;
    if (q >= n) continue;
    // a vector's weights and biases as float4 (C is a multiple of 4 here):
    // neighbouring lanes read neighbouring 16 bytes, no bank conflict
    const float4* wq = reinterpret_cast<const float4*>(wb) + q * (kVec / 4);
    const float4* bq = reinterpret_cast<const float4*>(wb + C) + q * (kVec / 4);
    float o[kVec];
#pragma unroll
    for (int h = 0; h < kVec / 4; ++h) {
      const float4 wv = wq[h], bv = bq[h];
      o[4 * h] = f[j][4 * h] * rstd * wv.x + bv.x;
      o[4 * h + 1] = f[j][4 * h + 1] * rstd * wv.y + bv.y;
      o[4 * h + 2] = f[j][4 * h + 2] * rstd * wv.z + bv.z;
      o[4 * h + 3] = f[j][4 * h + 3] * rstd * wv.w + bv.w;
    }
    dst[q] = pack(o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kLnMaxThreads)
layer_norm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
                         T* __restrict__ y, int rows, int C, float eps, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const size_t row = (size_t)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const bool ok = row < (size_t)rows;
  const T* src = x + row * C;
  float s = 0.0f;
  if (ok)
    for (int i = lane; i < C; i += lanes) s += to_f32(src[i]);
  const float mean = group_sum(s, lanes) / (float)C;
  float q2 = 0.0f;
  if (ok)
    for (int i = lane; i < C; i += lanes) {
      const float d = to_f32(src[i]) - mean;
      q2 += d * d;
    }
  const float rstd = 1.0f / sqrtf(group_sum(q2, lanes) / (float)C + eps);
  if (!ok) return;
  T* dst = y + row * C;
  for (int i = lane; i < C; i += lanes) dst[i] = from_f32<T>((to_f32(src[i]) - mean) * rstd * __ldg(w + i) + __ldg(b + i));
}

template <typename T, int V>
static int launch_vec(const void* x, const void* w, const void* b, void* y, int rows, int C, float eps, int lanes,
                      int rows_per_block, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  layer_norm_vec_kernel<T, V><<<blocks, rows_per_block * lanes, 2 * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b), static_cast<T*>(y), rows,
      C, eps, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* x, const void* w, const void* b, void* y, int rows, int C, float eps, int vector,
                    int lanes, int chunks, int rows_per_block, cudaStream_t stream) {
  if (!vector) {
    const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
    layer_norm_scalar_kernel<T><<<blocks, rows_per_block * lanes, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b), static_cast<T*>(y),
        rows, C, eps, lanes);
    return (int)cudaGetLastError();
  }
  switch (chunks) {
    case 1: return launch_vec<T, 1>(x, w, b, y, rows, C, eps, lanes, rows_per_block, stream);
    case 2: return launch_vec<T, 2>(x, w, b, y, rows, C, eps, lanes, rows_per_block, stream);
    case 3: return launch_vec<T, 3>(x, w, b, y, rows, C, eps, lanes, rows_per_block, stream);
    case 4: return launch_vec<T, 4>(x, w, b, y, rows, C, eps, lanes, rows_per_block, stream);
    case 5: return launch_vec<T, 5>(x, w, b, y, rows, C, eps, lanes, rows_per_block, stream);
    case 6: return launch_vec<T, 6>(x, w, b, y, rows, C, eps, lanes, rows_per_block, stream);
    case 7: return launch_vec<T, 7>(x, w, b, y, rows, C, eps, lanes, rows_per_block, stream);
    case 8: return launch_vec<T, 8>(x, w, b, y, rows, C, eps, lanes, rows_per_block, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace said

// x, y (rows, C) contiguous in the dtype, x, y, w and b 16-byte aligned
// on the vector route; w, b (C,) f32. The plan (ops/norms.py::layer_norm_plan):
// vector (1) or scalar (0) route, lanes a row (a power of two ≤ 32), chunks
// a lane (vector route: 16-byte vectors, the lane's share of the row), rows
// a block; lanes · rows a block is a whole number of warps.
extern "C" int said_layer_norm(const void* x, const void* w, const void* b, void* y, int rows, int C, float eps,
                               int dtype, int vector, int lanes, int chunks, int rows_per_block, void* stream) {
  if (dtype != said::kFloat32 && dtype != said::kBFloat16) return (int)cudaErrorInvalidValue;
  const int esize = dtype == said::kFloat32 ? 4 : 2;
  const int threads = lanes * rows_per_block;
  if (rows <= 0 || C <= 0 || lanes <= 0 || lanes > 32 || (lanes & (lanes - 1)) != 0 || rows_per_block <= 0 ||
      threads % 32 != 0 || threads > said::kLnMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (vector) {
    const int n = C * esize / 16;
    if ((C * esize) % 16 != 0 || chunks < 1 || chunks > said::kLnMaxChunks || chunks * lanes < n ||
        (chunks - 1) * lanes >= n)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == said::kFloat32)
    return said::dispatch<float>(x, w, b, y, rows, C, eps, vector, lanes, chunks, rows_per_block, s);
  return said::dispatch<__nv_bfloat16>(x, w, b, y, rows, C, eps, vector, lanes, chunks, rows_per_block, s);
}
