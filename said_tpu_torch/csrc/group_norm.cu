// GroupNorm(+SiLU) over (B, T, C) in one launch, plain or masked, for
// Hopper: one thread-block cluster per (batch, block of groups).
//
// Replaces the one-launch bodies of the TPU kernels group_norm_pallas
// (said_tpu/ops/pallas_norms.py:79, K3) and group_norm_masked_pallas
// (:133, K4): per (batch, group), f32 statistics over (frames, C/G
// channels), two-pass (the mean first, then Σ(x − mean)² about it, never
// E[x²] − mean²); y = (x − mean)·rstd·w + b with rstd = 1/sqrt(var + eps),
// optionally SiLU, written in x's dtype. Masked: the statistics cover the
// frames t < lengths[b] (clamped to [0, T]), count max(len·C/G, 1), and
// every frame, padded ones included, is normalised with them.
//
// What bounds it on the card: device-memory bandwidth (about 10 flops an
// element; at the UNet's (2, 3600, 192) in f32, 11 MB of x and y against
// 3.3 µs at 3.35 TB/s). The TPU kernel holds the whole (T, C) block in
// VMEM and reads x once; a block of an SM holds 227 KB at most, and one
// block per (batch, group block) would put 16 blocks on 132 SMs at the
// UNet's batch of 2. So a cluster of CTAs splits T:
//
//   1. each CTA copies its frames × the block's channels into shared
//      memory once, 16 bytes a cp.async (x is read from device memory
//      once, in its own dtype);
//   2. per-group partial sums from shared memory, left in the CTA's shared
//      memory; after a cluster barrier every CTA adds all ranks' partials
//      through distributed shared memory in rank order, so every CTA holds
//      the same mean;
//   3. centred squares about that mean from the same shared memory,
//      joined the same way: the variance;
//   4. normalise from shared memory and write y once, 16 bytes a store.
//
// No atomics: two calls give the same bits. A CTA's last read of a peer's
// shared memory is followed by an arrive on the cluster barrier, and it
// waits on that barrier only before it exits, so that wait overlaps the
// normalise pass. Inside a CTA, threads own a fixed 16-byte column of the
// block (its frames strided by the frames a pass), so their sums need no
// per-element group logic until one fixed-order reduction a group (a warp
// per group, lanes strided, then a butterfly).
//
// The host picks the plan from the shape (ops/norms.py::group_norm_plan):
// groups per block (channel runs whole 16-byte chunks), cluster size (1,
// 2, 4, 8 or 16 CTAs) and so the frames per CTA, ceil(T / cluster); a CTA
// whose frames lie past T, or past a row's length, adds 0.
#include "hopper.cuh"

#include <cooperative_groups.h>

namespace said {

constexpr int kGnThreads = 256;
constexpr int kGnSmemLimit = 232448;  // the shared memory a block may opt in to on sm_90 (227 KB)

// the cluster barrier split in two: arrive once this CTA has read its
// peers' shared memory for the last time, wait before it exits
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes of x (4 f32 or 8 bf16) as f32, and back
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// Per-group sums of the threads' per-element partials acc (thread (r, k)
// holds frames r, r + R, … of 16-byte column k): the partials meet in red
// (R × W floats), and warp w adds group g = w, w + 8, … in a fixed order
// (lanes strided over the R·cpg values, then a butterfly). out[g] gets the
// sum. Every thread calls it; the caller synchronises before reading out.
template <int V>
__device__ __forceinline__ void group_sums(const float (&acc)[V], float* red, float* out, bool active, int r, int k,
                                           int W, int R, int cpg, int gb) {
  if (active) {
    float4* dst = reinterpret_cast<float4*>(red + r * W + k * V);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // lane's values i = lane, lane + 32, … of the group's R·cpg, as (frame,
  // channel) stepped without a division in the loop
  const int dr = 32 / cpg, dj = 32 % cpg;
  for (int g = warp; g < gb; g += kGnThreads / 32) {
    float s = 0.0f;
    int rr = lane / cpg, j = lane % cpg;
    for (; rr < R; rr += dr, j += dj) {
      if (j >= cpg) {
        j -= cpg;
        if (++rr == R) break;
      }
      s += red[rr * W + g * cpg + j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[g] = s;
  }
}

// Σ over the cluster's ranks, in rank order, of the float at p in each
// rank's shared memory (after a cluster barrier); the loads are all issued
// before the first add, so their latencies overlap
__device__ __forceinline__ float cluster_sum(float* p, int cl) {
  if (cl == 1) return *p;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  float v[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) v[q] = q < cl ? *cluster.map_shared_rank(p, q) : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < 16; ++q)
    if (q < cl) s += v[q];
  return s;
}

__device__ __forceinline__ void cluster_or_block_sync(int cl) {
  if (cl > 1) cooperative_groups::this_cluster().sync(); else __syncthreads();
}

// grid (cluster, groups / gb, B), clusters of gridDim.x CTAs along x:
// blockIdx.x is the CTA's rank and its slice of frames.
template <typename T, bool kMasked, bool kSilu>
__global__ void __launch_bounds__(kGnThreads)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ weight, const float* __restrict__ bias,
                  T* __restrict__ y, const int* __restrict__ lengths, int Tn, int C, int cpg, int gb, int frames,
                  float eps) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = gb * cpg;       // channels of the block
  const int cpr = W / V;        // 16-byte chunks a frame
  const int R = kGnThreads / cpr;  // frames a pass
  const int tid = threadIdx.x;
  const int r = tid / cpr, k = tid % cpr;
  const bool active = r < R;
  const int rank = blockIdx.x, cl = gridDim.x, batch = blockIdx.z;
  const int c0 = blockIdx.y * W, t0 = rank * frames;
  const int nf = max(0, min(frames, Tn - t0));  // this CTA's frames

  uint4* xs = reinterpret_cast<uint4*>(smem);                                   // nf × cpr chunks of x
  float* red = reinterpret_cast<float*>(smem + (size_t)frames * W * sizeof(T));  // R × W partials
  float* part = red + kGnThreads * V;  // [2][gb]: this CTA's per-group sums, then centred squares
  float* stat = part + 2 * gb;         // [2][gb]: mean, rstd

  const size_t row0 = ((size_t)batch * Tn + t0) * C + c0;
  if (active) {
    for (int f = r; f < nf; f += R) cp_async16(smem_addr(xs + f * cpr + k), x + row0 + (size_t)f * C + k * V, true);
  }
  cp_async_commit();
  float w[V], b[V];  // column k's affine, loaded while the copies fly
#pragma unroll
  for (int e = 0; e < V; ++e) {
    w[e] = weight[c0 + k * V + e];
    b[e] = bias[c0 + k * V + e];
  }

  int t_stat = Tn;
  if (kMasked) t_stat = max(0, min(lengths[batch], Tn));
  const int ns = max(0, min(nf, t_stat - t0));  // this CTA's frames inside the statistics
  const float n = fmaxf((float)t_stat * (float)cpg, 1.0f);
  int grp[V];  // the group (in the block) of each element of column k
#pragma unroll
  for (int e = 0; e < V; ++e) grp[e] = (k * V + e) / cpg;
  cp_async_wait_all();
  __syncthreads();

  // 2. the mean
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  if (active) {
    for (int f = r; f < ns; f += R) {
      float v[V];
      unpack16(xs[f * cpr + k], v);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += v[e];
    }
  }
  group_sums<V>(acc, red, part, active, r, k, W, R, cpg, gb);
  cluster_or_block_sync(cl);
  for (int g = tid; g < gb; g += kGnThreads) stat[g] = cluster_sum(part + g, cl) / n;
  __syncthreads();

  // 3. the variance, about the mean
  float mean[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    mean[e] = stat[grp[e]];
    acc[e] = 0.0f;
  }
  if (active) {
    for (int f = r; f < ns; f += R) {
      float v[V];
      unpack16(xs[f * cpr + k], v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[e] - mean[e];
        acc[e] += d * d;
      }
    }
  }
  group_sums<V>(acc, red, part + gb, active, r, k, W, R, cpg, gb);
  cluster_or_block_sync(cl);
  for (int g = tid; g < gb; g += kGnThreads) stat[gb + g] = 1.0f / sqrtf(cluster_sum(part + gb + g, cl) / n + eps);
  if (cl > 1) cluster_arrive();  // no more reads of a peer's shared memory
  __syncthreads();

  // 4. normalise every frame of the slice and write y
  if (active) {
    float scale[V];
#pragma unroll
    for (int e = 0; e < V; ++e) scale[e] = stat[gb + grp[e]] * w[e];
    for (int f = r; f < nf; f += R) {
      float v[V];
      unpack16(xs[f * cpr + k], v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float o = (v[e] - mean[e]) * scale[e] + b[e];
        if (kSilu) o = o / (1.0f + expf(-o));
        v[e] = o;
      }
      *reinterpret_cast<uint4*>(y + row0 + (size_t)f * C + k * V) = pack16(v);
    }
  }
  if (cl > 1) cluster_wait();  // no CTA leaves while a peer may still read its shared memory
}

// dynamic shared memory of one CTA: the staged slice, the partials, and
// the per-group sums and statistics
static size_t group_norm_smem(int frames, int W, int gb, int esize) {
  return (size_t)frames * W * esize + (size_t)kGnThreads * (16 / esize) * 4 + (size_t)4 * gb * 4;
}

template <typename T, bool kMasked, bool kSilu>
static int launch_group_norm(const void* x, const void* w, const void* b, void* y, const int* lengths, int B,
                             int Tn, int C, int cpg, int gb, int cl, float eps, cudaStream_t stream) {
  // the opt-ins (shared memory past 48 KB; clusters of 16) are set once per
  // process and template instance (dtype × masked × SiLU)
  static const cudaError_t attr_err = [] {
    cudaError_t e = cudaFuncSetAttribute(group_norm_kernel<T, kMasked, kSilu>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGnSmemLimit);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(group_norm_kernel<T, kMasked, kSilu>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int frames = (Tn + cl - 1) / cl;
  const int W = gb * cpg;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)cl, (unsigned)(C / W), (unsigned)B);
  config.blockDim = dim3(kGnThreads);
  config.dynamicSmemBytes = group_norm_smem(frames, W, gb, (int)sizeof(T));
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cl > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, group_norm_kernel<T, kMasked, kSilu>, static_cast<const T*>(x),
                                             static_cast<const float*>(w), static_cast<const float*>(b),
                                             static_cast<T*>(y), lengths, Tn, C, cpg, gb, frames, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_group_norm(const void* x, const void* w, const void* b, void* y, const int* lengths, int B,
                               int Tn, int C, int cpg, int gb, int cl, float eps, bool silu, cudaStream_t s) {
  if (lengths != nullptr)
    return silu ? launch_group_norm<T, true, true>(x, w, b, y, lengths, B, Tn, C, cpg, gb, cl, eps, s)
                : launch_group_norm<T, true, false>(x, w, b, y, lengths, B, Tn, C, cpg, gb, cl, eps, s);
  return silu ? launch_group_norm<T, false, true>(x, w, b, y, lengths, B, Tn, C, cpg, gb, cl, eps, s)
              : launch_group_norm<T, false, false>(x, w, b, y, lengths, B, Tn, C, cpg, gb, cl, eps, s);
}

}  // namespace said

// x, y (B, T, C), contiguous, 16-byte aligned, one dtype; w, b (C,) f32;
// lengths: null (plain) or (B,) int32 on the device (masked). The plan:
// gb groups a block (gb·C/G channels, whole 16-byte chunks, gb divides G)
// and cl CTAs a cluster (1, 2, 4, 8 or 16; ceil(T / cl) frames each).
extern "C" int said_group_norm(const void* x, const void* w, const void* b, void* y, const void* lengths, int B,
                               int T, int C, int G, float eps, int silu, int dtype, int gb, int cl, void* stream) {
  if (dtype != said::kFloat32 && dtype != said::kBFloat16) return (int)cudaErrorInvalidValue;
  const int esize = dtype == said::kFloat32 ? 4 : 2;
  if (B <= 0 || B > 65535 || T <= 0 || G <= 0 || C % G != 0 || gb <= 0 || G % gb != 0 || G / gb > 65535 ||
      (cl != 1 && cl != 2 && cl != 4 && cl != 8 && cl != 16))
    return (int)cudaErrorInvalidValue;
  const int cpg = C / G, W = gb * cpg;
  if ((W * esize) % 16 != 0 || W * esize / 16 > said::kGnThreads ||
      said::group_norm_smem((T + cl - 1) / cl, W, gb, esize) > (size_t)said::kGnSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == said::kFloat32)
    return said::dispatch_group_norm<float>(x, w, b, y, lens, B, T, C, cpg, gb, cl, eps, silu != 0, s);
  return said::dispatch_group_norm<__nv_bfloat16>(x, w, b, y, lens, B, T, C, cpg, gb, cl, eps, silu != 0, s);
}
