// AWP monitor for Hopper: sum of squares of an fp32 tensor, one fp32 scalar.
//
// Replaces the TPU kernel src/repro/kernels/l2norm.py::l2norm_sq_2d (body
// _l2norm_kernel), which walks (rows, 128) tiles in 512-row blocks over a
// sequential grid and carries one scalar from block to block. Blocks on the
// card run in parallel and in no order, so nothing carries over between
// them. The design is a two-stage reduction with no float atomics:
//   * Stage 1: a grid whose size depends only on n (never on the SM count or
//     on timing). Each thread sums the squares of its grid-stride elements
//     into four fp32 accumulators (fmaf), four float4 loads in flight per
//     trip where the input is 16-byte aligned, one float at a time
//     otherwise; the n % 4 tail of an aligned input goes to the first
//     threads of the grid. A fixed shuffle tree over each warp and a second
//     one over the block's warp sums give one partial per CTA.
//   * Stage 2: one CTA sums the partials in a fixed order, with the same
//     trees, and writes the scalar.
// Every sum is thus taken in one order that depends only on n and on the
// input's alignment: two calls on the same tensor give the same bits, and
// so do the AWP decisions that read the norms.
//
// Bound: bytes. One multiply-add per 4 B read, against the card's ~20 fp32
// FLOPs per byte: the least time is 4 B x n at 3.35 TB/s. The grid is at
// most kMaxBlocks = 1024 CTAs of 256 threads, which all fit on the 132 SMs
// at once (8 CTAs of 256 threads each), and each thread keeps 64 B of loads
// in flight per trip.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launches, so a refused launch is seen by the caller. The caller
// allocates the partials (kMaxBlocks floats) and the 0-d output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;
// at least four float4 loads a thread before the grid grows
constexpr int64_t kMinPerBlock = static_cast<int64_t>(kThreads) * 16;

// Sum of v over the CTA, in thread 0: a shuffle tree per warp, then one over
// the warp sums. Fixed order, no atomics.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__device__ __forceinline__ void add_sq(float4 a, float& s0, float& s1, float& s2,
                                       float& s3) {
  s0 = fmaf(a.x, a.x, s0);
  s1 = fmaf(a.y, a.y, s1);
  s2 = fmaf(a.z, a.z, s2);
  s3 = fmaf(a.w, a.w, s3);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
l2norm_partials(const float* __restrict__ w, int64_t n, float* __restrict__ partials) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  if (kVec) {
    const float4* __restrict__ w4 = reinterpret_cast<const float4*>(w);
    const int64_t n4 = n / 4;
    int64_t i = tid;
    for (; i + 3 * stride < n4; i += 4 * stride) {
      const float4 a = w4[i];
      const float4 b = w4[i + stride];
      const float4 c = w4[i + 2 * stride];
      const float4 d = w4[i + 3 * stride];
      add_sq(a, s0, s1, s2, s3);
      add_sq(b, s0, s1, s2, s3);
      add_sq(c, s0, s1, s2, s3);
      add_sq(d, s0, s1, s2, s3);
    }
    for (; i < n4; i += stride) add_sq(w4[i], s0, s1, s2, s3);
    const int64_t t = n4 * 4 + tid;  // the n % 4 tail, one element a thread
    if (t < n) s0 = fmaf(w[t], w[t], s0);
  } else {
    int64_t i = tid;
    for (; i + 3 * stride < n; i += 4 * stride) {
      const float a = w[i], b = w[i + stride], c = w[i + 2 * stride], d = w[i + 3 * stride];
      s0 = fmaf(a, a, s0);
      s1 = fmaf(b, b, s1);
      s2 = fmaf(c, c, s2);
      s3 = fmaf(d, d, s3);
    }
    for (; i < n; i += stride) s0 = fmaf(w[i], w[i], s0);
  }
  const float v = block_sum((s0 + s1) + (s2 + s3));
  if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

__global__ void __launch_bounds__(kThreads)
l2norm_final(const float* __restrict__ partials, int parts, float* __restrict__ out) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < parts; i += kThreads) v += partials[i];
  v = block_sum(v);
  if (threadIdx.x == 0) *out = v;
}

int grid_for(int64_t n) {
  const int64_t want = (n + kMinPerBlock - 1) / kMinPerBlock;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// w: n >= 1 contiguous fp32 on the device; partials: max_parts fp32 scratch
// (at least kMaxBlocks); out: one fp32.
extern "C" int repro_l2norm_sq(const void* w, void* partials, int max_parts, void* out,
                               long long n, void* stream) {
  if (n <= 0 || max_parts < kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n);
  const float* x = static_cast<const float*>(w);
  float* parts = static_cast<float*>(partials);
  if (reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    l2norm_partials<true><<<blocks, kThreads, 0, st>>>(x, n, parts);
  } else {
    l2norm_partials<false><<<blocks, kThreads, 0, st>>>(x, n, parts);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  l2norm_final<<<1, kThreads, 0, st>>>(parts, blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
