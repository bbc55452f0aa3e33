// Flash prefill attention for Hopper: causal online-softmax GQA attention
// in fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::flash_prefill
// (body _flash_kernel, tile update _flash_tile, mask _tile_mask). It
// computes the same function, not the same blocks:
//   s      = (q . k) * hd^-0.5            (scale on the product, not on q)
//   s      = -1e30 where q_offset + q_row < k_col
//   m_new  = max(m, rowmax(s)); p = exp(s - m_new); corr = exp(m - m_new)
//   l      = l * corr + rowsum(p);  acc = acc * corr + p . v
//   out    = acc / max(l, 1e-30)
// GQA: q head h reads kv head h / G, G = H / Kv.
//
// Layout: q (B, H, Sq, 128), k/v (B, Kv, Sk, 128), out (B, H, Sq, 128), all
// contiguous fp32. One CTA of 256 threads per (q-block of 64 rows, h, b).
//
// Bound: at the serving shapes (Sq = Sk = 512, H = 16, hd = 128) the causal
// work is ~1.1 GFLOP against ~13 MB of q/k/v/o, so the kernel is bound by
// operations. It runs fp32 FMAs on the CUDA cores: the port computes in
// fp32 with TF32 off, and a TF32 wgmma would break that rule. What the
// design does about the bound:
//   * The TPU kernel staged the whole Sk x hd of a kv head in VMEM. Here k
//     and v stream through shared memory one 64-row tile at a time (Q, K,
//     V and P tiles: 116 KB of dynamic shared memory, above the 48 KB
//     static limit, hence cudaFuncSetAttribute).
//   * k-blocks wholly above the diagonal are skipped. That is exact: a
//     fully masked block leaves (m, l, acc) unchanged (p = 0, corr = 1).
//   * Each thread keeps a 4x4 block of scores and a 4x8 block of the
//     output in registers, so every shared-memory float4 feeds 4-16 FMAs.
//     Tile rows are padded to 132 floats, which keeps the K and V reads
//     free of bank conflicts.
//   * The q-blocks nearest the end of the sequence (the longest k loops)
//     are scheduled first.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch, so a refused launch is seen by the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHd = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kStride = kHd + 4;   // padded row of the Q / K / V tiles
constexpr int kPStride = kBK + 4;  // padded row of the P tile
constexpr float kNegInf = -1e30f;  // as the reference: exp() gives exactly 0
constexpr int kMaxDevices = 64;
constexpr size_t kSmemBytes =
    sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * kStride +
                     static_cast<size_t>(kBQ) * kPStride);

// rows x 128 floats from global (row stride 128) into shared (row stride
// kStride), float4 per thread, neighbouring threads on neighbouring words
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int rows) {
  const int n4 = rows * (kHd / 4);
  for (int idx = threadIdx.x; idx < n4; idx += kThreads) {
    const int r = idx / (kHd / 4);
    const int c = (idx % (kHd / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * kStride + c) =
        *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * kHd + c);
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int H, int Kv, int Sq, int Sk, int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kStride;
  float* Vs = Ks + kBK * kStride;
  float* Ps = Vs + kBK * kStride;

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest k loops first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int ty = threadIdx.x / 16;  // rows ty + 16 i
  const int tx = threadIdx.x % 16;  // score cols tx + 16 j; out cols 4 tx + 64 h

  const float* qg = q + (static_cast<size_t>(b) * H + h) * Sq * kHd +
                    static_cast<size_t>(qb) * kBQ * kHd;
  const float* kg = k + (static_cast<size_t>(b) * Kv + kvh) * Sk * kHd;
  const float* vg = v + (static_cast<size_t>(b) * Kv + kvh) * Sk * kHd;
  float* og = out + (static_cast<size_t>(b) * H + h) * Sq * kHd +
              static_cast<size_t>(qb) * kBQ * kHd;

  load_tile(Qs, qg, kBQ);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int q_lo = q_offset + qb * kBQ;  // absolute position of row 0
  // blocks whose first key is past the last query row are fully masked
  const int last = (q_lo + kBQ - 1) / kBK + 1;
  const int nk = Sk / kBK < last ? Sk / kBK : last;

  for (int j = 0; j < nk; ++j) {
    __syncthreads();  // the previous tile's K / V / P reads are done
    load_tile(Ks, kg + static_cast<size_t>(j) * kBK * kHd, kBK);
    load_tile(Vs, vg + static_cast<size_t>(j) * kBK * kHd, kBK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;

#pragma unroll 4
    for (int d = 0; d < kHd; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * kStride + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kb[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = s[i][c];
          a = fmaf(qa[i].x, kb[c].x, a);
          a = fmaf(qa[i].y, kb[c].y, a);
          a = fmaf(qa[i].z, kb[c].z, a);
          a = fmaf(qa[i].w, kb[c].w, a);
          s[i][c] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float sv = s[i][c] * scale;
        if (qpos < j * kBK + tx + 16 * c) sv = kNegInf;
        s[i][c] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * kPStride + tx + 16 * c] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P complete

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kPStride + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (kk + e) * kStride + 4 * tx;
        const float4 v0 = *reinterpret_cast<const float4*>(vrow);
        const float4 v1 = *reinterpret_cast<const float4*>(vrow + 64);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? pa[i].x : e == 1 ? pa[i].y : e == 2 ? pa[i].z : pa[i].w;
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = og + static_cast<size_t>(ty + 16 * i) * kHd + 4 * tx;
    *reinterpret_cast<float4*>(orow) =
        make_float4(acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den);
    *reinterpret_cast<float4*>(orow + 64) =
        make_float4(acc[i][4] / den, acc[i][5] / den, acc[i][6] / den, acc[i][7] / den);
  }
}

}  // namespace

// q (B, H, Sq, 128), k / v (B, Kv, Sk, 128), out (B, H, Sq, 128): contiguous
// fp32 on the current device, 16-byte aligned. Sq and Sk multiples of 64,
// H a multiple of Kv, q_offset >= 0 (all checked by the Python wrapper).
// Causal only: the one mask the serving path asks for.
extern "C" int repro_flash_prefill(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int Kv, int Sq,
                                   int Sk, int q_offset, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Kv <= 0 || H % Kv || Sq % kBQ || Sk % kBK || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0) return 0;
  // The shared-memory opt-in is an attribute of each device: set it once on
  // every device the kernel runs on (the wrapper makes q's device current).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_prefill_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const dim3 grid(Sq / kBQ, H, B);
  flash_prefill_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Kv, Sq, Sk,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}
