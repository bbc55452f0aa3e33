// What the two flash prefill kernels share (flash_prefill.cu, fp32 on the
// CUDA cores; flash_prefill_bf16.cu, bf16 on the tensor cores): the work
// item's unit of 64 query rows, cp.async, the shared-memory opt-in, and the
// merge of a split unit's partials by its last piece to finish. Both
// kernels run 128 threads a CTA and write a partial as acc (64 x 128 fp32,
// row-major) and (m[64], l[64]), so one merge serves both.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kHd = 128;
constexpr int kHd4 = kHd / 4;      // float4s a row
constexpr int kRowsQ = 64;         // query rows a unit: 64 / Gc positions x Gc heads
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // as the reference: exp() gives exactly 0
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
}

// 16 bytes from global src to shared memory at dst (a shared-window address
// or a generic pointer)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc / max(l, 1e-30) as each output type takes it: fp32 divides each
// element (the fp32 kernel's bits); bf16 multiplies by the row's rounded
// reciprocal (one division a row instead of one an element, an fp32
// rounding more, far below the bf16 rounding that follows)
template <typename T>
__device__ __forceinline__ float4 normalise(float4 a, float l) {
  const float den = fmaxf(l, 1e-30f);
  if constexpr (std::is_same<T, float>::value) {
    return make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
  } else {
    const float inv = 1.f / den;
    return make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
}

// Where a unit's row rho lives: batch b, head h and position pos.
struct Unit {
  int b, kvh, hg, qb, bq, Gc;
  __device__ Unit(int unit, int H, int Kv, int Gc_, int Sq) : Gc(Gc_) {
    bq = kRowsQ / Gc;
    const int nqb = Sq / bq;
    qb = unit % nqb;
    const int bhg = unit / nqb;
    const int groups = H / Gc;
    hg = bhg % groups;
    b = bhg / groups;
    kvh = hg * Gc / (H / Kv);
  }
  __device__ int pos(int rho) const { return qb * bq + rho % bq; }
  // index of row rho in a (B, H, Sq) array: the log-sum-exp's
  __device__ size_t row1(int rho, int H, int Sq) const {
    return (static_cast<size_t>(b) * H + hg * Gc + rho / bq) * Sq + pos(rho);
  }
  // offset of (row rho, column 0) in q or out
  __device__ size_t row(int rho, int H, int Sq) const { return row1(rho, H, Sq) * kHd; }
};

// After a piece has written its partial to slot item.z: the unit's last
// piece to finish (an integer counter, no float atomics) merges the unit's
// partials in piece order (m = max m_p, l = sum l_p e^(m_p - m), acc = sum
// acc_p e^(m_p - m), all in log2 units) into out and sets the counter back
// to 0. items[i] = (unit, tiles, slot, merge index); merges[j] = (first
// slot, pieces, 0, 0). Every thread of the CTA (N of them) calls it; each
// element's arithmetic is the same whichever thread does it.
template <typename T, int N = kThreads>
__device__ __forceinline__ void merge_if_last(const int4 item, const Unit& u,
                                              const int4* __restrict__ merges,
                                              int* __restrict__ counters,
                                              const float* __restrict__ part_acc,
                                              const float* __restrict__ part_ml,
                                              T* __restrict__ out, int H, int Sq,
                                              float* __restrict__ lse = nullptr) {
  __shared__ int last;
  const int4 mg = merges[item.w];
  // the barrier orders every thread's partial before thread 0's count,
  // whose release and acquire (one acq_rel atomic at gpu scope) publish this
  // piece's partial and make the other pieces' visible to the last one
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counters + item.w)
                 : "memory");
    last = old == mg.y - 1;
  }
  __syncthreads();
  if (!last) return;

  // warp w of the N / 32 merges rows w + (N / 32) i, lane the float4 column
  // lane, in piece order: each load of a warp reads 512 contiguous bytes
  constexpr int kWarps = N / 32;
  constexpr int kRowsW = kRowsQ / kWarps;
  const int w0 = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float mt[kRowsW], lt[kRowsW];
  float4 a[kRowsW];
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    mt[i] = kNegInf;
    lt[i] = 0.f;
    a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 2
  for (int p = 0; p < mg.y; ++p) {
    const float* ml = part_ml + static_cast<size_t>(mg.x + p) * 2 * kRowsQ;
#pragma unroll
    for (int i = 0; i < kRowsW; ++i) mt[i] = fmaxf(mt[i], __ldcg(ml + w0 + kWarps * i));
  }
  for (int p = 0; p < mg.y; ++p) {
    const size_t slot = static_cast<size_t>(mg.x + p);
    const float* ml = part_ml + slot * 2 * kRowsQ;
    const float4* src = reinterpret_cast<const float4*>(part_acc + slot * kRowsQ * kHd) + lane;
#pragma unroll
    for (int i = 0; i < kRowsW; ++i) {
      const int rho = w0 + kWarps * i;
      const float w = exp2f(__ldcg(ml + rho) - mt[i]);
      lt[i] = fmaf(__ldcg(ml + kRowsQ + rho), w, lt[i]);
      const float4 x = __ldcg(src + rho * kHd4);
      a[i].x = fmaf(w, x.x, a[i].x);
      a[i].y = fmaf(w, x.y, a[i].y);
      a[i].z = fmaf(w, x.z, a[i].z);
      a[i].w = fmaf(w, x.w, a[i].w);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsW; ++i)
    store4(out + u.row(w0 + kWarps * i, H, Sq) + 4 * lane, normalise<T>(a[i], lt[i]));
  if (lse != nullptr && lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsW; ++i)
      lse[u.row1(w0 + kWarps * i, H, Sq)] = (mt[i] + log2f(lt[i])) * kLn2;
  }
  if (threadIdx.x == 0) counters[item.w] = 0;  // as it was found
}

// The shared-memory opt-in is an attribute of each device and each kernel:
// set it once on every device the kernel runs on (the wrapper makes q's
// device current). `configured` is the kernel's own table.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  configured[dev] = true;
  return cudaSuccess;
}

// the arguments both entry points check alike
inline bool bad_shape(int B, int H, int Kv, int Gc, int Sq, int Sk, int q_offset, int n_items) {
  return B <= 0 || H <= 0 || Kv <= 0 || H % Kv || Sq % 64 || Sk % 64 || q_offset < 0 ||
         (Gc != 1 && Gc != 2 && Gc != 4) || (H / Kv) % Gc || n_items < 0;
}

}  // namespace flash
