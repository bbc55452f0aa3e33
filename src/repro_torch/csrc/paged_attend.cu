// Paged decode attention for Hopper: one query token per slot reads its
// keys and values through a page table, fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::paged_attend
// (body _paged_kernel, page update _page_update, mask _page_valid). It
// computes the same function, not the same blocks:
//   s      = (q . k) * hd^-0.5            (scale on the product, not on q)
//   s      = -1e30 where j * page + offset >= lengths[b]
//   m_new  = max(m, max(s)); p = exp(s - m_new); corr = exp(m - m_new)
//   l      = l * corr + sum(p);  acc = acc * corr + p . v
//   out    = acc / max(l, 1e-30)
// Logical page j of slot b is pool row page_table[b, j]. Query head
// h = kv * G + g reads kv head kv.
//
// Layout: q (B, Kv, G, 128), pools (P, page, Kv, 128), page_table
// (B, n_pages) int32, lengths (B,) int32, out (B, Kv, G, 128); all
// contiguous, fp32 where float.
//
// Bound: bytes. A K row and a V row (1 KB) serve G scores and G output
// updates (512 FLOPs each), G / 2 FLOPs per byte against the card's ~20
// FLOPs per byte at the fp32 peak: the least time is K and V of the slot's
// valid rows, plus q and out, moved once at 3.35 TB/s. What the design does
// about it:
//   * The TPU kernel's grid is (B, n_pages), with the online-softmax carry
//     in VMEM across the sequential page axis. Here one CTA of 128 threads
//     takes one (b, kv head) and walks the pages in a loop, the carry in
//     registers; the G query heads of that kv head share every K/V load.
//   * The CTA reads table[b, j] and lengths[b] itself from device memory:
//     no host sync. A page row of one kv head is 128 contiguous floats at
//     stride Kv * 128; 32 neighbouring threads load it as float4s.
//   * Pages at or past ceil(length / page) are skipped when length >= 1:
//     a fully masked page leaves (m, l, acc) unchanged (p = 0, corr = 1).
//     A slot of length 0 walks every page, as the reference does (all
//     scores -1e30, so it returns the mean of V over its table's rows).
//   * K and V go through shared memory 32 rows (32 KB) at a time, staged
//     in registers: each thread issues all 16 of its float4 loads of the
//     next chunk before the current one is scored, so a chunk's loads
//     overlap the previous chunk's arithmetic (34 KB of shared memory
//     beside q's 8 KB, all static; rows padded to 132 floats so the
//     per-row score reads are free of bank conflicts).
//   * Lane r of warp w scores row r for query head g = w + 4i; max and sum
//     are xor-shuffle reductions in a fixed order (no atomics, run-to-run
//     identical output); lane c accumulates output columns 4c..4c+3.
// Still to do: a split over pages (flash-decoding) so that few slots fill
// more than B * Kv of the 132 SMs, and TMA in place of register staging.
//
// A table entry outside [0, P) is never dereferenced: the slot's output
// is NaN instead, so a scheduler fault shows in the result.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch, so a refused launch is seen by the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHd = 128;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                  // K / V rows staged per chunk
constexpr int kStride = kHd + 4;           // padded row of the K / V tiles
constexpr int kMaxG = 16;                  // query heads per kv head
constexpr int kGPerWarp = kMaxG / kWarps;  // query heads one warp owns
constexpr float kNegInf = -1e30f;          // as the reference: exp() gives 0
constexpr int kLoads = kRows * (kHd / 4) / kThreads;  // float4s a thread stages

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Issue the loads of chunk t (logical page t / cpp, rows (t % cpp) * kRows
// on) into registers: all of a thread's float4s are in flight at once.
// Returns false, loading nothing, when the page's table entry is not a
// pool row.
__device__ __forceinline__ bool fetch_chunk(
    const float* __restrict__ k_pool, const float* __restrict__ v_pool,
    const int* __restrict__ table_row, int t, int cpp, int page, int P,
    size_t row_stride, int kvh, float4 (&kreg)[kLoads], float4 (&vreg)[kLoads],
    int& n) {
  const int j = t / cpp;
  const int c0 = (t % cpp) * kRows;
  const int phys = table_row[j];
  if (phys < 0 || phys >= P) return false;
  n = page - c0 < kRows ? page - c0 : kRows;
  const size_t base = (static_cast<size_t>(phys) * page + c0) * row_stride + kvh * kHd;
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / (kHd / 4);
    const int c = (idx % (kHd / 4)) * 4;
    if (r < n) {
      const size_t src = base + static_cast<size_t>(r) * row_stride + c;
      kreg[it] = __ldg(reinterpret_cast<const float4*>(k_pool + src));
      vreg[it] = __ldg(reinterpret_cast<const float4*>(v_pool + src));
    }
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int Kv, int G, int P, int page, int n_pages, float scale) {
  __shared__ __align__(16) float Ks[kRows * kStride];
  __shared__ __align__(16) float Vs[kRows * kStride];
  __shared__ __align__(16) float Qs[kMaxG * kHd];

  const int b = blockIdx.x / Kv;
  const int kvh = blockIdx.x % Kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(Kv) * kHd;  // pool row to row
  const float kAbsent = __int_as_float(0xff800000);  // -inf: below any score
  const int* table_row = page_table + static_cast<size_t>(b) * n_pages;

  const float* qg = q + static_cast<size_t>(blockIdx.x) * G * kHd;
  for (int i = threadIdx.x; i < G * (kHd / 4); i += kThreads)
    reinterpret_cast<float4*>(Qs)[i] = reinterpret_cast<const float4*>(qg)[i];

  const int length = lengths[b];
  // pages holding a live row; a slot of length 0 walks them all
  int walk = n_pages;
  if (length > 0) {
    const int live = (length + page - 1) / page;
    walk = live < n_pages ? live : n_pages;
  }
  const int cpp = (page + kRows - 1) / kRows;  // chunks per page
  const int n_chunks = walk * cpp;

  float m[kGPerWarp], l[kGPerWarp];
  float4 acc[kGPerWarp];
#pragma unroll
  for (int i = 0; i < kGPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // every thread reads the same table entries, so `bad` is uniform
  float4 kreg[kLoads], vreg[kLoads];
  int n_next = 0;
  bool bad = !fetch_chunk(k_pool, v_pool, table_row, 0, cpp, page, P, row_stride, kvh,
                          kreg, vreg, n_next);
  for (int t = 0; t < n_chunks && !bad; ++t) {
    const int n = n_next;
    __syncthreads();  // the previous chunk's reads (and Qs's fill) are done
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int r = idx / (kHd / 4);
      const int c = (idx % (kHd / 4)) * 4;
      if (r < n) {
        *reinterpret_cast<float4*>(Ks + r * kStride + c) = kreg[it];
        *reinterpret_cast<float4*>(Vs + r * kStride + c) = vreg[it];
      }
    }
    __syncthreads();
    // the next chunk's loads fly while this one is scored
    if (t + 1 < n_chunks)
      bad = !fetch_chunk(k_pool, v_pool, table_row, t + 1, cpp, page, P, row_stride, kvh,
                         kreg, vreg, n_next);

    const int row0 = (t / cpp) * page + (t % cpp) * kRows;  // position of row 0
    const bool present = lane < n;
    const bool valid = row0 + lane < length;
#pragma unroll
    for (int i = 0; i < kGPerWarp; ++i) {
      const int g = warp + kWarps * i;
      if (g >= G) break;  // uniform across the warp
      // lane r scores row r of the chunk
      float s = kNegInf;
      if (present) {
        const float* kr = Ks + lane * kStride;
        const float* qr = Qs + g * kHd;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < kHd; d += 4) {
          const float4 kv4 = *reinterpret_cast<const float4*>(kr + d);
          const float4 q4 = *reinterpret_cast<const float4*>(qr + d);
          dot = fmaf(q4.x, kv4.x, dot);
          dot = fmaf(q4.y, kv4.y, dot);
          dot = fmaf(q4.z, kv4.z, dot);
          dot = fmaf(q4.w, kv4.w, dot);
        }
        if (valid) s = dot * scale;
      }
      // rows past the chunk's end are no rows at all: out of the max
      // and the sum (masked rows are in both, as in the reference)
      const float m_new = fmaxf(m[i], warp_max(present ? s : kAbsent));
      const float p = present ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
      float4 a = acc[i];
      a.x *= corr;
      a.y *= corr;
      a.z *= corr;
      a.w *= corr;
      // lane c accumulates output columns 4c .. 4c+3 over the chunk's rows
      for (int r = 0; r < n; ++r) {
        const float pr = __shfl_sync(0xffffffffu, p, r);
        const float4 v4 = *reinterpret_cast<const float4*>(Vs + r * kStride + 4 * lane);
        a.x = fmaf(pr, v4.x, a.x);
        a.y = fmaf(pr, v4.y, a.y);
        a.z = fmaf(pr, v4.z, a.z);
        a.w = fmaf(pr, v4.w, a.w);
      }
      acc[i] = a;
    }
  }

  const float nan = __int_as_float(0x7fc00000);  // quiet NaN
  float* og = out + static_cast<size_t>(blockIdx.x) * G * kHd;
#pragma unroll
  for (int i = 0; i < kGPerWarp; ++i) {
    const int g = warp + kWarps * i;
    if (g >= G) break;
    const float den = fmaxf(l[i], 1e-30f);
    float4 o = make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den, acc[i].w / den);
    if (bad) o = make_float4(nan, nan, nan, nan);
    *reinterpret_cast<float4*>(og + g * kHd + 4 * lane) = o;
  }
}

}  // namespace

// q (B, Kv, G, 128), k_pool / v_pool (P, page, Kv, 128), page_table
// (B, n_pages) int32, lengths (B,) int32, out (B, Kv, G, 128): contiguous on
// the current device, float tensors 16-byte aligned; 1 <= G <= 16,
// 1 <= page <= 128, n_pages >= 1 (all checked by the Python wrapper).
extern "C" int repro_paged_attend(const void* q, const void* k_pool,
                                  const void* v_pool, const void* page_table,
                                  const void* lengths, void* out, int B,
                                  int Kv, int G, int P, int page, int n_pages,
                                  float scale, void* stream) {
  if (B < 0 || Kv <= 0 || G < 1 || G > kMaxG || P < 1 || page < 1 || page > 128 ||
      n_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  paged_attend_kernel<<<B * Kv, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(out), Kv, G, P, page,
      n_pages, scale);
  return static_cast<int>(cudaGetLastError());
}
