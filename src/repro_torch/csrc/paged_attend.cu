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
// valid rows, plus q and out, moved once at 3.35 TB/s. At a decode step's
// shape (a few slots of 8 kv heads) one CTA per (slot, kv head) runs on a
// few of the 132 SMs, and one SM's share of the memory rate, ~25 GB/s,
// then sets the time. What the design does about it (flash-decoding):
//   * A split over pages. One CTA per (slot, kv head, split), a split being
//     a contiguous range of logical pages; the host picks the number of
//     splits from B, Kv, the table width and the SM count so that the grid
//     is one wave of two CTAs an SM (a partial second wave would double
//     the time). The lengths stay on the device: a CTA reads lengths[b]
//     and its table entries itself, with no host sync. Splits are cut at
//     logical page indices, never at pool rows, so a permuted pool and
//     table give the same bits.
//   * Each CTA walks the live pages of its split (pages at or past
//     ceil(length / page) are skipped when length >= 1: a fully masked
//     page leaves (m, l, acc) unchanged; a slot of length 0 walks every
//     page, as the reference does, so it returns the mean of V over its
//     table's rows) and writes a partial (m, l, acc[G][128]) to scratch; a
//     split past the live pages writes l = 0. The last split of a (slot,
//     kv head) to finish (an integer counter, which it sets back to 0)
//     merges the partials in split order: m = max m_s, l = sum l_s
//     e^(m_s - m), acc = sum acc_s e^(m_s - m), skipping l_s = 0, lane s
//     loading split s so that the loads fly together. A split made only of
//     masked rows (scores -1e30) weighs exactly 0 beside one with a live
//     row. One launch a call; a table of one split writes the output
//     directly.
//   * K and V go through a three-stage shared-memory ring of 32-row chunks
//     filled by cp.async (16 B a copy, a warp per 512 B row): two chunks
//     are in flight while one is scored, with no register staging. The
//     ring and q take 107 KB, so two CTAs fit on an SM (four chunks, 128 KB,
//     in flight an SM).
//   * Lane r of warp w scores row r for query head g = w + 4i; max and sum
//     are xor-shuffle reductions in a fixed order; lane c accumulates
//     output columns 4c..4c+3. No float atomics: two calls on one input
//     give the same bits.
//
// A table entry outside [0, P) is never dereferenced: a split that meets
// one writes l = NaN, and the merge makes the slot's whole output NaN, so
// a scheduler fault shows in the result.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch, so a refused launch is seen by the caller. The caller
// allocates the partials and the counters.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHd = 128;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                  // K / V rows a chunk of the ring
constexpr int kStride = kHd + 4;           // padded row of the K / V tiles
constexpr int kStages = 3;                 // chunks in the ring
constexpr int kMaxG = 16;                  // query heads per kv head
constexpr int kGPerWarp = kMaxG / kWarps;  // query heads one warp owns
constexpr float kNegInf = -1e30f;          // as the reference: exp() gives 0
constexpr int kCopies = kRows * (kHd / 4) / kThreads;  // 16 B copies a thread, K or V
constexpr int kStageFloats = 2 * kRows * kStride;      // K chunk, then V chunk
constexpr size_t kSmemBytes =
    sizeof(float) * (static_cast<size_t>(kStages) * kStageFloats + kMaxG * kHd);
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// Start the copies of n (<= kRows) consecutive logical rows from row_lo
// into a ring stage: K rows, then V rows. Every table entry these rows use
// was checked to be a pool row.
__device__ __forceinline__ void load_chunk(
    float* __restrict__ stage, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ table_row, int row_lo,
    int n, int page, size_t row_stride, int kvh) {
#pragma unroll
  for (int it = 0; it < kCopies; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / (kHd / 4);
    const int c = (idx % (kHd / 4)) * 4;
    if (r < n) {
      const int row = row_lo + r;
      const int phys = table_row[row / page];
      const size_t src =
          (static_cast<size_t>(phys) * page + row % page) * row_stride + kvh * kHd + c;
      cp_async16(stage + r * kStride + c, k_pool + src);
      cp_async16(stage + (kRows + r) * kStride + c, v_pool + src);
    }
  }
}

// One CTA per (slot b, kv head, split s): blockIdx.x = (b * Kv + kvh) *
// n_splits + s, which is also the index of its partial. counters[b * Kv +
// kvh] is 0 on entry and left 0.
__global__ void __launch_bounds__(kThreads, 2)
paged_attend_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ counters, int Kv, int G, int P, int page,
                    int n_pages, int n_splits, int pps, float scale) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* Qs = ring + kStages * kStageFloats;
  __shared__ int last;

  const int bk = blockIdx.x / n_splits;  // b * Kv + kvh
  const int split = blockIdx.x % n_splits;
  const int b = bk / Kv;
  const int kvh = bk % Kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(Kv) * kHd;  // pool row to row
  const float kAbsent = __int_as_float(0xff800000);  // -inf: below any score
  const float kNaN = __int_as_float(0x7fc00000);     // quiet NaN
  const int* table_row = page_table + static_cast<size_t>(b) * n_pages;

  const int length = lengths[b];
  // pages holding a live row; a slot of length 0 walks them all
  int walk = n_pages;
  if (length > 0) {
    const int live = (length + page - 1) / page;
    walk = live < n_pages ? live : n_pages;
  }
  const int p0 = split * pps;
  const int p1 = p0 + pps < walk ? p0 + pps : walk;
  int bad = 0;
  for (int j = p0 + threadIdx.x; j < p1; j += kThreads) {
    const int phys = table_row[j];
    bad |= phys < 0 || phys >= P;
  }
  bad = __syncthreads_or(bad);

  float m[kGPerWarp], l[kGPerWarp];
  float4 acc[kGPerWarp];
#pragma unroll
  for (int i = 0; i < kGPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;  // a split past the live pages stays empty
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int r0 = p0 * page;  // logical rows [r0, r0 + n_rows)
  const int n_rows = p1 > p0 && !bad ? (p1 - p0) * page : 0;
  const int n_chunks = (n_rows + kRows - 1) / kRows;
  if (n_chunks > 0) {
    // q rides in the first group with chunk 0
    const float* qg = q + static_cast<size_t>(bk) * G * kHd;
    for (int i = threadIdx.x; i < G * (kHd / 4); i += kThreads)
      cp_async16(Qs + 4 * i, qg + 4 * i);
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_chunks) {
        const int n = n_rows - t * kRows < kRows ? n_rows - t * kRows : kRows;
        load_chunk(ring + t * kStageFloats, k_pool, v_pool, table_row, r0 + t * kRows, n,
                   page, row_stride, kvh);
      }
      cp_async_commit();
    }
  }

  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk t landed
    __syncthreads();  // everyone's did, and chunk t - 1's stage is no longer read
    const int tn = t + kStages - 1;
    if (tn < n_chunks) {
      const int nn = n_rows - tn * kRows < kRows ? n_rows - tn * kRows : kRows;
      load_chunk(ring + (tn % kStages) * kStageFloats, k_pool, v_pool, table_row,
                 r0 + tn * kRows, nn, page, row_stride, kvh);
    }
    cp_async_commit();  // possibly empty: one group per trip keeps the count

    const float* Ks = ring + (t % kStages) * kStageFloats;
    const float* Vs = Ks + kRows * kStride;
    const int row0 = r0 + t * kRows;  // logical row of the chunk's row 0
    const int n = n_rows - t * kRows < kRows ? n_rows - t * kRows : kRows;
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
  cp_async_wait<0>();  // no copy outlives the CTA

  float* og = out + static_cast<size_t>(bk) * G * kHd;
  if (n_splits == 1) {  // the whole table in one split: write the output
#pragma unroll
    for (int i = 0; i < kGPerWarp; ++i) {
      const int g = warp + kWarps * i;
      if (g >= G) break;
      const float den = fmaxf(l[i], 1e-30f);
      float4 o = make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den, acc[i].w / den);
      if (bad) o = make_float4(kNaN, kNaN, kNaN, kNaN);
      *reinterpret_cast<float4*>(og + g * kHd + 4 * lane) = o;
    }
    return;
  }

  // write the partial (m[G], then l[G]; l = NaN marks a bad entry), then
  // the (slot, kv head)'s last split merges
  float* ml = part_ml + static_cast<size_t>(blockIdx.x) * 2 * G;
  float* pacc = part_acc + static_cast<size_t>(blockIdx.x) * G * kHd;
#pragma unroll
  for (int i = 0; i < kGPerWarp; ++i) {
    const int g = warp + kWarps * i;
    if (g >= G) break;
    *reinterpret_cast<float4*>(pacc + g * kHd + 4 * lane) = acc[i];
    if (lane == 0) {
      ml[g] = m[i];
      ml[G + g] = bad ? kNaN : l[i];
    }
  }
  __threadfence();  // the partial is visible device-wide before the count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + bk, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // in split order: m = max m_s, l = sum l_s e^(m_s - m), acc = sum acc_s
  // e^(m_s - m) over the splits with l_s > 0; any l_s NaN makes it NaN.
  // Lane s reads split s's (m, l) (32 splits a pass), so the loads fly
  // together; the sums still run over s in order.
  const size_t first = static_cast<size_t>(bk) * n_splits;
  for (int g = warp; g < G; g += kWarps) {
    float mt = kAbsent;
    bool nan = false;
    for (int s0 = 0; s0 < n_splits; s0 += 32) {
      const int s = s0 + lane;
      const float ls = s < n_splits ? __ldcg(part_ml + (first + s) * 2 * G + G + g) : 0.f;
      const float ms = s < n_splits ? __ldcg(part_ml + (first + s) * 2 * G + g) : kAbsent;
      nan |= __any_sync(0xffffffffu, isnan(ls));
      mt = fmaxf(mt, warp_max(ls > 0.f ? ms : kAbsent));
    }
    float lt = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_splits; s0 += 32) {
      const int s = s0 + lane;
      const float ls = s < n_splits ? __ldcg(part_ml + (first + s) * 2 * G + G + g) : 0.f;
      const float ms = s < n_splits ? __ldcg(part_ml + (first + s) * 2 * G + g) : kAbsent;
      // empty, NaN (already in nan) and absent splits weigh 0
      const float w = ls > 0.f ? expf(ms - mt) : 0.f;
      const float wl = ls > 0.f ? ls * w : 0.f;
      const int n = n_splits - s0 < 32 ? n_splits - s0 : 32;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j);
        lt += __shfl_sync(0xffffffffu, wl, j);
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            part_acc + ((first + s0 + j) * G + g) * kHd) + lane);
        a.x = fmaf(wj, x.x, a.x);
        a.y = fmaf(wj, x.y, a.y);
        a.z = fmaf(wj, x.z, a.z);
        a.w = fmaf(wj, x.w, a.w);
      }
    }
    const float den = fmaxf(lt, 1e-30f);
    float4 o = make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
    if (nan) o = make_float4(kNaN, kNaN, kNaN, kNaN);
    *reinterpret_cast<float4*>(og + g * kHd + 4 * lane) = o;
  }
  if (threadIdx.x == 0) counters[bk] = 0;  // as it was found
}

}  // namespace

// q (B, Kv, G, 128), k_pool / v_pool (P, page, Kv, 128), page_table
// (B, n_pages) int32, lengths (B,) int32, out (B, Kv, G, 128): contiguous on
// the current device, float tensors 16-byte aligned; 1 <= G <= 16,
// 1 <= page <= 128, n_pages >= 1 (all checked by the Python wrapper).
// Split s covers logical pages [s * pps, (s + 1) * pps), and the splits
// cover the table: (n_splits - 1) * pps < n_pages <= n_splits * pps. With
// n_splits > 1, part_acc holds B * Kv * n_splits * G * 128 floats, part_ml
// B * Kv * n_splits * 2 * G, and counters B * Kv ints, all 0 (left 0).
extern "C" int repro_paged_attend(const void* q, const void* k_pool,
                                  const void* v_pool, const void* page_table,
                                  const void* lengths, void* out, void* part_acc,
                                  void* part_ml, void* counters, int B, int Kv, int G,
                                  int P, int page, int n_pages, int n_splits, int pps,
                                  float scale, void* stream) {
  if (B < 0 || Kv <= 0 || G < 1 || G > kMaxG || P < 1 || page < 1 || page > 128 ||
      n_pages < 1 || n_splits < 1 || pps < 1 ||
      static_cast<long long>(n_splits - 1) * pps >= n_pages ||
      static_cast<long long>(n_splits) * pps < n_pages)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // The shared-memory opt-in is an attribute of each device: set it once on
  // every device the kernel runs on (the wrapper makes q's device current).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(paged_attend_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(paged_attend_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  paged_attend_kernel<<<B * Kv * n_splits, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), Kv, G, P, page, n_pages, n_splits, pps, scale);
  return static_cast<int>(cudaGetLastError());
}
