// Flash prefill attention for Hopper: causal online-softmax GQA attention
// in fp32 arithmetic on the CUDA cores, on fp32 or bf16 tensors.
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
// contiguous, all fp32 or all bf16.
//
// bf16 (a serve prefill under a bf16 plan; the reference's kernel takes it
// with fp32 accumulation and writes q's dtype): the kernel is a template on
// the element type, and the bf16 one widens every element of Q, K and V
// exactly (__bfloat162float) as it stores it into the same fp32 tiles, so
// everything after the loads, p . v with p in fp32 included (the reference
// multiplies p as fp32), is the fp32 kernel's arithmetic; the output is
// rounded once, with __float2bfloat16_rn. Its loads are plain loads and
// stores, not cp.async (a tile is converted on its way in), so they no
// longer overlap the compute: a simple kernel that is right. Bound: the
// larger of the operations at 989 TFLOP/s (bf16 tensor cores; this kernel
// runs fp32 FMAs, so it stays far from it) and the bytes at 3.35 TB/s, at
// 2 B an element. The fp32 instantiation is the fp32 kernel as it was, bit
// for bit.
//
// Bound: operations. At the serving shapes (Sq = Sk = 512, H = 16, hd =
// 128) the causal work is ~1.1 GFLOP against ~13 MB of q/k/v/o. The port
// computes in fp32 with TF32 off, so the kernel runs fp32 FMAs on the CUDA
// cores (67 TFLOP/s, 0.51 TFLOP/s an SM); a TF32 wgmma would break that
// rule. An SM issues 128 FMAs a clock but reads 32 floats a clock from
// shared memory (a 16 B load of a warp is four wavefronts), so each float a
// thread loads must feed 4 FMAs. What bounds a kernel below the FMA rate,
// and what the design does:
//   * Balance. A CTA per (64-row q-block, head) leaves the causal
//     triangle's long q-blocks on the critical path while the short ones'
//     SMs idle. Here a CTA takes one work item: 64 query rows (a "unit")
//     and a contiguous range of its unmasked 64-key tiles. The host splits
//     a unit's tiles into near-equal pieces of at most ceil(tiles of one
//     batch row / 264) (two CTAs on each of the H100's 132 SMs) and lists
//     the items longest first; a row's pieces depend only on (H, Kv, Sq,
//     Sk, q_offset), so two calls give the same bits, and so does a row
//     alone and inside any batch. A piece writes its partial
//     (m, l, acc) to scratch; the last piece of a unit to finish (an
//     integer counter, no float atomics) merges the unit's partials in
//     piece order (m = max m_p, l = sum l_p e^(m_p - m), acc = sum acc_p
//     e^(m_p - m)) and sets the counter back to 0. A unit of one piece
//     writes the output itself. One launch a call.
//   * GQA sharing. A unit holds Gc = gcd(G, 4) query heads of one kv head,
//     64 / Gc positions each, so one K / V tile serves all of them.
//   * Register tiles. S = Q K^T: lane (ty, tx) of 128 threads scores rows
//     4ty..4ty+3 against keys tx + 8c (c < 8), 32 FMAs per 12 floats
//     loaded. P V: thread (ry, cx) holds rows 8ry..8ry+7 at columns
//     4cx + 64h (h < 2), 64 FMAs per 16 floats loaded. So shared memory
//     runs at ~80 % of the FMA pipe's pace. Row max and sum are shuffles
//     over the 8 lanes of a row (fixed order).
//   * Bank conflicts. K rows and the transposed P tile are XOR-swizzled by
//     16 B columns (K's column c4 at c4 ^ (row & 7), P's rows j at
//     j ^ (key & 7)), so every 16 B access of a quarter warp hits distinct
//     banks or one broadcast address; Q and V need no padding.
//   * Pipelined loads. One K and one V buffer, filled by cp.async: V_t
//     lands while S_t is computed, K_t+1 while P_t V_t is. Three
//     __syncthreads a tile.
//   * Exponentials. Scores are kept in log2 units (the scale times log2 e),
//     so each e^x is one exp2f: the same function, rounded once more.
//   * Occupancy. Q, K, V (32 KB each), P (16 KB) and the row scales take
//     112 KB and at most 255 registers a thread: two CTAs of 128 threads an
//     SM.
//   * k-tiles wholly above the diagonal are never listed. That is exact: a
//     fully masked tile leaves (m, l, acc) unchanged (p = 0, corr = 1). A
//     row that is fully masked in a piece weighs exactly 0 in the merge
//     beside the piece holding key 0.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch, so a refused launch is seen by the caller.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHd = 128;
constexpr int kHd4 = kHd / 4;      // float4s a row
constexpr int kRowsQ = 64;         // query rows a unit: 64 / Gc positions x Gc heads
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // as the reference: exp() gives exactly 0
constexpr int kMaxDevices = 64;
// Q, K, V tiles (64 x 128 each), P^T (64 keys x 64 rows), row scales (64)
constexpr size_t kSmemBytes =
    sizeof(float) * (3 * kRowsQ * kHd + kBK * kRowsQ + kRowsQ);

// four consecutive elements as fp32 (bf16 widened exactly), and back
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // element 0 in the low half
  return make_float4(bf16_bits_to_float(u.x & 0xffffu), bf16_bits_to_float(u.x >> 16),
                     bf16_bits_to_float(u.y & 0xffffu), bf16_bits_to_float(u.y >> 16));
}

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

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
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

// one float4 column of a tile row: a cp.async for fp32, a widening load and
// store for bf16 (4 elements, 8 B)
template <typename T>
__device__ __forceinline__ void tile_load(float4* dst, const T* src) {
  if constexpr (std::is_same<T, float>::value)
    cp_async16(dst, reinterpret_cast<const float4*>(src));
  else
    *dst = load4(src);
}

// max / sum over the 8 lanes that share a row (lane bits 0-2)
__device__ __forceinline__ float row_max8(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum8(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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
  // offset of (row rho, column 0) in q or out
  __device__ size_t row(int rho, int H, int Sq) const {
    return ((static_cast<size_t>(b) * H + hg * Gc + rho / bq) * Sq + pos(rho)) * kHd;
  }
};

// 64 rows of K from key row k0, swizzled: row r's float4 column c at
// r * 32 + (c ^ (r & 7)); 16 copies a thread, a warp per two rows
template <typename T>
__device__ __forceinline__ void load_k(float4* __restrict__ Ks, const T* __restrict__ kg,
                                       int k0) {
#pragma unroll
  for (int it = 0; it < kBK * kHd4 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kHd4;
    const int c = idx % kHd4;
    tile_load(Ks + r * kHd4 + (c ^ (r & 7)), kg + static_cast<size_t>(k0 + r) * kHd + 4 * c);
  }
}

// 64 rows of V from key row k0, plain layout
template <typename T>
__device__ __forceinline__ void load_v(float4* __restrict__ Vs, const T* __restrict__ vg,
                                       int k0) {
#pragma unroll
  for (int it = 0; it < kBK * kHd4 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    tile_load(Vs + idx, vg + static_cast<size_t>(k0) * kHd + 4 * idx);
  }
}

// items[i] = (unit, first tile | end tile << 16, partial slot or -1, merge
// index); merges[j] = (first slot, pieces, 0, 0); counters[j] is 0 on entry
// and left 0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     const int4* __restrict__ items, const int4* __restrict__ merges,
                     int* __restrict__ counters, float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int H, int Kv, int Gc, int Sq, int Sk,
                     int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float4* Qs = smem4;                 // [64][32]
  float4* Ks = Qs + kRowsQ * kHd4;    // [64][32], swizzled
  float4* Vs = Ks + kBK * kHd4;       // [64][32]
  float4* Pt = Vs + kBK * kHd4;       // [64 keys][16 row quads], swizzled
  float* rowv = reinterpret_cast<float*>(Pt + kBK * (kRowsQ / 4));  // [64]
  __shared__ int last;

  const int4 item = items[blockIdx.x];
  const Unit u(item.x, H, Kv, Gc, Sq);
  const int kt0 = item.y & 0xffff;
  const int nt = (item.y >> 16) - kt0;
  const int part = item.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // S = Q K^T layout: rows 4ty + i (i < 4), keys tx + 8c (c < 8)
  const int ty = 4 * warp + lane / 8;
  const int tx = lane % 8;
  // P V layout: rows 8ry + i (i < 8), float4 columns cx and cx + 16
  const int ry = 2 * warp + lane / 16;
  const int cx = lane % 16;

  const T* kg = k + (static_cast<size_t>(u.b) * Kv + u.kvh) * Sk * kHd;
  const T* vg = v + (static_cast<size_t>(u.b) * Kv + u.kvh) * Sk * kHd;

  // group 1: Q and K_0; group 2: V_0
#pragma unroll
  for (int it = 0; it < kRowsQ * kHd4 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kHd4;
    const int c = idx % kHd4;
    tile_load(Qs + idx, q + u.row(r, H, Sq) + 4 * c);
  }
  if (nt > 0) load_k(Ks, kg, kt0 * kBK);
  cp_async_commit();
  if (nt > 0) load_v(Vs, vg, kt0 * kBK);
  cp_async_commit();

  // scores in log2 units: exp(x) = exp2(x log2 e), one MUFU op
  const float scale2 = scale * 1.4426950408889634f;
  int qpos[4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q_offset + u.pos(4 * ty + i);
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<1>();  // Q and K_t landed (V_t may still fly)
    __syncthreads();     // for every thread; P V of tile t - 1 is done

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < kHd4; ++d4) {
      float4 qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(4 * ty + i) * kHd4 + d4];
#pragma unroll
      for (int c = 0; c < 8; ++c) kb[c] = Ks[(tx + 8 * c) * kHd4 + (d4 ^ tx)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float a = s[i][c];
          a = fmaf(qa[i].x, kb[c].x, a);
          a = fmaf(qa[i].y, kb[c].y, a);
          a = fmaf(qa[i].z, kb[c].z, a);
          a = fmaf(qa[i].w, kb[c].w, a);
          s[i][c] = a;
        }
    }

    const int key0 = (kt0 + t) * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float sv = s[i][c] * scale2;
        if (qpos[i] < key0 + tx + 8 * c) sv = kNegInf;
        s[i][c] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = exp2f(s[i][c] - m_new);
        rs += p;
        s[i][c] = p;
      }
      const float corr = exp2f(m[i] - m_new);
      l[i] = l[i] * corr + row_sum8(rs);
      m[i] = m_new;
      if (tx == 0) rowv[4 * ty + i] = corr;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      Pt[(tx + 8 * c) * (kRowsQ / 4) + (ty ^ tx)] = make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);

    cp_async_wait<0>();  // V_t landed
    __syncthreads();     // P, the row scales and V_t are complete; K_t is no longer read
    if (t + 1 < nt) load_k(Ks, kg, (kt0 + t + 1) * kBK);
    cp_async_commit();

    {
      const float4 c0 = reinterpret_cast<const float4*>(rowv)[2 * ry];
      const float4 c1 = reinterpret_cast<const float4*>(rowv)[2 * ry + 1];
      const float corr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= corr[i];
    }
#pragma unroll 2
    for (int e = 0; e < kBK; ++e) {
      const float4 p0 = Pt[e * (kRowsQ / 4) + ((2 * ry) ^ (e & 7))];
      const float4 p1 = Pt[e * (kRowsQ / 4) + ((2 * ry + 1) ^ (e & 7))];
      const float4 v0 = Vs[e * kHd4 + cx];
      const float4 v1 = Vs[e * kHd4 + 16 + cx];
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(p[i], v0.x, acc[i][0]);
        acc[i][1] = fmaf(p[i], v0.y, acc[i][1]);
        acc[i][2] = fmaf(p[i], v0.z, acc[i][2]);
        acc[i][3] = fmaf(p[i], v0.w, acc[i][3]);
        acc[i][4] = fmaf(p[i], v1.x, acc[i][4]);
        acc[i][5] = fmaf(p[i], v1.y, acc[i][5]);
        acc[i][6] = fmaf(p[i], v1.z, acc[i][6]);
        acc[i][7] = fmaf(p[i], v1.w, acc[i][7]);
      }
    }
    __syncthreads();  // V_t, P and the row scales are no longer read
    if (t + 1 < nt) load_v(Vs, vg, (kt0 + t + 1) * kBK);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the CTA (nt = 0 leaves Q's)

  if (part < 0) {  // the whole unit: normalise and write the output
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) rowv[4 * ty + i] = l[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float den = fmaxf(rowv[8 * ry + i], 1e-30f);
      T* orow = out + u.row(8 * ry + i, H, Sq);
      store4(orow + 4 * cx,
             make_float4(acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den));
      store4(orow + 4 * (cx + 16),
             make_float4(acc[i][4] / den, acc[i][5] / den, acc[i][6] / den, acc[i][7] / den));
    }
    return;
  }

  // a piece: write the partial, then the unit's last piece merges
  float* pml = part_ml + static_cast<size_t>(part) * 2 * kRowsQ;  // m[64], then l[64]
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pml[4 * ty + i] = m[i];
      pml[kRowsQ + 4 * ty + i] = l[i];
    }
  }
  float4* pacc = reinterpret_cast<float4*>(part_acc + static_cast<size_t>(part) * kRowsQ * kHd);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pacc[(8 * ry + i) * kHd4 + cx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    pacc[(8 * ry + i) * kHd4 + cx + 16] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __threadfence();  // the partial is visible device-wide before the count
  __syncthreads();
  const int4 mg = merges[item.w];
  if (threadIdx.x == 0) last = atomicAdd(counters + item.w, 1) == mg.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // thread t merges row t / 2, float4 columns 16 (t % 2) .. + 16, in piece order
  const int rho = threadIdx.x / 2;
  const int c0 = (threadIdx.x % 2) * 16;
  float mt = kNegInf;
#pragma unroll 4
  for (int p = 0; p < mg.y; ++p)
    mt = fmaxf(mt, __ldcg(part_ml + static_cast<size_t>(mg.x + p) * 2 * kRowsQ + rho));
  float lt = 0.f;
  float4 a[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < mg.y; ++p) {
    const size_t slot = static_cast<size_t>(mg.x + p);
    const float w = exp2f(__ldcg(part_ml + slot * 2 * kRowsQ + rho) - mt);
    lt = fmaf(__ldcg(part_ml + slot * 2 * kRowsQ + kRowsQ + rho), w, lt);
    const float4* src =
        reinterpret_cast<const float4*>(part_acc + (slot * kRowsQ + rho) * kHd) + c0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 x = __ldcg(src + j);
      a[j].x = fmaf(w, x.x, a[j].x);
      a[j].y = fmaf(w, x.y, a[j].y);
      a[j].z = fmaf(w, x.z, a[j].z);
      a[j].w = fmaf(w, x.w, a[j].w);
    }
  }
  const float den = fmaxf(lt, 1e-30f);
  T* orow = out + u.row(rho, H, Sq) + 4 * c0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    store4(orow + 4 * j, make_float4(a[j].x / den, a[j].y / den, a[j].z / den, a[j].w / den));
  if (threadIdx.x == 0) counters[item.w] = 0;  // as it was found
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, const void* items,
           int n_items, const void* merges, void* counters, void* part_acc, void* part_ml,
           int B, int H, int Kv, int Gc, int Sq, int Sk, int q_offset, float scale,
           void* stream) {
  if (B <= 0 || H <= 0 || Kv <= 0 || H % Kv || Sq % 64 || Sk % 64 || q_offset < 0 ||
      (Gc != 1 && Gc != 2 && Gc != 4) || (H / Kv) % Gc || n_items < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return 0;
  // The shared-memory opt-in is an attribute of each device and each
  // instantiation: set it once on every device the kernel runs on (the
  // wrapper makes q's device current).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_prefill_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_prefill_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  flash_prefill_kernel<T><<<n_items, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<const int4*>(items),
      static_cast<const int4*>(merges), static_cast<int*>(counters),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, Kv, Gc, Sq, Sk,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Sq, 128), k / v (B, Kv, Sk, 128), out (B, H, Sq, 128): contiguous
// on the current device, 16-byte aligned, all fp32 (repro_flash_prefill) or
// all bf16 (repro_flash_prefill_bf16). Sq and Sk multiples of 64, H a
// multiple of Kv, q_offset >= 0 (all checked by the Python wrapper).
// Causal only: the one mask the serving path asks for. items (n_items
// int4) and merges (int4) on the device, from the wrapper's work list for
// Gc query heads a unit; counters (one int a merge) all 0, left 0;
// part_acc holds 64 * 128 floats a partial slot and part_ml 128.
extern "C" int repro_flash_prefill(const void* q, const void* k, const void* v,
                                   void* out, const void* items, int n_items,
                                   const void* merges, void* counters, void* part_acc,
                                   void* part_ml, int B, int H, int Kv, int Gc, int Sq,
                                   int Sk, int q_offset, float scale, void* stream) {
  return launch<float>(q, k, v, out, items, n_items, merges, counters, part_acc, part_ml,
                       B, H, Kv, Gc, Sq, Sk, q_offset, scale, stream);
}

extern "C" int repro_flash_prefill_bf16(const void* q, const void* k, const void* v,
                                        void* out, const void* items, int n_items,
                                        const void* merges, void* counters, void* part_acc,
                                        void* part_ml, int B, int H, int Kv, int Gc, int Sq,
                                        int Sk, int q_offset, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, items, n_items, merges, counters, part_acc,
                               part_ml, B, H, Kv, Gc, Sq, Sk, q_offset, scale, stream);
}
