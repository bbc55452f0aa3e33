// Flash prefill attention for Hopper: causal online-softmax GQA attention
// in fp32 arithmetic on the CUDA cores, on fp32 tensors (bf16 ones go to
// flash_prefill_bf16.cu, on the tensor cores; the work list, the unit and
// the merge are shared, in flash_common.cuh).
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
// contiguous, all fp32.
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
//   * The log-sum-exp for training. Given lse (B, H, Sq), whichever piece
//     writes a unit's output (the unit's only piece, or its merging piece)
//     also writes each row's (m + log2 l) ln 2, the natural-log LSE that
//     flash_attn_bwd.cu recomputes P from. Serving passes null and gets
//     the same bits as without the option: the output's arithmetic is
//     untouched.
//   * k-tiles wholly above the diagonal are never listed. That is exact: a
//     fully masked tile leaves (m, l, acc) unchanged (p = 0, corr = 1). A
//     row that is fully masked in a piece weighs exactly 0 in the merge
//     beside the piece holding key 0.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch, so a refused launch is seen by the caller.

#include "flash_common.cuh"

namespace {

using namespace flash;

// Q, K, V tiles (64 x 128 each), P^T (64 keys x 64 rows), row scales (64)
constexpr size_t kSmemBytes =
    sizeof(float) * (3 * kRowsQ * kHd + kBK * kRowsQ + kRowsQ);

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

// 64 rows of K from key row k0, swizzled: row r's float4 column c at
// r * 32 + (c ^ (r & 7)); 16 copies a thread, a warp per two rows
__device__ __forceinline__ void load_k(float4* __restrict__ Ks, const float* __restrict__ kg,
                                       int k0) {
#pragma unroll
  for (int it = 0; it < kBK * kHd4 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kHd4;
    const int c = idx % kHd4;
    cp_async16(Ks + r * kHd4 + (c ^ (r & 7)), kg + static_cast<size_t>(k0 + r) * kHd + 4 * c);
  }
}

// 64 rows of V from key row k0, plain layout
__device__ __forceinline__ void load_v(float4* __restrict__ Vs, const float* __restrict__ vg,
                                       int k0) {
#pragma unroll
  for (int it = 0; it < kBK * kHd4 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    cp_async16(Vs + idx, vg + static_cast<size_t>(k0) * kHd + 4 * idx);
  }
}

// items[i] = (unit, first tile | end tile << 16, partial slot or -1, merge
// index); merges[j] = (first slot, pieces, 0, 0); counters[j] is 0 on entry
// and left 0. lse (B, H, Sq) or null.
__global__ void __launch_bounds__(kThreads, 2)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const int4* __restrict__ items,
                     const int4* __restrict__ merges, int* __restrict__ counters,
                     float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int Kv,
                     int Gc, int Sq, int Sk, int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float4* Qs = smem4;                 // [64][32]
  float4* Ks = Qs + kRowsQ * kHd4;    // [64][32], swizzled
  float4* Vs = Ks + kBK * kHd4;       // [64][32]
  float4* Pt = Vs + kBK * kHd4;       // [64 keys][16 row quads], swizzled
  float* rowv = reinterpret_cast<float*>(Pt + kBK * (kRowsQ / 4));  // [64]

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

  const float* kg = k + (static_cast<size_t>(u.b) * Kv + u.kvh) * Sk * kHd;
  const float* vg = v + (static_cast<size_t>(u.b) * Kv + u.kvh) * Sk * kHd;

  // group 1: Q and K_0; group 2: V_0
#pragma unroll
  for (int it = 0; it < kRowsQ * kHd4 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kHd4;
    const int c = idx % kHd4;
    cp_async16(Qs + idx, q + u.row(r, H, Sq) + 4 * c);
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
      for (int i = 0; i < 4; ++i) {
        rowv[4 * ty + i] = l[i];
        if (lse != nullptr) lse[u.row1(4 * ty + i, H, Sq)] = (m[i] + log2f(l[i])) * kLn2;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float den = fmaxf(rowv[8 * ry + i], 1e-30f);
      float* orow = out + u.row(8 * ry + i, H, Sq);
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
  merge_if_last(item, u, merges, counters, part_acc, part_ml, out, H, Sq, lse);
}

int launch(const float* q, const float* k, const float* v, float* out, float* lse,
           const void* items, int n_items, const void* merges, void* counters,
           void* part_acc, void* part_ml,
           int B, int H, int Kv, int Gc, int Sq, int Sk, int q_offset, float scale,
           void* stream) {
  if (bad_shape(B, H, Kv, Gc, Sq, Sk, q_offset, n_items))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return 0;
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(flash_prefill_kernel, kSmemBytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_prefill_kernel<<<n_items, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, lse, static_cast<const int4*>(items), static_cast<const int4*>(merges),
      static_cast<int*>(counters), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, Kv, Gc, Sq, Sk, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Sq, 128), k / v (B, Kv, Sk, 128), out (B, H, Sq, 128): fp32,
// contiguous on the current device, 16-byte aligned. Sq and Sk multiples of
// 64, H a multiple of Kv, q_offset >= 0 (all checked by the Python wrapper).
// Causal only: the one mask the serving and training paths ask for. lse
// (B, H, Sq) fp32, or null where no backward follows. items (n_items
// int4) and merges (int4) on the device, from the wrapper's work list for
// Gc query heads a unit; counters (one int a merge) all 0, left 0;
// part_acc holds 64 * 128 floats a partial slot and part_ml 128.
extern "C" int repro_flash_prefill(const void* q, const void* k, const void* v,
                                   void* out, void* lse, const void* items, int n_items,
                                   const void* merges, void* counters, void* part_acc,
                                   void* part_ml, int B, int H, int Kv, int Gc, int Sq,
                                   int Sk, int q_offset, float scale, void* stream) {
  return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(out),
                static_cast<float*>(lse), items, n_items, merges, counters, part_acc,
                part_ml, B, H, Kv, Gc, Sq, Sk, q_offset, scale, stream);
}
