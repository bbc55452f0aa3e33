// Flash attention backward for Hopper: the gradients of flash_prefill.cu's
// causal GQA attention, in fp32 arithmetic on the CUDA cores, on fp32
// tensors.
//
// Replaces no TPU kernel: the JAX package's flash kernel has no backward.
// Added so that causal training attention runs on the card as two
// hand-written kernels (flash_prefill.cu's forward, which also writes the
// log-sum-exp L, and this backward) instead of attend_tiled's score tiles
// in device memory. With s = (q . k) * hd^-0.5 and the forward's mask
// (s = -1e30 where q_offset + q_row < k_col), for each (b, h):
//   P  = exp(s - L)                          (exactly 0 where masked)
//   D  = rowsum(dO o O)                      (pre-pass, one warp a row)
//   dP = dO V^T;  dS = P o (dP - D)
//   dV = P^T dO;  dK = dS^T Q * scale;  dQ = dS K * scale
// dK and dV summed over the G = H / Kv query heads of a kv head.
//
// Layout: q, out, dout, dq (B, H, Sq, 128); k, v, dk, dv (B, Kv, Sk, 128);
// lse, delta (B, H, Sq); all contiguous fp32.
//
// Bound: operations. At qwen3-1.7b's training shape (B 2, H 16, Kv 8,
// S 2048) the causal work is 86 GFLOP (2.5 times the forward's) against
// ~0.2 GB of inputs and outputs; TF32 stays off, so fp32 FMAs on the CUDA
// cores (67 TFLOP/s). What the design does about it:
//   * Work. A CTA owns one 64-key tile of one kv head ("unit") and walks
//     the (query head, 64-row q-block) steps that see it, G heads after
//     one another, so dK and dV of the tile stay in registers and sum the
//     G heads inside the CTA. A step is five 64 x 64 x 128 products: S =
//     Q K^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ_i = dS K.
//   * dQ without atomics. Each step writes its 64 x 128 dQ contribution
//     to its own slot in scratch (one slot a (b, h, q-block, kv tile)); a
//     third kernel sums a q-block's slots in kv-tile order and scales. So
//     two calls give the same bits. The scratch is 32 KB a slot (0.55 GB
//     at qwen3's shape), written once and read once: the sums take ~0.2 ms
//     on an H100 beside the main kernel's ~2.6, where recomputing P and dP
//     in a dQ kernel would cost three more products a step.
//   * Balance. The causal triangle gives the units from G to G * Sq / 64
//     steps. The host lists them longest first, and cuts a unit longer
//     than ceil(steps of one batch row / 132) into near-equal pieces of
//     consecutive steps; a piece writes its dK and dV to a partial slot
//     and the unit's last piece to finish (an integer counter) sums them
//     in piece order. At qwen3's shape no unit is cut (512 CTAs of 2 to 64
//     steps); at a tp-2 rank's heads and B 1 the long units are.
//   * Register tiles. Two groups of four warps. In the score phase group 0
//     computes S and group 1 dP, each thread 4 rows x 8 keys (32 FMAs per
//     12 floats loaded); in the update phase group 0 accumulates dV and
//     group 1 dK, each thread 8 keys x 8 columns (64 FMAs per 16 floats);
//     the dQ phase takes all 256 threads at 4 rows x 8 columns. A group
//     keeps its 64 x 128 accumulator in 64 registers a thread.
//   * Bank conflicts. K and V rows are XOR-swizzled by 16 B columns (row
//     r's column c at c ^ ((r ^ r >> 2) & 7)): the score phase's quarter
//     warp reads rows 4 tx + c (tx < 8), the dQ phase 8 columns of one
//     row, both at 8 distinct bank quads. P and dS are stored row-major,
//     written 8 consecutive float4 a quarter warp, read as broadcasts.
//   * Pipelined loads. Q, dO, L and D of step n + 1 go into the second of
//     two buffers by cp.async while step n computes (K and V stay). Three
//     __syncthreads and one group barrier a step.
//   * Exponentials: P = exp2(s * scale log2 e - L log2 e), one MUFU op, the
//     forward's own scale placement.
//   * Occupancy: K, V, two Q and two dO buffers (32 KB each), P and dS
//     (16 KB each) take 225 KB: one CTA of 256 threads an SM, at most 255
//     registers a thread.
//
// Plain C interface (loaded with ctypes): one call launches the three
// kernels in stream order and returns the first launch error.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kT = 256;            // threads of the main kernel: two groups of four warps
constexpr int kG = 128;            // threads a group
constexpr int kBQ = 64;            // query rows a step
constexpr int kTile4 = kBQ * kHd4; // float4s of a 64 x 128 tile
constexpr float kLog2e = 1.4426950408889634f;
// K, V, two Q and two dO buffers (64 x 128 each), P and dS (64 x 64), two
// (L, D) pairs
constexpr size_t kSmemBytes = sizeof(float) * (6 * kBQ * kHd + 2 * kBQ * kBK + 4 * kBQ);

// where row r's float4 column c of a K or V tile lives: r * 32 + (c ^ swz(r))
__device__ __forceinline__ int swz(int r) { return (r ^ (r >> 2)) & 7; }

// 64 rows of K or V from src (the tile's row 0), swizzled
__device__ __forceinline__ void load_kv(float4* __restrict__ dst, const float* __restrict__ src) {
#pragma unroll
  for (int it = 0; it < kTile4 / kT; ++it) {
    const int idx = threadIdx.x + it * kT;
    const int r = idx / kHd4;
    const int c = idx % kHd4;
    cp_async16(dst + r * kHd4 + (c ^ swz(r)), src + static_cast<size_t>(r) * kHd + 4 * c);
  }
}

// 64 contiguous rows of Q or dO, plain layout
__device__ __forceinline__ void load_rows(float4* __restrict__ dst, const float* __restrict__ src) {
#pragma unroll
  for (int it = 0; it < kTile4 / kT; ++it) {
    const int idx = threadIdx.x + it * kT;
    cp_async16(dst + idx, src + 4 * idx);
  }
}

// group 1's four warps (barrier 0 is __syncthreads)
__device__ __forceinline__ void group_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kG) : "memory");
}

// D = rowsum(dO o O), one warp a row (a fixed butterfly: the same bits
// every call)
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t at = static_cast<size_t>(row) * kHd4 + lane;
  const float4 o = reinterpret_cast<const float4*>(out)[at];
  const float4 g = reinterpret_cast<const float4*>(dout)[at];
  float s = o.x * g.x;
  s = fmaf(o.y, g.y, s);
  s = fmaf(o.z, g.z, s);
  s = fmaf(o.w, g.w, s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// items[i] = (unit, first step | end step << 16, partial slot or -1, merge
// index), unit = (b * Kv + kv head) * (Sk / 64) + kv tile; merges[j] =
// (first slot, pieces, 0, 0), counters[j] 0 on entry and left 0. Step s of
// a unit is query head kvh * G + s / n and q-block imin + s % n, n = the
// q-blocks that see the tile. qoff[i] = the first dQ slot of q-block i
// (slots (i, 0 .. its last kv tile)), qoff[Sq / 64] the slots a (b, h).
__global__ void __launch_bounds__(kT, 1)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dq_part,
                 const int* __restrict__ qoff, const int4* __restrict__ items,
                 const int4* __restrict__ merges, int* __restrict__ counters,
                 float* __restrict__ kv_part, int H, int Kv, int Sq, int Sk, int q_offset,
                 float scale) {
  extern __shared__ float4 smem4[];
  float4* Ks = smem4;                  // [64][32], swizzled
  float4* Vs = Ks + kTile4;            // [64][32], swizzled
  float4* Qs = Vs + kTile4;            // [2][64][32]
  float4* dOs = Qs + 2 * kTile4;       // [2][64][32]
  float4* Ps = dOs + 2 * kTile4;       // [64 rows][16]
  float4* dSs = Ps + kBQ * kBK / 4;    // [64 rows][16]
  float* LD = reinterpret_cast<float*>(dSs + kBQ * kBK / 4);  // [2][L 64, D 64]

  const int4 item = items[blockIdx.x];
  const int G = H / Kv;
  const int nkt = Sk / kBK;
  const int nqb = Sq / kBQ;
  const int j = item.x % nkt;
  const int bk = item.x / nkt;  // b * Kv + kv head
  const int b = bk / Kv;
  const int kvh = bk % Kv;
  const int s0 = item.y & 0xffff;
  const int s1 = item.y >> 16;
  const int first = kBK * j - q_offset - (kBQ - 1);  // q-blocks below imin see none of the tile
  const int imin = first > 0 ? (first + kBQ - 1) / kBQ : 0;
  const int per_head = nqb - imin;
  const int tid = threadIdx.x;
  const int grp = tid / kG;  // 0: S, P, dV; 1: dP, dS, dK
  const int t = tid % kG;
  const size_t kv0 = (static_cast<size_t>(bk) * Sk + kBK * j) * kHd;

  // step s's Q, dO, L and D into buffer buf
  auto issue = [&](int s, int buf) {
    const int h = kvh * G + s / per_head;
    const size_t r0 = (static_cast<size_t>(b) * H + h) * Sq + kBQ * (imin + s % per_head);
    load_rows(Qs + buf * kTile4, q + r0 * kHd);
    load_rows(dOs + buf * kTile4, dout + r0 * kHd);
    if (tid < 32)  // L by threads 0-15, then D by 16-31: 16 B each
      cp_async16(LD + buf * 2 * kBQ + 4 * tid,
                 tid < 16 ? lse + r0 + 4 * tid : delta + r0 + 4 * (tid - 16));
  };

  load_kv(Ks, k + kv0);
  load_kv(Vs, v + kv0);
  if (s0 < s1) issue(s0, 0);
  cp_async_commit();

  // score phase: rows 4 ty + a (a < 4), keys kr[c] = 4 tx + c % 4 + 32 (c / 4)
  const int ty = t / 8;
  const int tx = t % 8;
  int kr[8], ksw[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    kr[c] = 4 * tx + (c & 3) + 32 * (c >> 2);
    ksw[c] = swz(kr[c]);
  }
  // update phase: keys 8 ry + a (a < 8), float4 columns cx and cx + 16
  const int ry = t / 16;
  const int cx = t % 16;
  // dQ phase (all 256 threads): rows 4 rr + a (a < 4), float4 columns cc and cc + 16
  const int rr = tid / 16;
  const int cc = tid % 16;
  const float scale2 = scale * kLog2e;
  const float4* Bt = grp ? Vs : Ks;
  const int pslots = qoff[nqb];

  float acc[8][8];  // dV (group 0) or dK (group 1), unscaled
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  for (int s = s0; s < s1; ++s) {
    const int buf = (s - s0) & 1;
    if (s + 1 < s1) issue(s + 1, buf ^ 1);  // buffer buf ^ 1 was freed by step s - 1's last barrier
    cp_async_commit();
    cp_async_wait<1>();  // step s's copies (and K, V) landed
    __syncthreads();     // for every thread; step s - 1's dQ phase is done with dS

    const int h = kvh * G + s / per_head;
    const int qi = imin + s % per_head;

    // scores: S = Q K^T (group 0) or dP = dO V^T (group 1)
    const float4* A = (grp ? dOs : Qs) + buf * kTile4;
    float sc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) sc[a][c] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < kHd4; ++d4) {
      float4 qa[4], kb[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = A[(4 * ty + a) * kHd4 + d4];
#pragma unroll
      for (int c = 0; c < 8; ++c) kb[c] = Bt[kr[c] * kHd4 + (d4 ^ ksw[c])];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float x = sc[a][c];
          x = fmaf(qa[a].x, kb[c].x, x);
          x = fmaf(qa[a].y, kb[c].y, x);
          x = fmaf(qa[a].z, kb[c].z, x);
          x = fmaf(qa[a].w, kb[c].w, x);
          sc[a][c] = x;
        }
    }
    const float* ld = LD + buf * 2 * kBQ;
    if (grp == 0) {  // P = exp(s - L), 0 where masked
      const int key0 = kBK * j;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qpos = q_offset + kBQ * qi + 4 * ty + a;
        const float l2 = ld[4 * ty + a] * kLog2e;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          sc[a][c] = qpos < key0 + kr[c] ? 0.f : exp2f(sc[a][c] * scale2 - l2);
        Ps[(4 * ty + a) * 16 + tx] = make_float4(sc[a][0], sc[a][1], sc[a][2], sc[a][3]);
        Ps[(4 * ty + a) * 16 + 8 + tx] = make_float4(sc[a][4], sc[a][5], sc[a][6], sc[a][7]);
      }
    } else {  // dP - D
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float d = ld[kBQ + 4 * ty + a];
#pragma unroll
        for (int c = 0; c < 8; ++c) sc[a][c] -= d;
      }
    }
    __syncthreads();  // P is complete
    if (grp == 1) {   // dS = P o (dP - D), at the same places
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 p0 = Ps[(4 * ty + a) * 16 + tx];
        const float4 p1 = Ps[(4 * ty + a) * 16 + 8 + tx];
        dSs[(4 * ty + a) * 16 + tx] =
            make_float4(p0.x * sc[a][0], p0.y * sc[a][1], p0.z * sc[a][2], p0.w * sc[a][3]);
        dSs[(4 * ty + a) * 16 + 8 + tx] =
            make_float4(p1.x * sc[a][4], p1.y * sc[a][5], p1.z * sc[a][6], p1.w * sc[a][7]);
      }
      group_barrier();  // dS is complete for group 1
    }

    // updates: dV += P^T dO (group 0), dK += dS^T Q (group 1)
    {
      const float4* X = grp ? dSs : Ps;
      const float4* Y = (grp ? Qs : dOs) + buf * kTile4;
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        const float4 x0 = X[r * 16 + 2 * ry];
        const float4 x1 = X[r * 16 + 2 * ry + 1];
        const float4 y0 = Y[r * kHd4 + cx];
        const float4 y1 = Y[r * kHd4 + 16 + cx];
        const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          acc[a][0] = fmaf(xs[a], y0.x, acc[a][0]);
          acc[a][1] = fmaf(xs[a], y0.y, acc[a][1]);
          acc[a][2] = fmaf(xs[a], y0.z, acc[a][2]);
          acc[a][3] = fmaf(xs[a], y0.w, acc[a][3]);
          acc[a][4] = fmaf(xs[a], y1.x, acc[a][4]);
          acc[a][5] = fmaf(xs[a], y1.y, acc[a][5]);
          acc[a][6] = fmaf(xs[a], y1.z, acc[a][6]);
          acc[a][7] = fmaf(xs[a], y1.w, acc[a][7]);
        }
      }
    }
    __syncthreads();  // Q, dO and P are no longer read; dS is complete

    // dQ_i's contribution of this tile: dS K, into its slot (unscaled)
    {
      float d[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) d[a][c] = 0.f;
#pragma unroll 2
      for (int e4 = 0; e4 < kBK / 4; ++e4) {
        float4 x4[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x4[a] = dSs[(4 * rr + a) * 16 + e4];
        const float x[4][4] = {{x4[0].x, x4[0].y, x4[0].z, x4[0].w},
                               {x4[1].x, x4[1].y, x4[1].z, x4[1].w},
                               {x4[2].x, x4[2].y, x4[2].z, x4[2].w},
                               {x4[3].x, x4[3].y, x4[3].z, x4[3].w}};
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) {
          const int e = 4 * e4 + ee;
          const int sw = swz(e);
          const float4 k0 = Ks[e * kHd4 + (cc ^ sw)];
          const float4 k1 = Ks[e * kHd4 + ((cc + 16) ^ sw)];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float xv = x[a][ee];
            d[a][0] = fmaf(xv, k0.x, d[a][0]);
            d[a][1] = fmaf(xv, k0.y, d[a][1]);
            d[a][2] = fmaf(xv, k0.z, d[a][2]);
            d[a][3] = fmaf(xv, k0.w, d[a][3]);
            d[a][4] = fmaf(xv, k1.x, d[a][4]);
            d[a][5] = fmaf(xv, k1.y, d[a][5]);
            d[a][6] = fmaf(xv, k1.z, d[a][6]);
            d[a][7] = fmaf(xv, k1.w, d[a][7]);
          }
        }
      }
      const size_t slot = (static_cast<size_t>(b) * H + h) * pslots + qoff[qi] + j;
      float4* dst = reinterpret_cast<float4*>(dq_part) + slot * kTile4;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        dst[(4 * rr + a) * kHd4 + cc] = make_float4(d[a][0], d[a][1], d[a][2], d[a][3]);
        dst[(4 * rr + a) * kHd4 + 16 + cc] = make_float4(d[a][4], d[a][5], d[a][6], d[a][7]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (a unit of no steps leaves K's and V's)

  const float mul = grp ? scale : 1.f;  // dK = dS^T Q * scale; dV as it is
  float* fin = (grp ? dk : dv) + kv0;
  if (item.z < 0) {  // the whole unit
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float4* row = reinterpret_cast<float4*>(fin + (8 * ry + a) * kHd);
      row[cx] = make_float4(acc[a][0] * mul, acc[a][1] * mul, acc[a][2] * mul,
                            acc[a][3] * mul);
      row[cx + 16] = make_float4(acc[a][4] * mul, acc[a][5] * mul, acc[a][6] * mul,
                                 acc[a][7] * mul);
    }
    return;
  }

  // a piece: its dV and dK to partial slot item.z ([2][64][128]), then the
  // unit's last piece to finish sums the slots in piece order
  {
    float4* part =
        reinterpret_cast<float4*>(kv_part) + (static_cast<size_t>(item.z) * 2 + grp) * kTile4;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      part[(8 * ry + a) * kHd4 + cx] = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      part[(8 * ry + a) * kHd4 + cx + 16] = make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
    }
  }
  __shared__ int last;
  const int4 mg = merges[item.w];
  // the barrier orders every thread's partial before thread 0's count,
  // whose release and acquire (one acq_rel atomic at gpu scope) publish
  // this piece's partial and make the other pieces' visible to the last one
  __syncthreads();
  if (tid == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counters + item.w)
                 : "memory");
    last = old == mg.y - 1;
  }
  __syncthreads();
  if (!last) return;
  float4 sum[8][2];
#pragma unroll
  for (int a = 0; a < 8; ++a) sum[a][0] = sum[a][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < mg.y; ++p) {
    const float4* src = reinterpret_cast<const float4*>(kv_part) +
                        (static_cast<size_t>(mg.x + p) * 2 + grp) * kTile4;
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float4 x = __ldcg(src + (8 * ry + a) * kHd4 + cx + 16 * h2);
        sum[a][h2].x += x.x;
        sum[a][h2].y += x.y;
        sum[a][h2].z += x.z;
        sum[a][h2].w += x.w;
      }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float4* row = reinterpret_cast<float4*>(fin + (8 * ry + a) * kHd);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      row[cx + 16 * h2] = make_float4(sum[a][h2].x * mul, sum[a][h2].y * mul,
                                      sum[a][h2].z * mul, sum[a][h2].w * mul);
  }
  if (tid == 0) counters[item.w] = 0;  // as it was found
}

// dQ of q-block i of (b, h): its slots summed in kv-tile order, times the
// scale. One CTA a (b, h, q-block); the slots are read once (streaming).
__global__ void __launch_bounds__(256)
flash_bwd_dq_kernel(const float* __restrict__ dq_part, const int* __restrict__ qoff,
                    float* __restrict__ dq, int nqb, float scale) {
  const int i = blockIdx.x % nqb;
  const size_t bh = blockIdx.x / nqb;
  const int n = qoff[i + 1] - qoff[i];
  const float4* src =
      reinterpret_cast<const float4*>(dq_part) + (bh * qoff[nqb] + qoff[i]) * kTile4;
  constexpr int kPer = kTile4 / 256;
  float4 a[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) a[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int jj = 0; jj < n; ++jj) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const float4 x = __ldcs(src + static_cast<size_t>(jj) * kTile4 + threadIdx.x + 256 * e);
      a[e].x += x.x;
      a[e].y += x.y;
      a[e].z += x.z;
      a[e].w += x.w;
    }
  }
  float4* dst = reinterpret_cast<float4*>(dq) + (bh * nqb + i) * kTile4;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    dst[threadIdx.x + 256 * e] = make_float4(a[e].x * scale, a[e].y * scale, a[e].z * scale,
                                             a[e].w * scale);
}

}  // namespace

// q, out, dout, dq (B, H, Sq, 128); k, v, dk, dv (B, Kv, Sk, 128); lse,
// delta (B, H, Sq): fp32, contiguous on the current device, 16-byte
// aligned; Sq and Sk multiples of 64, H a multiple of Kv, q_offset >= 0
// (all checked by the Python wrapper). Causal, as the forward. delta is
// scratch (written here); dq_part holds qoff[Sq / 64] * B * H slots of 64
// * 128 floats, kv_part 2 * 64 * 128 floats a partial slot; items, merges
// and qoff (int32) on the device from the wrapper's work list, counters
// (one int a merge) all 0, left 0. Three launches: delta, the main kernel,
// the dQ sums.
extern "C" int repro_flash_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* out, const void* dout, const void* lse,
                                    void* dq, void* dk, void* dv, void* delta, void* dq_part,
                                    const void* qoff, const void* items, int n_items,
                                    const void* merges, void* counters, void* kv_part, int B,
                                    int H, int Kv, int Sq, int Sk, int q_offset, float scale,
                                    void* stream) {
  if (B <= 0 || H <= 0 || Kv <= 0 || H % Kv || Sq % 64 || Sk % 64 || q_offset < 0 ||
      n_items < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * H * Sq;
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<float*>(delta), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items > 0) {
    static bool configured[kMaxDevices] = {};
    err = opt_in_smem(flash_bwd_kernel, kSmemBytes, configured);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_kernel<<<n_items, kT, kSmemBytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dq_part),
        static_cast<const int*>(qoff), static_cast<const int4*>(items),
        static_cast<const int4*>(merges), static_cast<int*>(counters),
        static_cast<float*>(kv_part), H, Kv, Sq, Sk, q_offset, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_bwd_dq_kernel<<<B * H * (Sq / kBQ), 256, 0, st>>>(
      static_cast<const float*>(dq_part), static_cast<const int*>(qoff),
      static_cast<float*>(dq), Sq / kBQ, scale);
  return static_cast<int>(cudaGetLastError());
}
