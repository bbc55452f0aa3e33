// Flash prefill attention for Hopper on bf16 tensors: causal online-softmax
// GQA attention whose two products run on the bf16 tensor cores (wgmma),
// with fp32 scores, softmax and sums.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::flash_prefill
// on bf16 inputs (a serve prefill under a bf16 plan; the reference takes
// them with fp32 accumulation and writes q's dtype). The function is the
// fp32 kernel's (flash_prefill.cu), in log2 units as there:
//   s      = (q . k) * hd^-0.5, from exact bf16 products summed in fp32
//   s      = -1e30 where q_offset + q_row < k_col
//   m_new  = max(m, rowmax(s)); p = exp(s - m_new); corr = exp(m - m_new)
//   l      = l * corr + rowsum(p);  acc = acc * corr + p . v  (p in fp32)
//   out    = bf16(acc * (1 / max(l, 1e-30)))
// over the same kind of work list (flash_work in kernels/flash_prefill.py,
// at SLOTS_BF16 and MIN_TILES_BF16: a unit of 64 query rows over Gc heads of
// one kv head, long units cut into pieces) and with the same merge of
// pieces (flash_common.cuh), so a row's bits do not depend on the batch and
// two calls give the same bits.
//
// Bound. At S = 512, H = 16, Kv = 8, B = 1 the function reads q, k, v and
// writes out once, 6.3 MB at 2 B an element: 1.88 us at 3.35 TB/s; its
// causal products are 1.08 GFLOP: 1.09 us at the 989 TFLOP/s of the bf16
// tensor cores. So bytes bound it; the kernel has to keep the tensor cores
// fed from tiles that arrive while it computes, and keep a unit's path
// short. What the design does:
//   * Tensor cores. A warpgroup (128 threads) holds a unit's 64 rows,
//     wgmma's M. S = Q K^T is eight m64n64k16 wgmmas (hd 128 in steps of
//     16) with Q and K read from shared memory; a product of two bf16
//     values is exact in fp32, as the reference's
//     preferred_element_type=float32 asks. TF32 is never used.
//   * P . V exact in p. The reference multiplies p as fp32. Each fp32 p is
//     split into three bf16 terms by truncation (split3), whose sum is p
//     bit for bit (tests/test_torch_flash_prefill.py pins it over [2^-100,
//     1]), and each term times a bf16 v is exact in fp32. So P . V is one
//     register-A m64n128k16 wgmma a term and 16 keys against the same V
//     tile: 3x the tensor work of a bf16 p, the price of the fp32 p. p goes
//     from the S accumulator's registers to the A fragments directly (the
//     accumulator of m64nNk16 and the A fragment of m64k16 share their row
//     and column layout), as FlashAttention-3 does. (P staged in shared
//     memory for a shared-memory A operand measured slower on an H100.)
//   * Two warpgroups a CTA, one CTA an SM: warpgroup g takes the first or
//     the second half of the item's tiles, with rings of its own, and the
//     halves meet in shared memory at the end (each merges and writes half
//     of the columns), so a unit of n tiles takes ceil(n / 2) tiles of
//     time and no merge of pieces through device memory. At S 512 every
//     unit is one item: 128 CTAs in one wave.
//   * bf16 tiles in shared memory, in wgmma's 128-byte swizzle. A 64-row
//     tile is two blocks of 64 rows x 128 B (hd 0-63, 64-127); row r's
//     16-byte chunk c lies at (c / 8) * 8 KB + 128 r + 16 ((c % 8) ^ (r %
//     8)). K is the K-major B operand of Q K^T as it stands (one block a
//     wgmma; 8-row groups 1 KB apart); V is the MN-major B operand of
//     P . V (the transpose flag; its two blocks 8 KB apart, the
//     descriptor's leading offset, and 8-key groups 1 KB apart, its stride).
//   * Loads overlap compute: cp.async, 16 B a thread at offsets fixed for
//     the thread, into each warpgroup's rings of two K and two V stages,
//     each tile's copies issued a tile ahead. Q (16 KB) and the rings
//     (2 x 64 KB) take 144 KB.
//   * The tensor cores overlap the softmax: S_{t+1} is issued before
//     P_t V_t, and P_{t+1}'s softmax runs while P_t V_t does.
//   * Sums the tensor cores' way only as far as a tile: they round their
//     fp32 sums toward zero, a bias that grows with the keys. With O as
//     their accumulator, several times as many output elements parted from
//     the plain version's bits at long S as with fp32 FMAs on widened
//     tiles, and a bf16 serving stream left its reference at a 3-step tie.
//     A tile's P V (12 steps) goes to a fresh accumulator, and the CUDA
//     cores fold it in, o = o * corr + pv in one rounding.
//   * The CUDA cores' share is kept small: the split is masks, subtractions
//     and byte permutes (no conversions, which run at a quarter rate); the
//     mask is applied only to tiles that cross the unit's diagonal; a row
//     is normalised by one reciprocal, not a division an element.
//   * Same numerics as the fp32 kernel otherwise: scores in log2 units and
//     one exp2f each; row max and sum over the four lanes of a row by
//     shuffles in a fixed order; no float atomics.
// Measured on an H100 (PERF.md): the CUDA cores' softmax, fold and split,
// with the tensor cores' turn, set a tile's time, not the bytes.
//
// Layout: q (B, H, Sq, 128), k/v (B, Kv, Sk, 128), out (B, H, Sq, 128), all
// contiguous bf16. Plain C interface (loaded with ctypes): returns
// cudaGetLastError() after the launch, so a refused launch is seen by the
// caller.

#include "flash_common.cuh"

namespace {

using namespace flash;

using bf16 = __nv_bfloat16;

constexpr int kTileBytes = kBK * kHd * 2;   // a 64-row bf16 tile: 16 KB
constexpr int kHalfBytes = kTileBytes / 2;  // its 64 x 64 block (128 B rows)
constexpr int kStages = 2;                  // stages of each of the K and V rings
constexpr int kGroups = 2;                  // warpgroups a CTA, each with its rings
constexpr int kCtaThreads = kGroups * kThreads;
// Q, then each warpgroup's rings, plus slack to put Q on a 1 KB boundary
// (the swizzle repeats every 8 rows of 128 B, and wgmma reads it from the
// address bits)
constexpr size_t kSmemBytes = 1024 + kTileBytes * (1 + kGroups * 2 * kStages);

// byte offset of (row r, 16-byte chunk c) in a swizzled 64-row tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 3) * kHalfBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading offset (between V's two 64-column blocks; unused for K-major
// operands) and the stride offset (between 8-row groups)
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo = 1024, uint32_t sbo = 1024) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// 64 rows of 128 bf16 from rows[r] into the swizzled tile at dst, by the
// N threads numbered t: 16 threads a row, thread t the chunk t % 16 of rows
// t / 16 + (N / 16) i, whose swizzle (row % 8) is the same for all i, so one
// offset serves them all
template <int N, typename RowOf>
__device__ __forceinline__ void load_tile(uint32_t dst, RowOf row_of, int t) {
  static_assert(N % 128 == 0, "rows N / 16 apart share their swizzle");
  const int r = t >> 4, c = t & 15;
  const uint32_t at = dst + sw128(r, c);
#pragma unroll
  for (int i = 0; i < kBK * 16 / N; ++i)
    cp_async16(at + i * (N / 16) * 128, row_of(r + i * (N / 16)) + 8 * c);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of wgmmas are in flight (they finish in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the barrier of warpgroup g's 128 threads alone (barrier 0 is the CTA's)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kThreads) : "memory");
}

// cp.async's writes (the generic proxy) made visible to wgmma's reads (the
// async proxy); a barrier then makes every thread's visible to all
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous window (the hardware writes them after the issue)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B (K-major) from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n128k16, A from registers, B MN-major from shared memory
__device__ __forceinline__ void wgmma_rs_t(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// max / sum over the 4 lanes that share a row of a wgmma accumulator
__device__ __forceinline__ float row_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The three bf16 terms of two fp32 values x, y (columns c, c + 1), each
// pair packed as an A fragment's 32-bit word (column c in the low half).
// A term is the top half of what is left, a bf16 by truncation: hi holds
// the value's first 8 significant bits, mid the next 8 of the remainder
// (exact in fp32, as hi is within a factor 2 of the value), lo the rest,
// at most 8 bits of the 24, so hi + mid + lo is the value exactly. Masks,
// subtractions and byte permutes run at the ALU's full rate, where
// conversions to bf16 run at a quarter of it.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  constexpr uint32_t kTop = 0xFFFF0000u;
  const uint32_t xh = __float_as_uint(x) & kTop, yh = __float_as_uint(y) & kTop;
  const float xr = x - __uint_as_float(xh), yr = y - __uint_as_float(yh);
  const uint32_t xm = __float_as_uint(xr) & kTop, ym = __float_as_uint(yr) & kTop;
  const uint32_t xl = __float_as_uint(xr - __uint_as_float(xm));
  const uint32_t yl = __float_as_uint(yr - __uint_as_float(ym));
  hi = __byte_perm(xh, yh, 0x7632);  // bytes 2, 3 of x, then 2, 3 of y
  mid = __byte_perm(xm, ym, 0x7632);
  lo = __byte_perm(xl, yl, 0x7632);
}

// items[i] = (unit, first tile | end tile << 16, partial slot or -1, merge
// index); merges[j] = (first slot, pieces, 0, 0); counters[j] is 0 on entry
// and left 0.
__global__ void __launch_bounds__(kCtaThreads, 1)
flash_prefill_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          const int4* __restrict__ items, const int4* __restrict__ merges,
                          int* __restrict__ counters, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int H, int Kv, int Gc, int Sq, int Sk,
                          int q_offset, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t Qs = (base + 1023u) & ~1023u;
  // warpgroup wg takes the first or the second half of the item's tiles,
  // with rings of its own: its j-th tile's K in K stage j % 2, V in V
  // stage j % 2
  const int wg = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  const uint32_t ring = Qs + kTileBytes * (1 + 2 * kStages * wg);
  const auto k_stage = [ring](int j) { return ring + kTileBytes * (j & 1); };
  const auto v_stage = [ring](int j) { return ring + kTileBytes * (kStages + (j & 1)); };

  const int4 item = items[blockIdx.x];
  const Unit u(item.x, H, Kv, Gc, Sq);
  const int lo = item.y & 0xffff, hi = item.y >> 16;
  const int mid = lo + (hi - lo + 1) / 2;
  const int kt0 = wg == 0 ? lo : mid;
  const int nt = wg == 0 ? mid - lo : hi - mid;
  const int part = item.z;
  // the wgmma accumulator layout: warp w of a warpgroup holds rows
  // 16w..16w+15; a thread rows r0 and r0 + 8, and in each 8-column block
  // columns cq and cq + 1
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  const int cq = 2 * (lane % 4);

  const bf16* kg = k + (static_cast<size_t>(u.b) * Kv + u.kvh) * Sk * kHd;
  const bf16* vg = v + (static_cast<size_t>(u.b) * Kv + u.kvh) * Sk * kHd;
  const auto load_k = [&](int j) {
    const bf16* src = kg + static_cast<size_t>(kt0 + j) * kBK * kHd;
    load_tile<kThreads>(k_stage(j), [&](int r) { return src + r * kHd; }, tid);
  };
  const auto load_v = [&](int j) {
    const bf16* src = vg + static_cast<size_t>(kt0 + j) * kBK * kHd;
    load_tile<kThreads>(v_stage(j), [&](int r) { return src + r * kHd; }, tid);
  };

  // scores in log2 units: exp(x) = exp2(x log2 e), one MUFU op
  const float scale2 = scale * 1.4426950408889634f;
  const int qpos[2] = {q_offset + u.pos(r0), q_offset + u.pos(r0 + 8)};
  const int qpos_min = q_offset + u.pos(0);  // the unit's first position
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // the accumulator layout: index i of S (32), of one tile's P V and of O
  // (64) is row r0 + 8 ((i / 2) % 2), column 8 (i / 4) + cq + i % 2. O
  // sums the tiles in fp32 on the CUDA cores, o = o * corr + pv, each in
  // one rounding: the tensor cores round their sums toward zero, so a tile
  // takes its 12 steps there and no more
  float o[64], pv[64] = {};
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float s[32] = {}, corr[2];
  // P_j as A fragments: term, key step kk (keys 16kk..16kk+15 = the
  // accumulator's blocks 2kk, 2kk+1), words (row r0, k 0-7), (r0 + 8, k
  // 0-7), (r0, k 8-15), (r0 + 8, k 8-15)
  uint32_t pa[3][kBK / 16][4] = {};

  // S = Q K_j^T into s, issued (the caller fences the registers first and
  // commits); the first step's scale-d = 0 ignores what s holds
  const auto issue_s = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
      wgmma_ss(s, desc(Qs + off), desc(k_stage(j) + off), kk > 0);
    }
  };
  // pv = P_j V_j, issued likewise: three terms a key step
  const auto issue_pv = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 3; ++w)
        wgmma_rs_t(pv, pa[w][kk], desc(v_stage(j) + kk * 16 * 128, kHalfBytes, 1024),
                   kk + w > 0);
  };
  // o = o * c + pv, the tile's P V in
  const auto fold = [&](const float (&c)[2]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = fmaf(o[i], c[(i >> 1) & 1], pv[i]);
  };
  // every register a wgmma of the stage reads or writes, fenced before the
  // stage's wgmma.fence and after its wait, as nothing else may touch them
  // while it is in flight
  const auto fence_regs = [&]() {
    reg_fence(s);
    reg_fence(pv);
#pragma unroll
    for (int w = 0; w < 3; ++w)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) reg_fence(pa[w][kk]);
  };
  // s = S_j -> P_j in place, with m and l updated and the factor corr that
  // o owes before P_j V_j is added
  const auto softmax = [&](int j) {
    const int key0 = (kt0 + j) * kBK;
    float mx[2] = {kNegInf, kNegInf}, rs[2] = {0.f, 0.f};
    if (key0 + kBK - 1 > qpos_min) {  // the tile crosses the unit's diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float sv = s[i] * scale2;
        if (qpos[r] < key0 + 8 * (i >> 2) + cq + (i & 1)) sv = kNegInf;
        s[i] = sv;
        mx[r] = fmaxf(mx[r], sv);
      }
    } else {  // every key of the tile is live for every row
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] *= scale2;
        mx[r] = fmaxf(mx[r], s[i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], row_max4(mx[r]));
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(s[i] - m[r]);
      rs[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + row_sum4(rs[r]);
  };
  const auto split = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        split3(s[8 * kk + 2 * w], s[8 * kk + 2 * w + 1], pa[0][kk][w], pa[1][kk][w],
               pa[2][kk][w]);
  };

  // Pipeline: S_{t+1} is issued before P_t V_t, and P_{t+1}'s softmax runs
  // on the CUDA cores while P_t V_t runs on the tensor cores. Groups of
  // copies: (Q, K_0), (V_0, K_1), then at tile t (V_{t+1}, K_{t+2}) into
  // the stages that S_t and P_{t-1} V_{t-1} have released; tile t waits for
  // the group issued one tile earlier. The last tile's P V runs alone, so
  // that no wgmma is issued under a branch of the steady loop.
  load_tile<kCtaThreads>(Qs, [&](int r) { return q + u.row(r, H, Sq); }, threadIdx.x);
  if (nt > 0) load_k(0);
  cp_async_commit();
  if (nt > 0) load_v(0);
  if (nt > 1) load_k(1);
  cp_async_commit();
  cp_async_wait<1>();  // Q (both warpgroups' copies) and K_0
  fence_proxy_async();
  __syncthreads();
  if (nt > 0) {
    fence_regs();
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs();
    softmax(0);
    split();
    group_sync(wg);  // every warp is done with K_0's stage
  }
  for (int t = 0; t + 1 < nt; ++t) {
    load_v(t + 1);
    if (t + 2 < nt) load_k(t + 2);
    cp_async_commit();
    cp_async_wait<1>();  // V_t and K_{t+1} have landed
    fence_proxy_async();
    group_sync(wg);
    fence_regs();
    wgmma_fence();
    issue_s(t + 1);
    wgmma_commit();
    issue_pv(t);
    wgmma_commit();
    wgmma_wait<1>();  // S_{t+1}; P_t V_t may still run
    reg_fence(s);
    const float corr_t[2] = {corr[0], corr[1]};
    softmax(t + 1);
    wgmma_wait<0>();
    fence_regs();
    fold(corr_t);
    split();
    group_sync(wg);  // V_t's and K_{t+1}'s stages are released
  }
  if (nt > 0) {  // the last tile: V_{nt-1} was in the last group
    cp_async_wait<0>();
    fence_proxy_async();
    group_sync(wg);
    fence_regs();
    wgmma_fence();
    issue_pv(nt - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs();
    fold(corr);
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  // The two halves meet: each warpgroup leaves in its own rings, thread for
  // thread (the same rows and columns), the half of o that the other one
  // writes, and its m and l; warpgroup g then merges columns 64g..64g+63,
  // m = max, l and o weighted by exp2(m_g - m) in the order of the halves
  float* const mine = reinterpret_cast<float*>(smem + (ring - base));
  const float* const theirs =
      reinterpret_cast<const float*>(smem + (Qs + kTileBytes * (1 + 2 * kStages * (1 - wg)) - base));
  const auto give = [&](int from) {  // o[from..from+31], then m and l
#pragma unroll
    for (int j = 0; j < 32; ++j) mine[j * kThreads + tid] = o[from + j];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[(32 + r) * kThreads + tid] = m[r];
      mine[(34 + r) * kThreads + tid] = l[r];
    }
  };
  __syncthreads();  // both warpgroups are done with their rings
  if (wg == 0) give(32); else give(0);
  __syncthreads();
  float c[2][2];  // the weights of halves 0 and 1, a row each
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mo = theirs[(32 + r) * kThreads + tid], lo = theirs[(34 + r) * kThreads + tid];
    const float m0 = wg == 0 ? m[r] : mo, m1 = wg == 0 ? mo : m[r];
    const float l0 = wg == 0 ? l[r] : lo, l1 = wg == 0 ? lo : l[r];
    const float mm = fmaxf(m0, m1);
    c[0][r] = exp2f(m0 - mm);
    c[1][r] = exp2f(m1 - mm);
    l[r] = fmaf(l0, c[0][r], l1 * c[1][r]);
    m[r] = mm;
  }
  const auto merge = [&](int from) {  // o[from..from+31] of both halves
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const float other = theirs[j * kThreads + tid];
      const float o0 = wg == 0 ? o[from + j] : other, o1 = wg == 0 ? other : o[from + j];
      o[from + j] = fmaf(o0, c[0][r], o1 * c[1][r]);
    }
  };
  // the whole unit: normalise (as merge_if_last's normalise) and write; a
  // piece: its partial
  const auto write = [&](int from) {
    if (part < 0) {
      const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
      bf16* orow[2] = {out + u.row(r0, H, Sq), out + u.row(r0 + 8, H, Sq)};
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int i = from + j, r = (j >> 1) & 1;
        *reinterpret_cast<__nv_bfloat162*>(orow[r] + 8 * (i >> 2) + cq) =
            __floats2bfloat162_rn(o[i] * inv[r], o[i + 1] * inv[r]);
      }
      return;
    }
    float* pacc = part_acc + static_cast<size_t>(part) * kRowsQ * kHd;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int i = from + j, row = r0 + 8 * ((j >> 1) & 1);
      *reinterpret_cast<float2*>(pacc + row * kHd + 8 * (i >> 2) + cq) =
          make_float2(o[i], o[i + 1]);
    }
  };
  if (wg == 0) {
    merge(0);
    write(0);
  } else {
    merge(32);
    write(32);
  }
  if (part < 0) return;
  if (wg == 0 && lane % 4 == 0) {  // the piece's m[64], then l[64]
    float* pml = part_ml + static_cast<size_t>(part) * 2 * kRowsQ;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pml[r0 + 8 * r] = m[r];
      pml[kRowsQ + r0 + 8 * r] = l[r];
    }
  }
  // the unit's last piece merges, with every thread of the CTA
  merge_if_last<bf16, kCtaThreads>(item, u, merges, counters, part_acc, part_ml, out, H, Sq);
}

}  // namespace

// q (B, H, Sq, 128), k / v (B, Kv, Sk, 128), out (B, H, Sq, 128): bf16,
// contiguous on the current device, 16-byte aligned; the rest as
// repro_flash_prefill's (flash_prefill.cu), whose arguments it takes.
extern "C" int repro_flash_prefill_bf16(const void* q, const void* k, const void* v,
                                        void* out, const void* items, int n_items,
                                        const void* merges, void* counters, void* part_acc,
                                        void* part_ml, int B, int H, int Kv, int Gc, int Sq,
                                        int Sk, int q_offset, float scale, void* stream) {
  if (bad_shape(B, H, Kv, Gc, Sq, Sk, q_offset, n_items))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return 0;
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(flash_prefill_bf16_kernel, kSmemBytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_prefill_bf16_kernel<<<n_items, kCtaThreads, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<const int4*>(items),
      static_cast<const int4*>(merges), static_cast<int*>(counters),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, Kv, Gc, Sq, Sk,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}
