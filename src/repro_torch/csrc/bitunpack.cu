// ADT Bitunpack for Hopper: MSB-first uint8 byte planes -> fp32.
//
// Replaces the TPU kernel src/repro/kernels/bitunpack.py::bitunpack_2d
// (body _bitunpack_kernel), the GPU side of the paper's own pipeline
// (its CUDA Bitunpack, Algorithm 5): OR the kept planes into a uint32
// word, leave the dropped low bytes zero, and reinterpret as fp32. The
// result must be bit-equal to repro_torch/kernels/ref.py::bitunpack_ref.
//
// Bound: memory. Each element reads round_to B and writes 4 B. As in
// bitpack.cu, each thread reads one uchar4 from every kept plane and
// writes one float4, so all warp accesses are coalesced and 4 or 16 bytes
// wide; lengths that are not a multiple of 4 (or misaligned pointers) run
// the one-element-per-thread path. One wave of resident blocks walks the
// array with a grid-stride loop.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int RT>
__global__ void __launch_bounds__(kThreads)
bitunpack_vec4(const uchar4* __restrict__ planes, float4* __restrict__ out,
               int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    uint32_t a = 0, b = 0, c = 0, d = 0;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const uchar4 p = planes[k * n4 + i];
      const int s = 24 - 8 * k;
      a |= static_cast<uint32_t>(p.x) << s;
      b |= static_cast<uint32_t>(p.y) << s;
      c |= static_cast<uint32_t>(p.z) << s;
      d |= static_cast<uint32_t>(p.w) << s;
    }
    out[i] = make_float4(__uint_as_float(a), __uint_as_float(b),
                         __uint_as_float(c), __uint_as_float(d));
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
bitunpack_scalar(const unsigned char* __restrict__ planes,
                 float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t u = 0;
#pragma unroll
    for (int k = 0; k < RT; ++k)
      u |= static_cast<uint32_t>(planes[k * n + i]) << (24 - 8 * k);
    out[i] = __uint_as_float(u);
  }
}

int wave_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    blocks = sms * (per_sm / kThreads);
  }
  return blocks;
}

template <int RT>
void launch(const void* planes, void* out, int64_t n, cudaStream_t stream) {
  const bool vec = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(planes) % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t work = vec ? n / 4 : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < wave_blocks() ? want : wave_blocks());
  if (vec) {
    bitunpack_vec4<RT><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uchar4*>(planes), static_cast<float4*>(out), work);
  } else {
    bitunpack_scalar<RT><<<blocks, kThreads, 0, stream>>>(
        static_cast<const unsigned char*>(planes), static_cast<float*>(out), n);
  }
}

}  // namespace

// planes: (round_to, n) contiguous u8 on the device; out: n contiguous fp32.
extern "C" int repro_bitunpack(const void* planes, void* out, long long n,
                               int round_to, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (round_to) {
    case 1: launch<1>(planes, out, n, st); break;
    case 2: launch<2>(planes, out, n, st); break;
    case 3: launch<3>(planes, out, n, st); break;
    case 4: launch<4>(planes, out, n, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
