// ADT Bitpack for Hopper: fp32 -> MSB-first uint8 byte planes.
//
// Replaces the TPU kernel src/repro/kernels/bitpack.py::bitpack_2d (body
// _bitpack_kernel). Plane k holds byte k (MSB first) of the uint32 view of
// every weight; the planes are the wire format and must be byte-equal to
// repro_torch/kernels/ref.py::bitpack_ref.
//
// Bound: memory. Each element is read once (4 B) and written once per kept
// plane (round_to B); there is no arithmetic to speak of. The design moves
// those bytes in the widest accesses the layout allows: each thread loads
// one float4 (16 B) and stores one uchar4 (4 B) into each of the round_to
// planes, and neighbouring threads touch neighbouring addresses, so every
// warp access is fully coalesced. The TPU path padded the input to
// (256 x 128) tiles; here any length is taken as it is. The vector path
// needs n % 4 == 0 (so every plane row starts 4-byte aligned) and a 16-byte
// aligned input; any other length runs the one-element-per-thread path.
// A grid-stride loop over one wave of resident blocks covers any n.
//
// Plain C interface (loaded with ctypes): returns cudaGetLastError() after
// the launch, so a refused launch is seen by the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned char byte_of(uint32_t u, int k) {
  return static_cast<unsigned char>((u >> (24 - 8 * k)) & 0xFFu);
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
bitpack_vec4(const float4* __restrict__ w, uchar4* __restrict__ planes,
             int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 v = w[i];
    const uint32_t a = __float_as_uint(v.x);
    const uint32_t b = __float_as_uint(v.y);
    const uint32_t c = __float_as_uint(v.z);
    const uint32_t d = __float_as_uint(v.w);
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      planes[k * n4 + i] =
          make_uchar4(byte_of(a, k), byte_of(b, k), byte_of(c, k), byte_of(d, k));
    }
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
bitpack_scalar(const float* __restrict__ w, unsigned char* __restrict__ planes,
               int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t u = __float_as_uint(w[i]);
#pragma unroll
    for (int k = 0; k < RT; ++k) planes[k * n + i] = byte_of(u, k);
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
void launch(const void* w, void* planes, int64_t n, cudaStream_t stream) {
  const bool vec = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(planes) % 4 == 0);
  const int64_t work = vec ? n / 4 : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < wave_blocks() ? want : wave_blocks());
  if (vec) {
    bitpack_vec4<RT><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float4*>(w), static_cast<uchar4*>(planes), work);
  } else {
    bitpack_scalar<RT><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(w), static_cast<unsigned char*>(planes), n);
  }
}

}  // namespace

// w: n contiguous fp32 on the device; planes: (round_to, n) contiguous u8.
extern "C" int repro_bitpack(const void* w, void* planes, long long n,
                             int round_to, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (round_to) {
    case 1: launch<1>(w, planes, n, st); break;
    case 2: launch<2>(w, planes, n, st); break;
    case 3: launch<3>(w, planes, n, st); break;
    case 4: launch<4>(w, planes, n, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
