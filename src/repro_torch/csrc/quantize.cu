// Blockwise symmetric int8/int4 transport quantization (paper §3.4) for
// Hopper (sm_90a).
//
// quantize replaces src/repro/kernels/quantize/kernel.py::quantize_2d and
// dequantize replaces ::dequantize_2d (the Pallas TPU kernels). For each
// block of 128 values along a row of x (R, n):
//   s = max(max|x| / qmax, 1e-12),  q = clip(round_half_even(x / s), +-qmax)
// q is int8 (R, n_pad) with n_pad = 128 * ceil(n / 128) and the ragged tail
// of each row quantized as zeros, as the reference pads; scales are float32
// (R, n_pad / 128). dequantize computes x = q * s[block] into (R, n).
//
// Bound: bytes. quantize reads 4 bytes and writes 1 byte per value plus 4
// bytes per 128 values; dequantize the reverse. The few flops per value are
// nothing beside that. One warp owns one 128-value block: each lane loads
// four values (one 16-byte load where the row allows it), the block maximum
// is a five-step __shfl_xor_sync reduction in registers, and each lane
// stores its four codes as one 4-byte char4. Rows are independent, so one
// launch quantizes every row of a stacked (A, n) leaf view: the same blocks
// as the reference's per-row quantize_leaf.
//
// Numerics match the reference exactly: IEEE division x / s (this file is
// built without --use_fast_math) and rintf, which rounds half to even as
// jnp.round does (roundf would round half away from zero).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;    // values per scale: one warp, four per lane
constexpr int kThreads = 256;  // eight warps per thread block

template <bool kVec>
__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ scales, long long R,
                                long long n, long long nb, float qmax) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= R * nb) return;  // whole warps leave together
  const long long r = warp / nb;
  const long long blk = warp - r * nb;
  const long long c0 = blk * kBlock + lane * 4;
  const float* row = x + r * n;

  float v[4];
  if (kVec && c0 + 4 <= n) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row + c0));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c0 + c < n ? __ldg(row + c0 + c) : 0.f;
  }

  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                     fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax / qmax, 1e-12f);

  signed char code[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    code[c] = static_cast<signed char>(
        fminf(fmaxf(rintf(v[c] / s), -qmax), qmax));
  *reinterpret_cast<char4*>(q + r * nb * kBlock + c0) =
      make_char4(code[0], code[1], code[2], code[3]);
  if (lane == 0) scales[r * nb + blk] = s;
}

template <bool kVec>
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, long long R,
                                  long long n, long long nb,
                                  long long col_blocks) {
  const long long r = blockIdx.x / col_blocks;
  const long long cb = blockIdx.x - r * col_blocks;
  const long long c0 = (cb * kThreads + threadIdx.x) * 4;
  if (r >= R || c0 >= n) return;
  // four values never straddle a 128-block: c0 % 4 == 0
  const char4 t = *reinterpret_cast<const char4*>(q + r * nb * kBlock + c0);
  const float s = scales[r * nb + c0 / kBlock];
  const float v[4] = {static_cast<float>(t.x) * s, static_cast<float>(t.y) * s,
                      static_cast<float>(t.z) * s, static_cast<float>(t.w) * s};
  float* o = out + r * n + c0;
  if (kVec && c0 + 4 <= n) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int c = 0; c < 4 && c0 + c < n; ++c) o[c] = v[c];
  }
}

}  // namespace

// Both launchers run on `stream` and return cudaGetLastError() as an int.
// vec != 0 requires n % 4 == 0 and 16-byte aligned float pointers; the int8
// pointers must be 4-byte aligned.
extern "C" int fedcd_quantize(const float* x, int8_t* q, float* scales,
                              long long R, long long n, float qmax, int vec,
                              void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  const long long warps = R * nb;
  const unsigned blocks =
      static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    quantize_kernel<true><<<blocks, kThreads, 0, s>>>(x, q, scales, R, n, nb,
                                                      qmax);
  } else {
    quantize_kernel<false><<<blocks, kThreads, 0, s>>>(x, q, scales, R, n,
                                                       nb, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fedcd_dequantize(const int8_t* q, const float* scales,
                                float* out, long long R, long long n, int vec,
                                void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  const long long col_blocks = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  const unsigned blocks = static_cast<unsigned>(R * col_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    dequantize_kernel<true><<<blocks, kThreads, 0, s>>>(q, scales, out, R, n,
                                                        nb, col_blocks);
  } else {
    dequantize_kernel<false><<<blocks, kThreads, 0, s>>>(q, scales, out, R,
                                                         n, nb, col_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
