// Score-weighted aggregation, paper eq 1, for Hopper (sm_90a): three kernels.
//
// multi_weighted_agg replaces
// src/repro/kernels/weighted_agg/kernel.py::multi_weighted_agg_2d (the Pallas
// TPU kernel): out (M, D) = W (M, B) . U (B, D) / denoms[:, None], accumulated
// in float32. U holds the B trained (model, device) pair payloads of one
// flattened parameter leaf; row m of W weights the pairs of model m.
//
// Bound: bytes. The call must read U (B*D*4 bytes), W and denoms once and
// write out (M*D*4 bytes); it does 2*M*B*D flops, about M/2 flops per byte
// with M <= 16 aggregated models, far below the card's float32 ridge. So the
// design streams U exactly once: each thread owns four neighbouring columns
// (one 16-byte load per pair row), keeps up to 16 running sums per column in
// registers, and reads W and the denominators from shared memory. A ragged D
// (not a multiple of 4, or an unaligned pointer) takes the scalar path and is
// masked, so no padding to the TPU's 2048-lane tiles is needed. The division
// by the denominator is IEEE division at the end, as in the reference.
//
// weighted_agg replaces ::weighted_agg_2d: out (D,) = sum_n w[n] * U[n] /
// denom, the single-model eq 1 of the legacy engines. Bound: bytes (N*D*4 in,
// D*4 out, 2*N*D flops). The same design with one model row: a thread owns
// four columns, streams the N rows once (float4 where it can, masked scalars
// otherwise), reads w from shared memory and the 0-d denominator from device
// memory, and divides once at the end. Rows of weight 0 are multiplied like
// any other, as the reference does, so a non-finite row poisons the result.
//
// dequant_agg replaces ::dequant_agg_2d: the same sum over int8 payloads q
// (N, D) with float32 scales (N, D / block), each value dequantized in
// registers as float(q) * s[n, d / block] and then weighted. Bound: bytes
// (N*D codes + N*D/block*4 scales in, D*4 out). A thread loads its four codes
// as one 4-byte char4 where D, block and the pointers allow, else scalars.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kCols = 4;       // columns per thread (one float4)
constexpr int kMChunk = 16;    // model rows accumulated per pass over U

template <bool kVec>
__global__ void multi_weighted_agg_kernel(const float* __restrict__ u,
                                          const float* __restrict__ w,
                                          const float* __restrict__ denoms,
                                          float* __restrict__ out, int B,
                                          int M, long long D) {
  extern __shared__ float smem[];
  float* sw = smem;            // (M, B) weights
  float* sden = smem + M * B;  // (M,) denominators
  for (int i = threadIdx.x; i < M * B; i += blockDim.x) sw[i] = w[i];
  for (int i = threadIdx.x; i < M; i += blockDim.x) sden[i] = denoms[i];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kCols;
  if (col >= D) return;
  const int ncols = static_cast<int>(D - col < kCols ? D - col : kCols);

  // more than kMChunk models: one more pass over U per chunk of rows
  for (int m0 = 0; m0 < M; m0 += kMChunk) {
    const int mc = M - m0 < kMChunk ? M - m0 : kMChunk;
    float acc[kMChunk][kCols];
#pragma unroll
    for (int j = 0; j < kMChunk; ++j)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[j][c] = 0.f;

    for (int b = 0; b < B; ++b) {
      const float* row = u + static_cast<long long>(b) * D + col;
      float v[kCols];
      if (kVec) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(row));
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[c] = c < ncols ? __ldg(row + c) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMChunk; ++j) {
        if (j < mc) {
          const float wj = sw[(m0 + j) * B + b];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[j][c] = fmaf(wj, v[c], acc[j][c]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kMChunk; ++j) {
      if (j < mc) {
        const float den = sden[m0 + j];
        float* o = out + static_cast<long long>(m0 + j) * D + col;
        if (kVec) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[j][0] / den, acc[j][1] / den, acc[j][2] / den,
                          acc[j][3] / den);
        } else {
          for (int c = 0; c < ncols; ++c) o[c] = acc[j][c] / den;
        }
      }
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ p, int ncols,
                                      float v[kCols]) {
  if (kVec) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = c < ncols ? __ldg(p + c) : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ o, int ncols,
                                       const float acc[kCols], float den) {
  if (kVec) {
    *reinterpret_cast<float4*>(o) = make_float4(
        acc[0] / den, acc[1] / den, acc[2] / den, acc[3] / den);
  } else {
    for (int c = 0; c < ncols; ++c) o[c] = acc[c] / den;
  }
}

template <bool kVec>
__global__ void weighted_agg_kernel(const float* __restrict__ u,
                                    const float* __restrict__ w,
                                    const float* __restrict__ denom,
                                    float* __restrict__ out, int N,
                                    long long D) {
  extern __shared__ float sw[];  // (N,) weights
  for (int i = threadIdx.x; i < N; i += blockDim.x) sw[i] = w[i];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kCols;
  if (col >= D) return;
  const int ncols = static_cast<int>(D - col < kCols ? D - col : kCols);

  float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float v[kCols];
    load4<kVec>(u + static_cast<long long>(n) * D + col, ncols, v);
    const float wn = sw[n];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = fmaf(wn, v[c], acc[c]);
  }
  store4<kVec>(out + col, ncols, acc, __ldg(denom));
}

template <bool kVec>
__global__ void dequant_agg_kernel(const int8_t* __restrict__ q,
                                   const float* __restrict__ scales,
                                   const float* __restrict__ w,
                                   const float* __restrict__ denom,
                                   float* __restrict__ out, int N,
                                   long long D, int block) {
  extern __shared__ float sw[];  // (N,) weights
  for (int i = threadIdx.x; i < N; i += blockDim.x) sw[i] = w[i];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kCols;
  if (col >= D) return;
  const int ncols = static_cast<int>(D - col < kCols ? D - col : kCols);
  const long long nb = D / block;
  // each column's scale block; on the char4 path all four share one
  long long sblk[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) sblk[c] = (col + (c < ncols ? c : 0)) / block;

  float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const int8_t* row = q + static_cast<long long>(n) * D + col;
    const float* srow = scales + static_cast<long long>(n) * nb;
    float v[kCols];
    if (kVec) {
      const char4 c4 = __ldg(reinterpret_cast<const char4*>(row));
      const float s = __ldg(srow + sblk[0]);
      v[0] = static_cast<float>(c4.x) * s;
      v[1] = static_cast<float>(c4.y) * s;
      v[2] = static_cast<float>(c4.z) * s;
      v[3] = static_cast<float>(c4.w) * s;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        v[c] = c < ncols
                   ? static_cast<float>(__ldg(row + c)) * __ldg(srow + sblk[c])
                   : 0.f;
    }
    const float wn = sw[n];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = fmaf(v[c], wn, acc[c]);
  }
  store4<kVec>(out + col, ncols, acc, __ldg(denom));
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// vec != 0 requires D % 4 == 0 and 16-byte aligned u and out.
extern "C" int fedcd_multi_weighted_agg(const float* u, const float* w,
                                        const float* denoms, float* out,
                                        int B, int M, long long D, int vec,
                                        void* stream) {
  const long long threads = (D + kCols - 1) / kCols;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(M) * (B + 1) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    multi_weighted_agg_kernel<true><<<blocks, kThreads, smem, s>>>(
        u, w, denoms, out, B, M, D);
  } else {
    multi_weighted_agg_kernel<false><<<blocks, kThreads, smem, s>>>(
        u, w, denoms, out, B, M, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// vec != 0 requires D % 4 == 0 and 16-byte aligned u and out.
extern "C" int fedcd_weighted_agg(const float* u, const float* w,
                                  const float* denom, float* out, int N,
                                  long long D, int vec, void* stream) {
  const long long threads = (D + kCols - 1) / kCols;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(N) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    weighted_agg_kernel<true><<<blocks, kThreads, smem, s>>>(u, w, denom, out,
                                                             N, D);
  } else {
    weighted_agg_kernel<false><<<blocks, kThreads, smem, s>>>(u, w, denom,
                                                              out, N, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// Requires D % block == 0. vec != 0 requires D % 4 == 0, block % 4 == 0,
// a 4-byte aligned q and a 16-byte aligned out.
extern "C" int fedcd_dequant_agg(const int8_t* q, const float* scales,
                                 const float* w, const float* denom,
                                 float* out, int N, long long D, int block,
                                 int vec, void* stream) {
  const long long threads = (D + kCols - 1) / kCols;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(N) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    dequant_agg_kernel<true><<<blocks, kThreads, smem, s>>>(
        q, scales, w, denom, out, N, D, block);
  } else {
    dequant_agg_kernel<false><<<blocks, kThreads, smem, s>>>(
        q, scales, w, denom, out, N, D, block);
  }
  return static_cast<int>(cudaGetLastError());
}
