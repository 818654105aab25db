// Score-weighted multi-model aggregation, paper eq 1, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/weighted_agg/kernel.py::multi_weighted_agg_2d
// (the Pallas TPU kernel): out (M, D) = W (M, B) . U (B, D) / denoms[:, None],
// accumulated in float32. U holds the B trained (model, device) pair payloads
// of one flattened parameter leaf; row m of W weights the pairs of model m.
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
#include <cuda_runtime.h>

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
