// Score-weighted aggregation, paper eq 1, for Hopper (sm_90a): two kernels.
//
// eq1_agg_kernel serves both eq-1 wrappers. multi_weighted_agg replaces
// src/repro/kernels/weighted_agg/kernel.py::multi_weighted_agg_2d (the Pallas
// TPU kernel): out (M, D) = W (M, B) . U (B, D) / denoms[:, None], accumulated
// in float32, one IEEE division by the denominator at the end. U holds the B
// trained (model, device) pair payloads of one flattened parameter leaf; row m
// of W weights the pairs of model m. weighted_agg replaces ::weighted_agg_2d,
// the legacy engines' single-model form: w (N,) and a 0-d denom are W (1, N)
// and denoms (1,), the same FMA chain with one model row. Rows of weight 0 are
// multiplied like any other, as the reference does, so a non-finite row
// poisons the result. The denominators are read on the device.
//
// Bytes bound it. 2*M*B*D flops over (B + M)*D*4 bytes is at most about M/2
// flops per byte, far below the card's float32 ridge of about 20. So the
// design streams U once and spends its effort on bytes in flight and on
// launches:
// - One launch per call, over every leaf of it. The leaf table (U and out
//   pointers, lengths, each leaf's first tile) is a kernel parameter passed by
//   value (__grid_constant__, at most kMaxLeaves leaves, under 1 KB), so no
//   pointer table is copied from the host; the wrapper splits larger groups
//   into more launches. Each block finds its leaf by a binary search over the
//   first tiles, so the small leaves (biases, the last dense layers) run beside
//   the big ones on spare SMs instead of one launch after another.
// - A block owns a column tile of one warp's width, 32 lanes x 4 floats = 128
//   columns, read as float4. Its 8 warps split the B rows; each warp loads 4
//   rows at once (B = 32 pairs: every row of the tile in flight together),
//   and the first rows go out before the weights are staged. Each lane keeps
//   MT x 4 running sums in registers. MT, the register tile, is the smallest
//   of 1, 2, 4, 8 that holds min(M, 8) rows; a larger M takes one more pass
//   per chunk of 8 over the block's rows, which the first pass left in L1 or
//   L2. (A 16-row tile needed 128-158 registers and was slower at M = 16 than
//   two passes of 8 under a 64-register cap; see PERF.md.)
// - Shared memory holds the weights (transposed, so a row's MT weights are one
//   or two vector loads), the denominators and the warps' partial sums (32 KB
//   at MT = 8). The partials are added in warp order (deterministic) and
//   divided by one pass of the whole block, with coalesced 4-byte stores.
//   Past 48 KB the launcher lifts the block's limit and checks that it took.
// - Tensor cores are not used: they would buy nothing on a bytes-bound
//   product, and TF32 keeps about 10 mantissa bits, which misses the 1e-5 bar
//   against the float32 reference.
// - Plain unrolled float4 loads, no TMA ring: the largest CNN leaf already
//   streams at about 76% of the card's 3.35 TB/s at the paths' shapes
//   (PERF.md).
// - A ragged D (not a multiple of 4) or an unaligned U takes a masked scalar
//   path (lane l reads columns l, l + 32, l + 64, l + 96 of the tile), so no
//   padding to the TPU's 2048-lane tiles is needed.
// - No --use_fast_math: the division is IEEE division, as in the reference.
//
// dequant_agg replaces ::dequant_agg_2d: the single-model sum over int8
// payloads q (N, D) with float32 scales (N, D / block), each value dequantized
// in registers as float(q) * s[n, d / block] and then weighted. Bound: bytes
// (N*D codes + N*D/block*4 scales in, D*4 out). A thread owns four columns and
// loads its four codes as one 4-byte char4 where D, block and the pointers
// allow, else scalars.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

// ---- eq 1, one grouped launch -------------------------------------------

constexpr int kMaxLeaves = 32;  // leaves per launch (the table's size)
constexpr int kLanes = 32;
constexpr int kTile = kLanes * 4;  // columns per block: one float4 a lane
constexpr int kWarps = 8;          // warps per block, splitting the rows
constexpr int kRows = 4;           // rows a warp has in flight
constexpr int kMaxMT = 8;          // model rows per pass over U

// Passed by value: lives in the kernel's parameter space.
struct LeafTable {
  const float* u[kMaxLeaves];  // (B, d) payloads
  float* out[kMaxLeaves];      // (M, d) results
  long long d[kMaxLeaves];
  int tile0[kMaxLeaves + 1];   // first tile of each leaf; tile0[n] = grid
  int n;
};

// The weights are staged transposed, (B, Mp) with Mp = M rounded up to MT
// and zero-filled, so that a row's MT weights are one or two vector loads.
__host__ __device__ inline int padded_rows(int M, int MT) {
  return (M + MT - 1) / MT * MT;
}

template <int MT>
size_t eq1_smem(int B, int M) {
  return (static_cast<size_t>(kWarps) * MT * kTile +
          static_cast<size_t>(B) * padded_rows(M, MT) + M) *
         sizeof(float);
}

template <int MT>
__device__ __forceinline__ void load_weights(const float* p, float (&wv)[MT]) {
  if constexpr (MT == 1) {
    wv[0] = p[0];
  } else if constexpr (MT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    wv[0] = x.x;
    wv[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < MT / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      wv[4 * q] = x.x;
      wv[4 * q + 1] = x.y;
      wv[4 * q + 2] = x.z;
      wv[4 * q + 3] = x.w;
    }
  }
}

// At most 64 registers a thread, so that four blocks fit on an SM.
template <int MT>
__global__ void __launch_bounds__(kWarps * kLanes, 4)
    eq1_agg_kernel(const __grid_constant__ LeafTable t,
                   const float* __restrict__ w,
                   const float* __restrict__ denoms, int B, int M) {
  const int Mp = padded_rows(M, MT);
  extern __shared__ float smem[];
  float* sred = smem;                      // (kWarps, MT, kTile) partials
  float* sw = smem + kWarps * MT * kTile;  // (B, Mp) weights, transposed
  float* sden = sw + B * Mp;               // (M,) denominators

  // this block's leaf: the last whose first tile is <= blockIdx.x
  const int tile = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.tile0[mid] <= tile) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const float* __restrict__ u = t.u[lo];
  float* __restrict__ out = t.out[lo];
  const long long D = t.d[lo];
  const long long col0 = static_cast<long long>(tile - t.tile0[lo]) * kTile;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  // this lane's four columns: neighbours (one float4) or a stride of 32
  const int first = vec ? 4 * lane : lane;
  const int step = vec ? 1 : kLanes;

  // rows b0, b0 + kWarps, ... of this lane's columns; zeros past B and D
  auto load_rows = [&](float (&v)[kRows][4], int b0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r * kWarps;
      const float* row = u + static_cast<long long>(b < B ? b : 0) * D + col0;
      if (vec) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (b < B && col0 + first < D)
          x = __ldg(reinterpret_cast<const float4*>(row + first));
        v[r][0] = x.x;
        v[r][1] = x.y;
        v[r][2] = x.z;
        v[r][3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = first + c * step;
          v[r][c] = b < B && col0 + k < D ? __ldg(row + k) : 0.f;
        }
      }
    }
  };

  // the first rows go out before the weights are staged: the block's first
  // HBM round trip overlaps the weights' L2 one
  float v[kRows][4];
  load_rows(v, warp);
  for (int i = threadIdx.x; i < B * Mp; i += blockDim.x) {
    const int b = i / Mp, m = i % Mp;
    sw[i] = m < M ? w[m * B + b] : 0.f;
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) sden[i] = denoms[i];
  __syncthreads();

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mc = M - m0 < MT ? M - m0 : MT;
    float acc[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

    // M > kMaxMT: one more pass over the block's rows, which the first pass
    // left in L1 or L2
    if (m0 > 0) load_rows(v, warp);
    for (int b0 = warp; b0 < B; b0 += kWarps * kRows) {
      if (b0 > warp) load_rows(v, b0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r * kWarps;
        if (b < B) {
          float wv[MT];
          load_weights<MT>(sw + b * Mp + m0, wv);
#pragma unroll
          for (int j = 0; j < MT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[j][c] = fmaf(wv[j], v[r][c], acc[j][c]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < mc) {
        float* p = sred + (warp * MT + j) * kTile;
        if (vec) {
          *reinterpret_cast<float4*>(p + first) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) p[first + c * step] = acc[j][c];
        }
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < mc * kTile; o += blockDim.x) {
      const int j = o / kTile;
      const int c = o % kTile;
      if (col0 + c < D) {
        float s = sred[j * kTile + c];
#pragma unroll
        for (int p = 1; p < kWarps; ++p) s += sred[(p * MT + j) * kTile + c];
        out[static_cast<long long>(m0 + j) * D + col0 + c] = s / sden[m0 + j];
      }
    }
    __syncthreads();  // the next pass reuses the partials
  }
}

template <int MT>
int launch_eq1(const LeafTable& t, const float* w, const float* denoms, int B,
               int M, cudaStream_t s) {
  const size_t smem = eq1_smem<MT>(B, M);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        eq1_agg_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>(t.tile0[t.n]);
  eq1_agg_kernel<MT><<<blocks, kWarps * kLanes, smem, s>>>(t, w, denoms, B,
                                                           M);
  return static_cast<int>(cudaGetLastError());
}

// ---- dequantize and aggregate -------------------------------------------

constexpr int kThreads = 256;  // threads per block
constexpr int kCols = 4;       // columns per thread

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

// The most leaves one fedcd_eq1_agg call takes (one launch each call).
extern "C" int fedcd_eq1_max_leaves() { return kMaxLeaves; }

// Eq 1 over n leaves in one launch on `stream`: out[i] (M, d[i]) =
// w (M, B) . u[i] (B, d[i]) / denoms[:, None]. u, out and d are host arrays
// of n entries, 1 <= n <= fedcd_eq1_max_leaves(), each d[i] >= 1; w and
// denoms are device pointers. Returns a CUDA error code as an int (0 = ok):
// cudaErrorInvalidValue for bad arguments, else cudaGetLastError().
extern "C" int fedcd_eq1_agg(const float* const* u, float* const* out,
                             const long long* d, int n, const float* w,
                             const float* denoms, int B, int M,
                             void* stream) {
  if (n < 1 || n > kMaxLeaves || B < 0 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable t = {};
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (d[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    t.u[i] = u[i];
    t.out[i] = out[i];
    t.d[i] = d[i];
    t.tile0[i] = static_cast<int>(tiles);
    tiles += (d[i] + kTile - 1) / kTile;
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.tile0[n] = static_cast<int>(tiles);
  t.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch_eq1<1>(t, w, denoms, B, M, s);
  if (M <= 2) return launch_eq1<2>(t, w, denoms, B, M, s);
  if (M <= 4) return launch_eq1<4>(t, w, denoms, B, M, s);
  return launch_eq1<kMaxMT>(t, w, denoms, B, M, s);
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
