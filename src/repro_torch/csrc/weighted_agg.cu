// Score-weighted aggregation, paper eq 1, for Hopper (sm_90a): one kernel
// body for the three eq-1 forms of the reference.
//
// eq1_agg_kernel<MT, P> computes out (M, D) = W (M, B) . X (B, D) /
// denoms[:, None] over every leaf of a call, accumulated in float32 with one
// IEEE division by the denominator at the end. The payload P says what a row
// of X is and how it is loaded:
// - float32 (F32Payload). multi_weighted_agg replaces
//   src/repro/kernels/weighted_agg/kernel.py::multi_weighted_agg_2d (the
//   Pallas TPU kernel): X holds the B trained (model, device) pair payloads of
//   one flattened parameter leaf; row m of W weights the pairs of model m.
//   weighted_agg replaces ::weighted_agg_2d, the legacy engines'
//   single-model form: w (N,) and a 0-d denom are W (1, N) and denoms (1,).
// - int8 codes with float32 block scales (I8Payload). dequant_agg replaces
//   ::dequant_agg_2d: the single-model sum over q (N, D) with scales
//   (N, D / block). Each code is dequantized in registers as
//   float(q) * s[n, d / block] and then weighted in the same FMA chain, the
//   reference's order (dequantize, then weight).
// Rows of weight 0 are multiplied like any other, as the reference does, so
// a non-finite row (or scale) poisons the result. The denominators are read
// on the device.
//
// Bytes bound it. A float32 payload does 2*M flops per 4 bytes of X, an int8
// one 4 operations per byte: far below the card's float32 ridge of about 20.
// So the design streams X once and spends its effort on bytes in flight and
// on launches:
// - One launch per call, over every leaf of it. The leaf table (payload,
//   scale and out pointers, lengths, each leaf's first tile) is a kernel
//   parameter passed by value (__grid_constant__, at most kMaxLeaves leaves,
//   under 1.2 KB), so no pointer table is copied from the host; the wrapper
//   splits larger groups into more launches. Each block finds its leaf by a
//   binary search over the first tiles, so the small leaves (biases, the
//   last dense layers) run beside the big ones on spare SMs instead of one
//   launch after another.
// - A block owns a column tile of one warp's width: 32 lanes x V columns,
//   one 16-byte load a lane per row (V = 4 floats, or 16 int8 codes: a warp
//   moves 512 B per row step either way). Its 8 warps split the B rows; each
//   warp loads 4 rows at once (B = 32: every row of the tile in flight
//   together), and the first rows go out before the weights are staged. Each
//   lane keeps MT x V running sums in registers. MT, the register tile, is
//   the smallest of 1, 2, 4, 8 that holds min(M, 8) rows; a larger M takes
//   one more pass per chunk of 8 over the block's rows, which the first pass
//   left in L1 or L2. (A 16-row tile needed 128-158 registers and was slower
//   at M = 16 than two passes of 8 under a 64-register cap; see PERF.md.)
// - int8: when block % V == 0 a lane's V columns lie in one scale block, so
//   its scale is one load per row beside the codes (the same address for
//   the lanes of a block). A code becomes a float by a byte permute and one
//   add (exact), not I2F, which issues 16 a clock on an SM against 128
//   float32 operations; the inner loop is four instructions a code
//   (permute, add, scale, weight). The int8 payload only runs at
//   MT = 1. A lane loading 4 codes a row (128 columns a block, the float
//   tile's width) took twice as long on the H100: its blocks move a
//   quarter of the bytes for the same fixed cost (PERF.md).
// - Shared memory holds the weights (transposed, so a row's MT weights are one
//   or two vector loads), the denominators and the warps' partial sums (4-16
//   KB, 32 KB at MT = 8). The partials are added in warp order
//   (deterministic) and divided by one pass of the whole block, with
//   coalesced 4-byte stores. Past 48 KB the launcher lifts the block's limit
//   and checks that it took.
// - Tensor cores are not used: they would buy nothing on a bytes-bound
//   product, and TF32 keeps about 10 mantissa bits, which misses the 1e-5 bar
//   against the float32 reference.
// - Plain unrolled vector loads, no TMA ring: the largest CNN leaf already
//   streams at about 76% of the card's 3.35 TB/s at the paths' shapes
//   (PERF.md).
// - A ragged D (not a multiple of V), an int8 block that is not a multiple of
//   V, or an unaligned payload takes a masked scalar path (lane l reads
//   columns l, l + 32, ... of the tile; an int8 column reads its own scale),
//   so no padding to the TPU's 2048-lane tiles is needed. Each block picks
//   its path once; the scalar one is a call, so that the vector path keeps
//   its registers to itself (inlined beside the scalar one, the int8 vector
//   path spilled).
// - Element offsets are 64-bit, tile numbers 32-bit. A column's scale index
//   is a 32-bit division where the column fits (a 64-bit one is a
//   subroutine call).
// - No --use_fast_math: the division is IEEE division, as in the reference.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxLeaves = 32;  // leaves per launch (the table's size)
constexpr int kLanes = 32;
constexpr int kWarps = 8;       // warps per block, splitting the rows
constexpr int kRows = 4;        // rows a warp has in flight
constexpr int kMaxMT = 8;       // model rows per pass over X

// Passed by value: lives in the kernel's parameter space.
struct LeafTable {
  const void* x[kMaxLeaves];   // (B, d) payloads
  const float* s[kMaxLeaves];  // int8: (B, d / block) scales
  float* out[kMaxLeaves];      // (M, d) results
  long long d[kMaxLeaves];
  int tile0[kMaxLeaves + 1];   // first tile of each leaf; tile0[n] = grid
  int n;
  int block;                   // int8: columns a scale covers
};

// A lane's columns of its block's tile: V neighbours read as one vector
// (kV), else V columns a warp's width apart, read one by one and masked.
template <bool kV>
struct Cols {
  static constexpr bool vec = kV;
  static constexpr int step = kV ? 1 : kLanes;  // between the lane's columns
  long long D;                                  // the leaf's row length
  long long col;                                // the lane's first column
  __device__ bool live(int c) const { return col + c * step < D; }
};

// float32 rows: a lane's 4 columns, one float4 where the leaf allows.
struct F32Payload {
  static constexpr int kVec = 4;
  struct Row {
    float v[kVec];
  };
  const float* x;

  __device__ static bool vec_ok(const LeafTable& t, int i) {
    return t.d[i] % kVec == 0 &&
           reinterpret_cast<uintptr_t>(t.x[i]) % 16 == 0;
  }
  template <class K>
  __device__ F32Payload(const LeafTable& t, int i, const K&)
      : x(static_cast<const float*>(t.x[i])) {}

  // row b of the lane's columns; zeros where !live or past D
  template <class K>
  __device__ void load(const K& k, int b, bool live, Row& r) const {
    const float* row = x + static_cast<long long>(b) * k.D + k.col;
    if constexpr (K::vec) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && k.col < k.D) v = __ldg(reinterpret_cast<const float4*>(row));
      r.v[0] = v.x;
      r.v[1] = v.y;
      r.v[2] = v.z;
      r.v[3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        r.v[c] = live && k.live(c) ? __ldg(row + c * K::step) : 0.f;
    }
  }
  template <class K>
  __device__ float value(const K&, const Row& r, int, int c) const {
    return r.v[c];
  }
};

// col / block, without the subroutine call of a 64-bit division where col
// fits in 32 bits
__device__ __forceinline__ long long div_block(long long col, int block) {
  return col <= INT_MAX ? static_cast<int>(col) / block : col / block;
}

// float(c) for the signed byte c at byte j of w: the float 2^23 + (c ^ 0x80)
// put together from its bits, less 2^23 + 128; exact. One byte permute and
// one add, where I2F issues at an eighth of the float32 rate.
__device__ __forceinline__ float code_at(unsigned w, int j) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                     0x7540u | j)) -
         8388736.f;
}

// int8 rows with float32 block scales: a lane's 16 codes, one 16-byte load
// where the leaf allows, dequantized as they are consumed.
struct I8Payload {
  static constexpr int kVec = 16;
  struct Row {
    unsigned w[kVec / 4];  // the codes, four to a word
    float s;               // vector path: the scale of all 16 columns
  };
  const int8_t* q;
  const float* s;  // the leaf's scales, from the lane's first column's on
  long long nb;    // scales a row
  int block;
  int rem;         // the lane's first column within its scale block

  __device__ static bool vec_ok(const LeafTable& t, int i) {
    return t.d[i] % kVec == 0 && t.block % kVec == 0 &&
           reinterpret_cast<uintptr_t>(t.x[i]) % 16 == 0;
  }
  template <class K>
  __device__ I8Payload(const LeafTable& t, int i, const K& k)
      : q(static_cast<const int8_t*>(t.x[i])),
        nb(t.d[i] / t.block),
        block(t.block) {
    const bool in = k.col < k.D;
    const long long first = in ? div_block(k.col, block) : 0;
    s = t.s[i] + first;
    rem = in ? static_cast<int>(k.col - first * block) : 0;
  }

  template <class K>
  __device__ void load(const K& k, int b, bool live, Row& r) const {
    const int8_t* row = q + static_cast<long long>(b) * k.D + k.col;
    if constexpr (K::vec) {
      const bool on = live && k.col < k.D;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (on) x = __ldg(reinterpret_cast<const uint4*>(row));
      r.w[0] = x.x;
      r.w[1] = x.y;
      r.w[2] = x.z;
      r.w[3] = x.w;
      r.s = on ? __ldg(s + static_cast<long long>(b) * nb) : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j) r.w[j] = 0u;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const unsigned code =
            live && k.live(c) ? static_cast<uint8_t>(__ldg(row + c * K::step))
                              : 0u;
        r.w[c / 4] |= code << (8 * (c % 4));
      }
    }
  }
  // column c of the row: its code times its scale (scalar path: the
  // column's own scale, read here; zero past D)
  template <class K>
  __device__ float value(const K& k, const Row& r, int b, int c) const {
    const float code = code_at(r.w[c / 4], c % 4);
    if constexpr (K::vec) {
      return code * r.s;
    } else {
      return code * (k.live(c) ? __ldg(s + static_cast<long long>(b) * nb +
                                       (rem + c * K::step) / block)
                               : 0.f);
    }
  }
};

// The weights are staged transposed, (B, Mp) with Mp = M rounded up to MT
// and zero-filled, so that a row's MT weights are one or two vector loads.
__host__ __device__ inline int padded_rows(int M, int MT) {
  return (M + MT - 1) / MT * MT;
}

template <class P>
__host__ __device__ constexpr int tile_cols() {
  return kLanes * P::kVec;
}

template <int MT, class P>
size_t eq1_smem(int B, int M) {
  return (static_cast<size_t>(kWarps) * MT * tile_cols<P>() +
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

// One block's tile of leaf i: its lanes read their columns as vectors
// (kV) or one by one.
template <int MT, class P, bool kV>
__device__ __forceinline__ void eq1_tile(const LeafTable& t, int i, int tile,
                                         const float* __restrict__ w,
                                         const float* __restrict__ denoms,
                                         int B, int M) {
  constexpr int kVec = P::kVec;
  constexpr int kTile = tile_cols<P>();
  using Row = typename P::Row;
  const int Mp = padded_rows(M, MT);
  extern __shared__ float smem[];
  float* sred = smem;                      // (kWarps, MT, kTile) partials
  float* sw = smem + kWarps * MT * kTile;  // (B, Mp) weights, transposed
  float* sden = sw + B * Mp;               // (M,) denominators

  float* __restrict__ out = t.out[i];
  const long long D = t.d[i];
  const long long col0 = static_cast<long long>(tile - t.tile0[i]) * kTile;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  // this lane's columns: neighbours (one vector) or a stride of 32
  const int first = kV ? kVec * lane : lane;
  const Cols<kV> k{D, col0 + first};
  const P p(t, i, k);

  // rows b0, b0 + kWarps, ... of this lane's columns; zeros past B and D
  auto load_rows = [&](Row (&v)[kRows], int b0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r * kWarps;
      p.load(k, b < B ? b : 0, b < B, v[r]);
    }
  };

  // the first rows go out before the weights are staged: the block's first
  // HBM round trip overlaps the weights' L2 one
  Row v[kRows];
  load_rows(v, warp);
  for (int j = threadIdx.x; j < B * Mp; j += blockDim.x) {
    const int b = j / Mp, m = j % Mp;
    sw[j] = m < M ? w[m * B + b] : 0.f;
  }
  for (int j = threadIdx.x; j < M; j += blockDim.x) sden[j] = denoms[j];
  __syncthreads();

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mc = M - m0 < MT ? M - m0 : MT;
    float acc[MT][kVec];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[j][c] = 0.f;

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
            for (int c = 0; c < kVec; ++c)
              acc[j][c] = fmaf(wv[j], p.value(k, v[r], b, c), acc[j][c]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < mc) {
        float* ps = sred + (warp * MT + j) * kTile;
        if constexpr (kV) {
#pragma unroll
          for (int q = 0; q < kVec / 4; ++q)
            *reinterpret_cast<float4*>(ps + first + 4 * q) =
                make_float4(acc[j][4 * q], acc[j][4 * q + 1],
                            acc[j][4 * q + 2], acc[j][4 * q + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < kVec; ++c) ps[first + c * kLanes] = acc[j][c];
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
        for (int q = 1; q < kWarps; ++q) s += sred[(q * MT + j) * kTile + c];
        out[static_cast<long long>(m0 + j) * D + col0 + c] = s / sden[m0 + j];
      }
    }
    __syncthreads();  // the next pass reuses the partials
  }
}

// The scalar path, out of line: inlined beside the vector path it would
// share its register allocation, and the int8 vector path would spill.
template <int MT, class P>
__device__ __noinline__ void eq1_tile_scalar(const LeafTable& t, int i,
                                             int tile, const float* w,
                                             const float* denoms, int B,
                                             int M) {
  eq1_tile<MT, P, false>(t, i, tile, w, denoms, B, M);
}

// At most 64 registers a thread, so that four blocks fit on an SM.
template <int MT, class P>
__global__ void __launch_bounds__(kWarps * kLanes, 4)
    eq1_agg_kernel(const __grid_constant__ LeafTable t,
                   const float* __restrict__ w,
                   const float* __restrict__ denoms, int B, int M) {
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
  if (P::vec_ok(t, lo)) {
    eq1_tile<MT, P, true>(t, lo, tile, w, denoms, B, M);
  } else {
    eq1_tile_scalar<MT, P>(t, lo, tile, w, denoms, B, M);
  }
}

template <int MT, class P>
int launch_eq1(const LeafTable& t, const float* w, const float* denoms, int B,
               int M, cudaStream_t s) {
  const size_t smem = eq1_smem<MT, P>(B, M);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        eq1_agg_kernel<MT, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>(t.tile0[t.n]);
  eq1_agg_kernel<MT, P><<<blocks, kWarps * kLanes, smem, s>>>(t, w, denoms,
                                                              B, M);
  return static_cast<int>(cudaGetLastError());
}

// Fills t with n leaves cut into tiles of `tile` columns. False on bad
// arguments: n out of range, a leaf of no columns, one not a multiple of
// `block`, or more tiles than an int holds.
template <class T>
bool fill_table(LeafTable& t, const T* const* x, const float* const* s,
                float* const* out, const long long* d, int n, int tile,
                int block) {
  if (n < 1 || n > kMaxLeaves || block < 1) return false;
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (d[i] < 1 || d[i] % block) return false;
    t.x[i] = x[i];
    t.s[i] = s ? s[i] : nullptr;
    t.out[i] = out[i];
    t.d[i] = d[i];
    t.tile0[i] = static_cast<int>(tiles);
    tiles += (d[i] + tile - 1) / tile;
    if (tiles > INT_MAX) return false;
  }
  t.tile0[n] = static_cast<int>(tiles);
  t.n = n;
  t.block = block;
  return true;
}

}  // namespace

// The most leaves one launch takes (the leaf table's size).
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
  LeafTable t = {};
  if (B < 0 || M < 1 ||
      !fill_table(t, u, nullptr, out, d, n, tile_cols<F32Payload>(), 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch_eq1<1, F32Payload>(t, w, denoms, B, M, s);
  if (M <= 2) return launch_eq1<2, F32Payload>(t, w, denoms, B, M, s);
  if (M <= 4) return launch_eq1<4, F32Payload>(t, w, denoms, B, M, s);
  return launch_eq1<kMaxMT, F32Payload>(t, w, denoms, B, M, s);
}

// Eq 1 over the dequantized rows of n int8 leaves in one launch on
// `stream`: out[i] (d[i],) = sum_n w[n] * (q[i][n, :] * s[i][n, : / block])
// / denom, q[i] (N, d[i]) int8 and s[i] (N, d[i] / block) float32. q, s, out
// and d are host arrays of n entries, 1 <= n <= fedcd_eq1_max_leaves(), each
// d[i] >= 1 a multiple of block; w (N,) and the 0-d denom are device
// pointers. Returns a CUDA error code as an int, as fedcd_eq1_agg does.
extern "C" int fedcd_dequant_agg_group(const int8_t* const* q,
                                       const float* const* s,
                                       float* const* out, const long long* d,
                                       int n, const float* w,
                                       const float* denom, int N, int block,
                                       void* stream) {
  LeafTable t = {};
  if (N < 0 ||
      !fill_table(t, q, s, out, d, n, tile_cols<I8Payload>(), block))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_eq1<1, I8Payload>(t, w, denom, N, 1,
                                   static_cast<cudaStream_t>(stream));
}
