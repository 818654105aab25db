// Blockwise symmetric int8/int4 transport quantization (paper §3.4) for
// Hopper (sm_90a).
//
// quantize_kernel replaces src/repro/kernels/quantize/kernel.py::quantize_2d
// and dequantize_kernel replaces ::dequantize_2d (the Pallas TPU kernels).
// For each block of 128 values along a row of a leaf x (R, n):
//   s = max(max|x| / qmax, 1e-12),  q = clip(round_half_even(x / s), +-qmax)
// q is int8 (R, n_pad) with n_pad = 128 * ceil(n / 128) and the ragged tail
// of each row quantized as zeros, as the reference pads; scales are float32
// (R, n_pad / 128). dequantize computes x = q * s[block] into (R, n). Rows
// are independent: a stacked (A, n) leaf view is A payloads, the same blocks
// as the reference's per-row quantize_leaf.
//
// Bytes bound both. quantize reads 4 bytes and writes 1 byte per value plus
// 4 bytes per 128 values; dequantize the reverse. The few flops per value
// are nothing beside that. What held the per-leaf kernels back was the
// calls, not their bodies: a param dict's 20 leaves, 13 of them under 10k
// values, took 20 launches of each kernel. So:
// - One launch per call, over every leaf of it. The leaf table (pointers,
//   lengths, a float4 flag per leaf, each leaf's first work item) is a kernel
//   parameter passed by value (__grid_constant__, at most kMaxLeaves leaves,
//   under 2 KB), so no pointer table is copied from the host and the table
//   indexed at run time stays in the parameter space instead of local
//   memory; the wrapper splits larger groups into more launches. Each warp
//   (quantize) or block (dequantize) finds its leaf by a binary search over
//   the first items, at most five steps.
// - quantize: one warp owns kBlocksPerWarp = 4 consecutive 128-value blocks
//   of a leaf. Each lane loads four values of each block (one 16-byte load
//   where the leaf allows it), all four loads before the first reduction;
//   each block's maximum is a five-step __shfl_xor_sync reduction in
//   registers, and each lane stores its four codes as one 4-byte char4.
// - dequantize: a block of 256 threads owns kVecsPerThread * 1024 = 4096
//   values of one row; each thread loads four codes at a time as one char4
//   (four values never straddle a 128-block), all its loads before the
//   first store, and stores them as one float4 where the leaf's rows are
//   16-byte aligned.
// - Four blocks a warp and four groups a thread, not one: with one, the
//   CNN's call at 2 model rows (2.9M values) runs in about three waves of
//   one memory round trip each; with four, the loads of the whole call are
//   in flight at once. On the H100 the 20-leaf call took 0.0427 / 0.0420 ms
//   back to back at 16 rows against 0.0487 / 0.0431 with one (PERF.md).
// - The float4 paths are chosen per leaf: a leaf whose row length is not a
//   multiple of 4 (a 10-value bias) or whose data is not 16-byte aligned
//   takes the scalar path alone, the other leaves of the call do not.
// - 32-bit index math where every offset of a launch fits (all of the
//   CNN's), the 64-bit instantiation otherwise. On the H100 the 64-bit one
//   took 9-18% longer for the CNN's quantize call and 2-28% for its
//   dequantize call; one layout with 32-bit work-item numbers and 64-bit
//   element offsets matched the 32-bit quantize but not the dequantize
//   (PERF.md).
//
// Numerics match the reference exactly: IEEE division x / s (this file is
// built without --use_fast_math) and rintf, which rounds half to even as
// jnp.round does (roundf would round half away from zero).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxLeaves = 32;  // leaves per launch (the tables' size)
constexpr int kBlock = 128;     // values per scale: one warp, four per lane
constexpr int kThreads = 256;   // threads per block
constexpr int kBlocksPerWarp = 4;     // quantize: 128-blocks per warp
constexpr int kVecsPerThread = 4;     // dequantize: 4-value groups a thread
constexpr int kChunk = 4 * kThreads * kVecsPerThread;  // values per block

template <typename Index>
struct QuantizeTable {  // passed by value: the kernel's parameter space
  const float* x[kMaxLeaves];     // (R, n) values
  int8_t* q[kMaxLeaves];          // (R, n_pad) codes
  float* s[kMaxLeaves];           // (R, n_pad / 128) scales
  Index n[kMaxLeaves];            // row length
  Index nb[kMaxLeaves];           // 128-blocks per row
  Index blocks[kMaxLeaves];       // 128-blocks of the leaf, R * nb
  Index warp0[kMaxLeaves + 1];    // first warp of each leaf; warp0[count]
  unsigned vec;                   // bit i: leaf i takes 16-byte loads
  int count;
};

template <typename Index>
struct DequantizeTable {
  const int8_t* q[kMaxLeaves];    // (R, n_pad) codes
  const float* s[kMaxLeaves];     // (R, n_pad / 128) scales
  float* out[kMaxLeaves];         // (R, n) values
  Index n[kMaxLeaves];            // row length
  Index chunks[kMaxLeaves];       // blocks per row, ceil(n / kChunk)
  Index cta0[kMaxLeaves + 1];     // first block of each leaf; cta0[count]
  unsigned vec;                   // bit i: leaf i takes 16-byte stores
  int count;
};

// The leaf of work item `item`: the last whose first item is <= item.
template <typename Index>
__device__ __forceinline__ int find_leaf(const Index* first, int count,
                                         Index item) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= item) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const __grid_constant__ QuantizeTable<Index> t,
                    float qmax) {
  const Index warp =
      (static_cast<Index>(blockIdx.x) * kThreads +
       static_cast<Index>(threadIdx.x)) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= t.warp0[t.count]) return;  // whole warps leave together
  const int leaf = find_leaf(t.warp0, t.count, warp);
  const Index n = t.n[leaf];
  const Index nb = t.nb[leaf];
  const Index blocks = t.blocks[leaf];
  const bool vec = t.vec >> leaf & 1u;
  // this warp's blocks of the leaf, row-major: b0, b0 + 1, ...
  const Index b0 = (warp - t.warp0[leaf]) * kBlocksPerWarp;

  // every load of the warp goes out before the first reduction
  float v[kBlocksPerWarp][4];
#pragma unroll
  for (int j = 0; j < kBlocksPerWarp; ++j) {
    const Index b = b0 + j;
    const Index r = b / nb;
    const Index c0 = (b - r * nb) * kBlock + lane * 4;
    const float* p = t.x[leaf] + r * n + c0;
    if (b < blocks && vec && c0 + 4 <= n) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      v[j][0] = x.x;
      v[j][1] = x.y;
      v[j][2] = x.z;
      v[j][3] = x.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[j][c] = b < blocks && c0 + c < n ? __ldg(p + c) : 0.f;
    }
  }

#pragma unroll
  for (int j = 0; j < kBlocksPerWarp; ++j) {
    const Index b = b0 + j;
    if (b >= blocks) break;  // the same for the whole warp
    float amax = fmaxf(fmaxf(fabsf(v[j][0]), fabsf(v[j][1])),
                       fmaxf(fabsf(v[j][2]), fabsf(v[j][3])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = fmaxf(amax / qmax, 1e-12f);

    signed char code[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      code[c] = static_cast<signed char>(
          fminf(fmaxf(rintf(v[j][c] / s), -qmax), qmax));
    // block b: codes at b * 128 (rows are n_pad long), its scale at b
    *reinterpret_cast<char4*>(t.q[leaf] + b * kBlock + lane * 4) =
        make_char4(code[0], code[1], code[2], code[3]);
    if (lane == 0) t.s[leaf][b] = s;
  }
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const __grid_constant__ DequantizeTable<Index> t) {
  const Index cta = static_cast<Index>(blockIdx.x);
  const int leaf = find_leaf(t.cta0, t.count, cta);
  const Index n = t.n[leaf];
  const Index n_pad = (n + kBlock - 1) / kBlock * kBlock;
  const Index local = cta - t.cta0[leaf];
  const Index r = local / t.chunks[leaf];
  const Index first = (local - r * t.chunks[leaf]) * kChunk +
                      static_cast<Index>(threadIdx.x) * 4;
  const bool vec = t.vec >> leaf & 1u;

  // every load of the thread goes out before the first store; the
  // thread's groups are kThreads * 4 values apart, so each load and
  // store of the block is coalesced
  char4 c4[kVecsPerThread];
  float s[kVecsPerThread];
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    const Index c0 = first + j * kThreads * 4;
    const Index k = r * n_pad + c0;  // its first code; k % 4 == 0
    if (c0 < n) {
      c4[j] = *reinterpret_cast<const char4*>(t.q[leaf] + k);
      s[j] = t.s[leaf][k / kBlock];  // four values never straddle a block
    }
  }
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    const Index c0 = first + j * kThreads * 4;
    if (c0 >= n) break;
    const float v[4] = {static_cast<float>(c4[j].x) * s[j],
                        static_cast<float>(c4[j].y) * s[j],
                        static_cast<float>(c4[j].z) * s[j],
                        static_cast<float>(c4[j].w) * s[j]};
    float* o = t.out[leaf] + r * n + c0;
    if (vec && c0 + 4 <= n) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int c = 0; c < 4 && c0 + c < n; ++c) o[c] = v[c];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Fills a table's per-leaf fields and the prefix of work items: `per_row`
// units per row of each leaf, `per_item` units to an item. Returns the
// total of items, or -1 for bad arguments.
template <typename Table, typename Index>
long long fill(Table& t, Index* first, Index* per_row_out,
               const long long* rows, const long long* n, int count,
               long long (*per_row)(long long), long long per_item) {
  long long items = 0;
  for (int i = 0; i < count; ++i) {
    if (rows[i] < 1 || n[i] < 1) return -1;
    t.n[i] = static_cast<Index>(n[i]);
    per_row_out[i] = static_cast<Index>(per_row(n[i]));
    first[i] = static_cast<Index>(items);
    items += (rows[i] * per_row(n[i]) + per_item - 1) / per_item;
  }
  first[count] = static_cast<Index>(items);
  t.count = count;
  return items;
}

long long blocks_per_row(long long n) { return (n + kBlock - 1) / kBlock; }
long long chunks_per_row(long long n) { return (n + kChunk - 1) / kChunk; }

// Whether a launch fits 32-bit index math: every element offset of every
// leaf (with a block's overhang past a row's end), and the grid's thread
// count, `threads` for each of a row's `per_row` units.
bool fits_int(const long long* rows, const long long* n, int count,
              long long (*per_row)(long long), long long threads) {
  long long total = 0;
  for (int i = 0; i < count; ++i) {
    if (rows[i] * blocks_per_row(n[i]) * kBlock + kChunk > INT_MAX)
      return false;
    total += rows[i] * per_row(n[i]) * threads;
  }
  return total <= INT_MAX;
}

template <typename Index>
int launch_quantize(const float* const* x, int8_t* const* q,
                    float* const* s, const long long* rows,
                    const long long* n, int count, float qmax,
                    cudaStream_t stream) {
  QuantizeTable<Index> t = {};
  const long long warps =
      fill(t, t.warp0, t.nb, rows, n, count, blocks_per_row,
           kBlocksPerWarp);
  if (warps < 0 || (warps * 32 + kThreads - 1) / kThreads > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i) {
    t.x[i] = x[i];
    t.q[i] = q[i];
    t.s[i] = s[i];
    t.blocks[i] = static_cast<Index>(rows[i] * t.nb[i]);
    if (n[i] % 4 == 0 && aligned16(x[i])) t.vec |= 1u << i;
  }
  const unsigned blocks =
      static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  quantize_kernel<Index><<<blocks, kThreads, 0, stream>>>(t, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename Index>
int launch_dequantize(const int8_t* const* q, const float* const* s,
                      float* const* out, const long long* rows,
                      const long long* n, int count, cudaStream_t stream) {
  DequantizeTable<Index> t = {};
  const long long ctas =
      fill(t, t.cta0, t.chunks, rows, n, count, chunks_per_row, 1);
  if (ctas < 0 || ctas > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i) {
    t.q[i] = q[i];
    t.s[i] = s[i];
    t.out[i] = out[i];
    if (n[i] % 4 == 0 && aligned16(out[i])) t.vec |= 1u << i;
  }
  dequantize_kernel<Index><<<static_cast<unsigned>(ctas), kThreads, 0,
                             stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most leaves one fedcd_quantize_group or fedcd_dequantize_group call
// takes (one launch each call).
extern "C" int fedcd_quantize_max_leaves() { return kMaxLeaves; }

// Quantize `count` leaves in one launch on `stream`: leaf i is x[i]
// (rows[i], n[i]) float32 into codes q[i] (rows[i], n_pad) and scales s[i]
// (rows[i], n_pad / 128). x, q, s, rows and n are host arrays of `count`
// entries, 1 <= count <= fedcd_quantize_max_leaves(), every rows[i] and
// n[i] >= 1; each q[i] must be 4-byte aligned. Returns a CUDA error code as
// an int (0 = ok): cudaErrorInvalidValue for bad arguments, else
// cudaGetLastError().
extern "C" int fedcd_quantize_group(const float* const* x, int8_t* const* q,
                                    float* const* s, const long long* rows,
                                    const long long* n, int count, float qmax,
                                    void* stream) {
  if (count < 1 || count > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fits_int(rows, n, count, blocks_per_row, 32))
    return launch_quantize<int>(x, q, s, rows, n, count, qmax, st);
  return launch_quantize<long long>(x, q, s, rows, n, count, qmax, st);
}

// Dequantize `count` leaves in one launch on `stream`: out[i] (rows[i],
// n[i]) = q[i] * s[i][block], with q[i] (rows[i], n_pad) int8 and s[i]
// (rows[i], n_pad / 128) float32; the same host arrays and limits as
// fedcd_quantize_group, each q[i] 4-byte aligned.
extern "C" int fedcd_dequantize_group(const int8_t* const* q,
                                      const float* const* s,
                                      float* const* out,
                                      const long long* rows,
                                      const long long* n, int count,
                                      void* stream) {
  if (count < 1 || count > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fits_int(rows, n, count, chunks_per_row, kThreads))
    return launch_dequantize<int>(q, s, out, rows, n, count, st);
  return launch_dequantize<long long>(q, s, out, rows, n, count, st);
}
