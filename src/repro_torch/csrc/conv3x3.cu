// The paper's CNN's 3x3 convolutions (stride 1, pad 1) for Hopper
// (sm_90a): forward with bias and ReLU, dgrad and wgrad, as one implicit-GEMM
// design on NHWC activations and HWIO kernels, grouped over a leading axis G
// (each group with its own weights: the (model, device) pairs of a training
// step). It replaces no TPU kernel: the JAX package leaves its convolutions
// to XLA. On the card it replaces cuDNN's grouped float32 convolutions, which
// transpose both operands to NCHW / OIHW on every call and run SIMT kernels
// far below the float32 peak.
//
// The three products, per group g (M, N, K of the GEMM):
// - forward: y = relu(A . B + b), A = im2col(x) (M = images*H*W rows, K =
//   9*Cin: (kh, kw, cin), contiguous in NHWC), B = w as (9*Cin, Cout), the
//   HWIO bank as it is. The bias and the ReLU are the epilogue.
// - dgrad: dx = im2col(dy*(y > 0)) . B', K = 9*Cout, B'[(kh', kw', co), ci] =
//   w[2-kh', 2-kw', ci, co]: the flipped, transposed kernel, read in place.
//   The ReLU mask is applied as dy is loaded; the masked dy is never written.
// - wgrad: [dw; db] = im2col(x)^T . (dy*(y > 0)), M = 9*Cin + 1 rows (the
//   last row of im2col(x)^T is all ones, so db is one more row of the same
//   product), N = Cout, K = images*H*W pixels, written straight into HWIO.
//   The pixel sum is cut into `splits` slices of `kslice` pixels (to fill
//   the card where M x N is small, and to keep each float32 running sum
//   short); a second pass adds the slices in order. No atomics: every sum
//   runs in a fixed order, so two calls give the same bits.
//
// What bounds it: FLOPs. At the pair step's shapes (32 images, Cin / Cout
// 32-256) every layer does 2*K = 54-4,608 operations per output value over
// inputs of a few MB, far above the float32 ridge of ~20 FLOP/byte, so the
// bound is 2*M*N*K / 67 TFLOP/s (the float32 peak outside the tensor cores).
// There are no tensor cores here: the configuration's numbers are IEEE
// float32, and TF32 (or its 3xTF32 emulation) is another arithmetic. So this
// is a SIMT FFMA kernel, built for FFMA issue:
// - A block computes a BM x BN tile of one group (grid: m tiles, n tiles,
//   groups x splits). The wrapper picks the tile from the product's shape
//   (ops.py's tile_for): 128 x 128, 128 x 64 or 128 x 32 by N (32 for the
//   first layers' Cout, 256 for the last ones'), and 32 x 32 for the first
//   layer's wgrad (28 x 32). Each thread holds an 8 x TN register tile (TN =
//   8, or 4 in the 32-wide tiles): per depth step it loads 8 + TN values
//   from shared memory and issues 8*TN FFMAs. A warp covers 4 x 8 threads,
//   so its shared loads are broadcasts of 64 and 128 contiguous bytes (one
//   wavefront each); each thread's rows and columns are two groups of 4,
//   half a tile apart.
// - Block tiles are BK = 8 deep (16 in the 128 x 32 tile, whose 128
//   threads would otherwise wait at a barrier every 32 FFMAs), double-
//   buffered in shared memory (one barrier per tile). The next tile's global
//   loads are issued into registers before the current tile's FFMAs and
//   stored to shared memory after them, so the loads' latency hides behind
//   the FFMAs. Registers, not cp.async: every operand is either masked (dy
//   by y > 0), gathered with a zero pad, or stored transposed (A as
//   [k][m]), and cp.async can do none of those in the copy. Each loader
//   keeps a cursor on the depth, so a tile's (tap, channel) or (row,
//   column) follows from the last by additions, not divisions.
// - Loads are 16 bytes where the layout allows: four channels of one pixel
//   and tap (Cin % 4 == 0; the 3-channel images take a scalar gather), four
//   output channels of a kernel row or of dy. The zero padding of the 3x3
//   window is a predicate on the load; no im2col buffer exists.
// - Offsets inside a group are 32-bit (the wrapper checks that a group's
//   activations fit), the group's base 64-bit.
// - No --use_fast_math, no TF32: fmaf on float32 operands only.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TM = 8;    // rows of a thread's register tile
constexpr int PAD = 4;   // floats after each shared row (conflict-free stores)

// A block tile of BM x BN outputs, TM x TN a thread. A warp covers WTY x WTX
// threads (4 x 8 in every tile used), so its shared loads are broadcasts of
// 64 and 128 contiguous bytes.
template <int BM_, int BN_, int TN_, int BK_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, TN = TN_;
  static constexpr int BK = BK_;      // depth of a block tile
  static constexpr int KQ = BK / 4;   // 4-deep quads of it
  static constexpr int TX = BN / TN, TY = BM / TM;
  static constexpr int T = TX * TY;
  static constexpr int WTX = TX < 8 ? TX : 8;
  static constexpr int WTY = 32 / WTX;
  static constexpr int WX = TX / WTX;  // warps across the tile's columns
  static_assert(T % 32 == 0 && TY % WTY == 0 && TN % 4 == 0 && BK % 4 == 0,
                "tile");
};

// One argument block for the three kernels (passed by value).
struct Args {
  const float* in0;
  const float* in1;
  const float* in2;
  float* out0;
  float* out1;
  float* out2;
  int G, N, H, W, Cin, Cout;
  int kslice;  // wgrad: pixels per split
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// dy where y > 0, else 0 (torch's threshold_backward: a NaN y gives 0)
__device__ __forceinline__ float4 relu_mask(float4 v, float4 y) {
  return make_float4(y.x > 0.f ? v.x : 0.f, y.y > 0.f ? v.y : 0.f,
                     y.z > 0.f ? v.z : 0.f, y.w > 0.f ? v.w : 0.f);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ void store_col4(float* p, int stride, float4 v) {
  p[0] = v.x;
  p[stride] = v.y;
  p[2 * stride] = v.z;
  p[3 * stride] = v.w;
}

// The loaders below keep a cursor on the depth: each fetch reads the tile
// at the cursor and moves it BK on, so the (tap, channel) or (row, column)
// of a depth follows by additions, with one division at the start.

// A = im2col(src) as (M pixels, K = 9*C), loaded 4 depths (channels) at a
// time and stored transposed as As[k][m]; kMask multiplies by (msk > 0).
// Slot s of the tile: row s / 2, depths (s % 2) * 4 .. + 3 (T is even, so
// every slot of a thread reads the same depths).
template <class C, bool kMask, bool kVec>
struct Im2colK {
  static constexpr int R = C::BM * C::BK / 4 / C::T;
  const float* src;
  const float* msk;
  int Ch, H, W, M;
  int m[R], oh[R], ow[R];
  int k, tap, c;  // the cursor: depth k = (tap, c)

  __device__ Im2colK(const float* s, const float* mk, int ch, int h, int w,
                     int rows, int m0, int k0, unsigned tid)
      : src(s), msk(mk), Ch(ch), H(h), W(w), M(rows) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = m0 + (tid + r * C::T) / C::KQ;
      ow[r] = m[r] % W;
      oh[r] = (m[r] / W) % H;
    }
    k = k0 + (tid % C::KQ) * 4;
    tap = k / Ch;
    c = k - tap * Ch;
  }

  __device__ float one(int r, int kk, int kend) const {
    if (m[r] >= M || kk >= kend) return 0.f;
    const int t = kk / Ch, ch = kk - t * Ch;
    const int kh = t / 3, kw = t - 3 * kh;
    const int ih = oh[r] + kh - 1, iw = ow[r] + kw - 1;
    if (static_cast<unsigned>(ih) >= static_cast<unsigned>(H) ||
        static_cast<unsigned>(iw) >= static_cast<unsigned>(W))
      return 0.f;
    const int off = (m[r] + (kh - 1) * W + (kw - 1)) * Ch + ch;
    const float v = __ldg(src + off);
    if constexpr (kMask) return __ldg(msk + off) > 0.f ? v : 0.f;
    return v;
  }

  __device__ void fetch(int kend, float4 (&v)[R]) {
    if constexpr (kVec) {
      // Ch % 4 == 0: the 4 depths are 4 channels of one tap
      const int kh = tap / 3, kw = tap - 3 * kh;
      const int base = ((kh - 1) * W + (kw - 1)) * Ch + c;
      const bool live = k < kend;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ih = oh[r] + kh - 1, iw = ow[r] + kw - 1;
        v[r] = zero4();
        if (live && m[r] < M &&
            static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
            static_cast<unsigned>(iw) < static_cast<unsigned>(W)) {
          const int off = m[r] * Ch + base;
          v[r] = ldg4(src + off);
          if constexpr (kMask) v[r] = relu_mask(v[r], ldg4(msk + off));
        }
      }
      c += C::BK;
      while (c >= Ch) {
        c -= Ch;
        ++tap;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = make_float4(one(r, k, kend), one(r, k + 1, kend),
                           one(r, k + 2, kend), one(r, k + 3, kend));
    }
    k += C::BK;
  }

  __device__ void store(float* as, unsigned tid, const float4 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned s = tid + r * C::T;
      store_col4(as + (s % C::KQ) * 4 * (C::BM + PAD) + s / C::KQ,
                 C::BM + PAD, v[r]);
    }
  }
};

// A' = im2col(x)^T as (M' = 9*C + 1, K = pixels): row (kh, kw, c) of pixel
// p is x at p shifted by (kh - 1, kw - 1), channel c; row 9*C is all ones
// (the bias gradient's row). Loaded 4 rows at a time, stored as As[k][m].
// Slot s: depth s / Q, rows (s % Q) * 4 .. + 3, Q = BM / 4 (T is a multiple
// of Q, so every slot of a thread reads the same rows).
template <class C, bool kVec>
struct Im2colM {
  static constexpr int R = C::BM * C::BK / 4 / C::T;
  static constexpr int Q = C::BM / 4;
  static_assert(C::T % Q == 0, "slots");
  const float* src;
  int Ch, H, W, Mw;
  int row;                  // the thread's first row
  int dh, dw, xoff;         // its tap's shift (kVec), and x's offset
  int p[R], oh[R], ow[R];   // each slot's pixel: the cursor

  __device__ Im2colM(const float* s, int ch, int h, int w, int m0, int k0,
                     unsigned tid)
      : src(s), Ch(ch), H(h), W(w), Mw(9 * ch) {
    row = m0 + (tid % Q) * 4;
    const int t = row / Ch, c = row - t * Ch;
    dh = t / 3 - 1;
    dw = t % 3 - 1;
    xoff = (dh * W + dw) * Ch + c;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = k0 + (tid + r * C::T) / Q;
      ow[r] = p[r] % W;
      oh[r] = (p[r] / W) % H;
    }
  }

  // row mm of pixel q (oy, ox): x's value, the ones row, or 0 past it
  __device__ float one(int mm, int q, int oy, int ox) const {
    if (mm >= Mw) return mm == Mw ? 1.f : 0.f;
    const int t = mm / Ch, c = mm - t * Ch;
    const int kh = t / 3, kw = t - 3 * kh;
    const int ih = oy + kh - 1, iw = ox + kw - 1;
    if (static_cast<unsigned>(ih) >= static_cast<unsigned>(H) ||
        static_cast<unsigned>(iw) >= static_cast<unsigned>(W))
      return 0.f;
    return __ldg(src + (q + (kh - 1) * W + (kw - 1)) * Ch + c);
  }

  __device__ void fetch(int kend, float4 (&v)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = zero4();
      if (p[r] < kend) {
        if constexpr (kVec) {
          // Ch % 4 == 0: 4 channels of one tap, or the ones row and past it
          if (row < Mw) {
            const int ih = oh[r] + dh, iw = ow[r] + dw;
            if (static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
                static_cast<unsigned>(iw) < static_cast<unsigned>(W))
              v[r] = ldg4(src + p[r] * Ch + xoff);
          } else if (row == Mw) {
            v[r].x = 1.f;
          }
        } else {
          v[r] = make_float4(one(row, p[r], oh[r], ow[r]),
                             one(row + 1, p[r], oh[r], ow[r]),
                             one(row + 2, p[r], oh[r], ow[r]),
                             one(row + 3, p[r], oh[r], ow[r]));
        }
      }
      p[r] += C::BK;
      ow[r] += C::BK;
      while (ow[r] >= W) {
        ow[r] -= W;
        if (++oh[r] == H) oh[r] = 0;
      }
    }
  }

  __device__ void store(float* as, unsigned tid, const float4 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned s = tid + r * C::T;
      *reinterpret_cast<float4*>(as + (s / Q) * (C::BM + PAD) + (s % Q) * 4) =
          v[r];
    }
  }
};

// B = rows of a (K, N) row-major matrix (w as (9*Cin, Cout); dy as
// (pixels, Cout)), 4 columns at a time, stored as Bs[k][n]; kMask
// multiplies by (msk > 0). Slot s: depth s / (BN / 4), columns
// (s % (BN / 4)) * 4 .. + 3. N % 4 == 0.
template <class C, bool kMask>
struct RowsN {
  static constexpr int Q = C::BN / 4;
  static constexpr int S = C::BK * Q;
  static constexpr int R = (S + C::T - 1) / C::T;
  const float* src;
  const float* msk;
  int N, n0, k;  // the cursor: the tile's first depth

  __device__ RowsN(const float* s, const float* mk, int n, int col0, int k0)
      : src(s), msk(mk), N(n), n0(col0), k(k0) {}

  __device__ void fetch(int kend, unsigned tid, float4 (&v)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned s = tid + r * C::T;
      const int kk = k + s / Q, n = n0 + (s % Q) * 4;
      v[r] = zero4();
      if ((S % C::T == 0 || s < S) && kk < kend && n < N) {
        v[r] = ldg4(src + kk * N + n);
        if constexpr (kMask) v[r] = relu_mask(v[r], ldg4(msk + kk * N + n));
      }
    }
    k += C::BK;
  }

  __device__ void store(float* bs, unsigned tid, const float4 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned s = tid + r * C::T;
      if (S % C::T == 0 || s < S)
        *reinterpret_cast<float4*>(bs + (s / Q) * (C::BN + PAD) +
                                   (s % Q) * 4) = v[r];
    }
  }
};

// B' for dgrad: B'[(tap', co), ci] = w[8 - tap', ci, co] (tap = kh*3 + kw),
// read 4 output channels (depths) at a time along w's rows and stored
// transposed as Bs[k][n]. Slot s: column s / 2, depths (s % 2) * 4 .. + 3.
template <class C>
struct FlipW {
  static constexpr int S = C::BK * C::BN / 4;
  static constexpr int R = (S + C::T - 1) / C::T;
  const float* w;
  int Cin, Cout, n0;
  int k, tap, co;  // the cursor: depth k = (tap', co)

  __device__ FlipW(const float* wp, int cin, int cout, int col0, int k0,
                   unsigned tid)
      : w(wp), Cin(cin), Cout(cout), n0(col0) {
    k = k0 + (tid % C::KQ) * 4;
    tap = k / Cout;
    co = k - tap * Cout;
  }

  __device__ void fetch(int kend, unsigned tid, float4 (&v)[R]) {
    const float* wt = w + (8 - tap) * Cin * Cout + co;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned s = tid + r * C::T;
      const int n = n0 + s / C::KQ;
      v[r] = zero4();
      if ((S % C::T == 0 || s < S) && k < kend && n < Cin)
        v[r] = ldg4(wt + n * Cout);
    }
    k += C::BK;
    co += C::BK;
    while (co >= Cout) {
      co -= Cout;
      ++tap;
    }
  }

  __device__ void store(float* bs, unsigned tid, const float4 (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned s = tid + r * C::T;
      if (S % C::T == 0 || s < S)
        store_col4(bs + (s % C::KQ) * 4 * (C::BN + PAD) + s / C::KQ,
                   C::BN + PAD, v[r]);
    }
  }
};

// A thread's rows and columns of its block's tile: two groups of 4, half a
// tile apart (one group of columns at TN = 4).
template <class C>
__device__ __forceinline__ int row_of(int ty, int i) {
  return (i < 4 ? 0 : C::BM / 2) + ty * 4 + (i & 3);
}
template <class C>
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4 ? 0 : C::BN / 2) + tx * 4 + (j & 3);
}

// forward: y = relu(im2col(x) . w + b)
template <class Cf, bool kVec>
struct FwdOp {
  using C = Cf;
  using A = Im2colK<C, false, kVec>;
  using B = RowsN<C, false>;
  A a;
  B b;
  const float* bias;
  float* y;
  int M, N, kbeg, kend;

  __device__ FwdOp(const Args& p, int g, int, int m0, int n0, unsigned tid)
      : a(p.in0 + static_cast<long long>(g) * p.N * p.H * p.W * p.Cin,
          nullptr, p.Cin, p.H, p.W, p.N * p.H * p.W, m0, 0, tid),
        b(p.in1 + static_cast<long long>(g) * 9 * p.Cin * p.Cout, nullptr,
          p.Cout, n0, 0),
        bias(p.in2 + static_cast<long long>(g) * p.Cout),
        y(p.out0 + static_cast<long long>(g) * p.N * p.H * p.W * p.Cout),
        M(p.N * p.H * p.W), N(p.Cout), kbeg(0), kend(9 * p.Cin) {}

  __device__ void epilogue(const float (&acc)[TM][C::TN], int m0, int n0,
                           int ty, int tx) const {
    constexpr int TN = C::TN;
    float bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + col_of<C>(tx, j);
      bv[j] = n < N ? __ldg(bias + n) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + row_of<C>(ty, i);
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < TN; h += 4) {
        const int n = n0 + col_of<C>(tx, h);
        if (n >= N) continue;
        *reinterpret_cast<float4*>(y + m * N + n) = make_float4(
            relu(acc[i][h] + bv[h]), relu(acc[i][h + 1] + bv[h + 1]),
            relu(acc[i][h + 2] + bv[h + 2]), relu(acc[i][h + 3] + bv[h + 3]));
      }
    }
  }
};

// dgrad: dx = im2col(dy * (y > 0)) . flip(w)^T
template <class Cf, bool>
struct DgradOp {
  using C = Cf;
  using A = Im2colK<C, true, true>;
  using B = FlipW<C>;
  A a;
  B b;
  float* dx;
  int M, N, kbeg, kend;

  __device__ DgradOp(const Args& p, int g, int, int m0, int n0, unsigned tid)
      : a(p.in0 + static_cast<long long>(g) * p.N * p.H * p.W * p.Cout,
          p.in1 + static_cast<long long>(g) * p.N * p.H * p.W * p.Cout,
          p.Cout, p.H, p.W, p.N * p.H * p.W, m0, 0, tid),
        b(p.in2 + static_cast<long long>(g) * 9 * p.Cin * p.Cout, p.Cin,
          p.Cout, n0, 0, tid),
        dx(p.out0 + static_cast<long long>(g) * p.N * p.H * p.W * p.Cin),
        M(p.N * p.H * p.W), N(p.Cin), kbeg(0), kend(9 * p.Cout) {}

  __device__ void epilogue(const float (&acc)[TM][C::TN], int m0, int n0,
                           int ty, int tx) const {
    constexpr int TN = C::TN;
    const bool vec = N % 4 == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + row_of<C>(ty, i);
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < TN; h += 4) {
        const int n = n0 + col_of<C>(tx, h);
        if (vec) {
          if (n < N)
            *reinterpret_cast<float4*>(dx + m * N + n) = make_float4(
                acc[i][h], acc[i][h + 1], acc[i][h + 2], acc[i][h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) dx[m * N + n + j] = acc[i][h + j];
        }
      }
    }
  }
};

// wgrad: [dw; db] = im2col(x)^T . (dy * (y > 0)) over one slice of pixels;
// with one slice, written into dw (HWIO) and db, else into the slice's
// (9*Cin + 1, Cout) block of the scratch ws (splits, G, 9*Cin + 1, Cout).
template <class Cf, bool kVec>
struct WgradOp {
  using C = Cf;
  using A = Im2colM<C, kVec>;
  using B = RowsN<C, true>;
  A a;
  B b;
  float* dw;
  float* db;
  float* ws;  // nullptr with one slice
  int M, N, kbeg, kend;

  __device__ WgradOp(const Args& p, int g, int split, int m0, int n0,
                     unsigned tid)
      : a(p.in0 + static_cast<long long>(g) * p.N * p.H * p.W * p.Cin,
          p.Cin, p.H, p.W, m0, split * p.kslice, tid),
        b(p.in1 + static_cast<long long>(g) * p.N * p.H * p.W * p.Cout,
          p.in2 + static_cast<long long>(g) * p.N * p.H * p.W * p.Cout,
          p.Cout, n0, split * p.kslice),
        dw(p.out0 + static_cast<long long>(g) * 9 * p.Cin * p.Cout),
        db(p.out1 + static_cast<long long>(g) * p.Cout),
        ws(p.out2 == nullptr
               ? nullptr
               : p.out2 + (static_cast<long long>(split) * p.G + g) *
                              (9 * p.Cin + 1) * p.Cout),
        M(9 * p.Cin + 1),
        N(p.Cout),
        kbeg(split * p.kslice),
        kend(min(p.N * p.H * p.W, (split + 1) * p.kslice)) {}

  __device__ void epilogue(const float (&acc)[TM][C::TN], int m0, int n0,
                           int ty, int tx) const {
    constexpr int TN = C::TN;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + row_of<C>(ty, i);
      if (m >= M) continue;
      float* row = ws != nullptr ? ws + m * N : (m < M - 1 ? dw + m * N : db);
#pragma unroll
      for (int h = 0; h < TN; h += 4) {
        const int n = n0 + col_of<C>(tx, h);
        if (n < N)
          *reinterpret_cast<float4*>(row + n) = make_float4(
              acc[i][h], acc[i][h + 1], acc[i][h + 2], acc[i][h + 3]);
      }
    }
  }
};

template <class Op>
__global__ void __launch_bounds__(Op::C::T, 512 / Op::C::T)
    conv_gemm(const Args p) {
  using C = typename Op::C;
  constexpr int BM = C::BM, BN = C::BN, TN = C::TN, BK = C::BK;
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const unsigned tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = (warp % C::WX) * C::WTX + lane % C::WTX;
  const int ty = (warp / C::WX) * C::WTY + lane / C::WTX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int g = blockIdx.z % p.G, split = blockIdx.z / p.G;
  Op op(p, g, split, m0, n0, tid);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float4 ra[Op::A::R];
  float4 rb[Op::B::R];
  if (op.kbeg < op.kend) {
    op.a.fetch(op.kend, ra);
    op.b.fetch(op.kend, tid, rb);
    op.a.store(&As[0][0][0], tid, ra);
    op.b.store(&Bs[0][0][0], tid, rb);
    __syncthreads();
    int buf = 0;
    for (int k0 = op.kbeg; k0 < op.kend; k0 += BK) {
      const bool more = k0 + BK < op.kend;
      if (more) {
        op.a.fetch(op.kend, ra);
        op.b.fetch(op.kend, tid, rb);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
        *reinterpret_cast<float4*>(&a[0]) =
            *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        *reinterpret_cast<float4*>(&a[4]) =
            *reinterpret_cast<const float4*>(&As[buf][kk][BM / 2 + ty * 4]);
        *reinterpret_cast<float4*>(&b[0]) =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        if constexpr (TN == 8)
          *reinterpret_cast<float4*>(&b[4]) =
              *reinterpret_cast<const float4*>(&Bs[buf][kk][BN / 2 + tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) {
        op.a.store(&As[buf ^ 1][0][0], tid, ra);
        op.b.store(&Bs[buf ^ 1][0][0], tid, rb);
      }
      __syncthreads();
      buf ^= 1;
    }
  }
  op.epilogue(acc, m0, n0, ty, tx);
}

// Adds the wgrad slices in order: out[g, m, n] = sum_s ws[s, g, m, n], into
// dw (rows m < 9*Cin) or db (row 9*Cin).
__global__ void wgrad_reduce(const float* ws, float* dw, float* db,
                             int splits, int G, int rows, int N) {
  const long long per = static_cast<long long>(rows) * N;
  const long long total = per * G;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * total + i];
    const long long g = i / per, r = i - g * per;
    if (r < per - N)
      dw[g * (per - N) + r] = s;
    else
      db[g * N + (r - (per - N))] = s;
  }
}

template <template <class, bool> class Op, bool kVec, class C>
int launch(const Args& p, int rows, int cols, int gz, cudaStream_t st) {
  const dim3 grid((rows + C::BM - 1) / C::BM, (cols + C::BN - 1) / C::BN, gz);
  conv_gemm<Op<C, kVec>><<<grid, C::T, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The block tile, by the wrapper's code (its rule picks one from the
// product's shape; each code's BM x BN x TN is in ops.py's TILES).
template <template <class, bool> class Op, bool kVec>
int launch_tile(int tile, const Args& p, int rows, int cols, int gz,
                cudaStream_t st) {
  switch (tile) {
    case 0:
      return launch<Op, kVec, Cfg<128, 128, 8, 8>>(p, rows, cols, gz, st);
    case 1:
      return launch<Op, kVec, Cfg<128, 64, 8, 8>>(p, rows, cols, gz, st);
    case 2:
      return launch<Op, kVec, Cfg<128, 32, 4, 16>>(p, rows, cols, gz, st);
    case 3:
      return launch<Op, kVec, Cfg<32, 32, 4, 8>>(p, rows, cols, gz, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const float* i0, const float* i1, const float* i2, float* o0,
               float* o1, float* o2, int G, int N, int H, int W, int Cin,
               int Cout, int kslice) {
  Args p;
  p.in0 = i0;
  p.in1 = i1;
  p.in2 = i2;
  p.out0 = o0;
  p.out1 = o1;
  p.out2 = o2;
  p.G = G;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kslice = kslice;
  return p;
}

}  // namespace

// y (G, N, H, W, Cout) = relu(conv(x (G, N, H, W, Cin), w (G, 3, 3, Cin,
// Cout)) + b (G, Cout)). Cout % 4 == 0. Returns a CUDA error code.
extern "C" int fedcd_conv3x3_fwd(const float* x, const float* w,
                                 const float* b, float* y, int G, int N,
                                 int H, int W, int Cin, int Cout, int tile,
                                 void* stream) {
  const Args p = make_args(x, w, b, y, nullptr, nullptr, G, N, H, W, Cin,
                           Cout, 0);
  auto st = static_cast<cudaStream_t>(stream);
  return Cin % 4 == 0
             ? launch_tile<FwdOp, true>(tile, p, N * H * W, Cout, G, st)
             : launch_tile<FwdOp, false>(tile, p, N * H * W, Cout, G, st);
}

// dx (G, N, H, W, Cin) from dy and y (G, N, H, W, Cout) and w.
extern "C" int fedcd_conv3x3_dgrad(const float* dy, const float* y,
                                   const float* w, float* dx, int G, int N,
                                   int H, int W, int Cin, int Cout,
                                   int tile, void* stream) {
  const Args p = make_args(dy, y, w, dx, nullptr, nullptr, G, N, H, W, Cin,
                           Cout, 0);
  return launch_tile<DgradOp, true>(tile, p, N * H * W, Cin, G,
                                    static_cast<cudaStream_t>(stream));
}

// dw (G, 3, 3, Cin, Cout) and db (G, Cout) from x, dy and y. With splits > 1,
// ws holds (splits, G, 9*Cin + 1, Cout) floats of scratch.
extern "C" int fedcd_conv3x3_wgrad(const float* x, const float* dy,
                                   const float* y, float* dw, float* db,
                                   float* ws, int splits, int G, int N,
                                   int H, int W, int Cin, int Cout,
                                   int tile, void* stream) {
  const int pixels = N * H * W;
  const int kslice = ((pixels + splits - 1) / splits + 15) / 16 * 16;
  const Args p = make_args(x, dy, y, dw, db, splits > 1 ? ws : nullptr, G,
                           N, H, W, Cin, Cout, kslice);
  auto st = static_cast<cudaStream_t>(stream);
  const int rows = 9 * Cin + 1;
  int code = Cin % 4 == 0
                 ? launch_tile<WgradOp, true>(tile, p, rows, Cout,
                                              G * splits, st)
                 : launch_tile<WgradOp, false>(tile, p, rows, Cout,
                                               G * splits, st);
  if (code != 0 || splits == 1) return code;
  const long long total = static_cast<long long>(G) * rows * Cout;
  const int blocks = static_cast<int>(std::min(4096LL, (total + 255) / 256));
  wgrad_reduce<<<blocks, 256, 0, st>>>(ws, dw, db, splits, G, rows, Cout);
  return static_cast<int>(cudaGetLastError());
}
