// Block-sparse attention for Hopper (sm_90a): forward, dQ sweep and dK/dV sweep.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py
// (tensor-core kernels for bf16 at block 64/128, scalar kernels for fp32 and blocks 16/32):
//   bsa_fwd_tc_kernel,      bsa_fwd_kernel      <- _fwd_kernel       (launched by _sparse_fwd)
//   bsa_bwd_dq_tc_kernel,   bsa_bwd_dq_kernel   <- _bwd_dq_kernel    (launched by _sparse_bwd)
//   bsa_bwd_dkdv_tc_kernel, bsa_bwd_dkdv_kernel <- _bwd_dkdv_kernel  (launched by _sparse_bwd)
//
// Each kernel computes the whole function of its Pallas counterpart. A (H, nb, nb)
// block layout is handed over as lookup tables built on the host (build_luts):
//   cols[h, qb, a]   the a'th active key block of query block qb (a < nnz[h, qb])
//   rows_t[h, kb, a] the a'th query block that attends to key block kb (a < nnz_t[h, kb])
// Scores are (q . k) * scale plus an optional additive per-key bias (B, S) (key
// padding, -1e30 for a padded key), over the active blocks only; an online
// softmax with fp32 running max and denominator, initial max -1e30. A row with no
// active block writes 0 and lse = -1e30, bit for bit as the Pallas kernel. Both
// products are taken in fp32 from the stored (bf16 or fp32) inputs, as the Pallas
// kernels upcast q, k and v before their dots; p stays fp32.
//
// Layout: q, k, v, out, dout, dq, dk, dv are (B*H, S, D) contiguous in the storage
// dtype; lse and delta are compact (B*H, S) fp32; the LUTs are int32.
//
// Design. The TPU grid (bh, q block, a) runs its last axis in order with
// pl.when(a < nnz) skipping padded entries; here blocks run in parallel in no
// order, so the walk over the LUT is a loop inside one thread block, reading
// the block indices from global memory (no padded entry is visited):
//   fwd   one block per (bh, q tile), walking cols;
//   dQ    one block per (bh, q tile), walking cols;
//   dK/dV one block per (bh, k tile), walking rows_t.
// Every output has one writer, so no atomics are needed. A tile is TQ = min(block, 64)
// rows; a layout block of 128 is two tiles, and the loops visit both halves of
// every active block. The scalar kernels stage tiles in shared memory as fp32 (row
// pitch D+1, so the 16 threads of a half-warp reading 16 different rows hit 16
// different banks). 256 threads form a 16x16 grid; each owns a (TQ/16) x (TQ/16) patch of
// the TQ x TQ score tile (rows ty+16i, columns tx+16j) and a (TQ/16) x (D/16) patch
// of the fp32 accumulators. Row reductions are 16-lane shuffles in a half-warp.
//
// Bound. At the long-sequence BERT shape (B*H = 48, S = 4096, D = 64, block 64,
// 19 active blocks per row) each kernel does 60-120 GFLOP against 100-150 MB
// moved, far above the card's bytes/operations balance point, so it is bound by
// operations: the tensor cores for bf16, fp32 FMAs for the scalar kernels. The
// LUT of the dK/dV sweep is uneven (a global key block is walked by every query
// block, a local one by a few), so its blocks differ in work: the tensor-core
// sweep takes its key tiles longest first, through a per-head permutation of
// the key blocks by descending nnz_t (Luts.order_t), so that the short tiles
// fill the tail.
//
// Routing, before launch: bf16 at block 64 or 128 runs the three tensor-core
// kernels (wgmma, TMA, mbarriers, the PTX helpers of
// ../../transformer/csrc/hopper.cuh); fp32 and blocks 16 and 32 run the scalar
// kernels. Precision of the tensor-core kernels: the first products (S = Q.K^T,
// dP = dO.V^T, or their transposes) from bf16 operands are exact per product
// and summed in fp32, as the Pallas kernels' fp32 dots of upcast inputs (only
// the order of the sum differs); p and dS stay at fp32 accuracy for the second
// products (P.V, p^T.dO, dS^T.Q, dS.K), each split into two bf16 operands
// x_hi + x_lo (about 16 bits of x) whose products sum into one fp32
// accumulator. Rounding p or dS to bf16 once would not compute the Pallas
// function, which keeps both in fp32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "../../transformer/csrc/hopper.cuh"

namespace {

constexpr int kThreads = 256;      // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

struct BsaParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // nullptr or (B, S) fp32, additive per key
  const void* dout;
  const float* lse;    // (B*H, S)
  const float* delta;  // (B*H, S)
  const int* lut;      // cols (H, nb, max_nnz) or rows_t (H, nb, max_nnz_t)
  const int* nnz;      // nnz or nnz_t, (H, nb)
  const int* order;    // dK/dV: (H, nb) key blocks by descending nnz_t
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int heads;
  int seq;
  int block;           // layout block, a multiple of the tile
  int max_nnz;         // row stride of the LUT
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + TQ) of a (S, D) matrix into a (TQ, D+1) fp32 tile; S is a
// multiple of the tile, so every row is in range
template <typename T, int D, int TQ>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int tid) {
  for (int idx = tid; idx < TQ * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * (D + 1) + c] = to_float(src[(size_t)(row0 + r) * D + c]);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[i][j] = sum_d A[ty+16i][d] * B[tx+16j][d] over two (TQ, D+1) tiles
template <int D, int R>
__device__ __forceinline__ void tile_dot(float (&s)[R][R], const float* A, const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][jj] += sum_c P[row_i][c] * X[c][tx+16jj], P a (TQ, TQ+1) tile read at
// rows ty+16i (transposed: P[c][ty+16i] when kTransposeP), X a (TQ, D+1) tile
template <int D, int TQ, bool kTransposeP>
__device__ __forceinline__ void tile_acc(float (&acc)[TQ / 16][D / 16], const float* P, const float* X,
                                         int ty, int tx) {
  constexpr int R = TQ / 16;
  constexpr int PP = TQ + 1;
#pragma unroll 4
  for (int c = 0; c < TQ; ++c) {
    float a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = kTransposeP ? P[c * PP + ty + 16 * i] : P[(ty + 16 * i) * PP + c];
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      const float x = X[c * (D + 1) + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i][jj] = fmaf(a[i], x, acc[i][jj]);
    }
  }
}

template <typename T, int D, int TQ>
__global__ void __launch_bounds__(kThreads) bsa_fwd_kernel(BsaParams p) {
  extern __shared__ float smem[];
  constexpr int R = TQ / 16, NJ = D / 16, PP = TQ + 1;
  float* Qs = smem;
  float* Ks = Qs + TQ * (D + 1);
  float* Vs = Ks + TQ * (D + 1);
  float* Ps = Vs + TQ * (D + 1);

  const int q0 = blockIdx.x * TQ;
  const int bh = blockIdx.y;
  const int h = bh % p.heads;
  const int nb = p.seq / p.block;
  const int row = h * nb + q0 / p.block;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t off = (size_t)bh * p.seq * D;
  const T* k = static_cast<const T*>(p.k) + off;
  const T* v = static_cast<const T*>(p.v) + off;
  const float* bias = p.bias ? p.bias + (size_t)(bh / p.heads) * p.seq : nullptr;

  load_tile<T, D, TQ>(Qs, static_cast<const T*>(p.q) + off, q0, tid);

  float acc[R][NJ];
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_active = p.nnz[row];
  const int* cols = p.lut + (size_t)row * p.max_nnz;
  const int subtiles = p.block / TQ;
  for (int a = 0; a < n_active; ++a) {
    const int kb = cols[a];
    for (int st = 0; st < subtiles; ++st) {
      const int k0 = kb * p.block + st * TQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D, TQ>(Ks, k, k0, tid);
      load_tile<T, D, TQ>(Vs, v, k0, tid);
      __syncthreads();

      float s[R][R];
      tile_dot<D, R>(s, Qs, Ks, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] *= p.scale;
          if (bias != nullptr) s[i][j] += bias[k0 + tx + 16 * j];
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m[i], half_warp_max(mx));
        const float alpha = expf(m[i] - m_new);
        float row_sum = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float pr = expf(s[i][j] - m_new);
          row_sum += pr;
          Ps[(ty + 16 * i) * PP + tx + 16 * j] = pr;
        }
        l[i] = l[i] * alpha + half_warp_sum(row_sum);
        m[i] = m_new;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
      }
      __syncthreads();
      tile_acc<D, TQ, false>(acc, Ps, Vs, ty, tx);
    }
  }

  T* out = static_cast<T*>(p.out) + off;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    // a row with no active block writes zeros
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      out[(size_t)qi * D + tx + 16 * jj] = from_float<T>(l[i] > 0.f ? acc[i][jj] / l_safe : 0.f);
    if (tx == 0) p.lse_out[(size_t)bh * p.seq + qi] = m[i] + logf(l_safe);
  }
}

// p = exp(s - lse) and ds = p * (dO.v^T - delta) * scale for one TQ x TQ tile
// of query rows q0.. against key rows k0..; writes p to Pd when Pd is not null
// and ds to Ds
template <int D, int TQ>
__device__ __forceinline__ void bwd_tile(const BsaParams& p, const float* bias, const float* Qs,
                                         const float* Ks, const float* Vs, const float* dOs,
                                         const float* lse_s, const float* delta_s, float* Pd, float* Ds,
                                         int k0, int ty, int tx) {
  constexpr int R = TQ / 16, PP = TQ + 1;
  float s[R][R], dp[R][R];
  tile_dot<D, R>(s, Qs, Ks, ty, tx);
  tile_dot<D, R>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      float x = s[i][j] * p.scale;
      if (bias != nullptr) x += bias[k0 + c];
      const float pr = expf(x - lse_s[r]);
      if (Pd != nullptr) Pd[r * PP + c] = pr;
      Ds[r * PP + c] = pr * (dp[i][j] - delta_s[r]) * p.scale;
    }
  }
}

template <typename T, int D, int TQ>
__global__ void __launch_bounds__(kThreads) bsa_bwd_dq_kernel(BsaParams p) {
  extern __shared__ float smem[];
  constexpr int R = TQ / 16, NJ = D / 16, PP = TQ + 1;
  float* Qs = smem;
  float* dOs = Qs + TQ * (D + 1);
  float* Ks = dOs + TQ * (D + 1);
  float* Vs = Ks + TQ * (D + 1);
  float* Ds = Vs + TQ * (D + 1);
  float* lse_s = Ds + TQ * PP;
  float* delta_s = lse_s + TQ;

  const int q0 = blockIdx.x * TQ;
  const int bh = blockIdx.y;
  const int h = bh % p.heads;
  const int nb = p.seq / p.block;
  const int row = h * nb + q0 / p.block;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t off = (size_t)bh * p.seq * D;
  const T* k = static_cast<const T*>(p.k) + off;
  const T* v = static_cast<const T*>(p.v) + off;
  const float* bias = p.bias ? p.bias + (size_t)(bh / p.heads) * p.seq : nullptr;

  load_tile<T, D, TQ>(Qs, static_cast<const T*>(p.q) + off, q0, tid);
  load_tile<T, D, TQ>(dOs, static_cast<const T*>(p.dout) + off, q0, tid);
  if (tid < TQ) {
    lse_s[tid] = p.lse[(size_t)bh * p.seq + q0 + tid];
    delta_s[tid] = p.delta[(size_t)bh * p.seq + q0 + tid];
  }

  float dq[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dq[i][jj] = 0.f;

  const int n_active = p.nnz[row];
  const int* cols = p.lut + (size_t)row * p.max_nnz;
  const int subtiles = p.block / TQ;
  for (int a = 0; a < n_active; ++a) {
    const int kb = cols[a];
    for (int st = 0; st < subtiles; ++st) {
      const int k0 = kb * p.block + st * TQ;
      __syncthreads();
      load_tile<T, D, TQ>(Ks, k, k0, tid);
      load_tile<T, D, TQ>(Vs, v, k0, tid);
      __syncthreads();
      bwd_tile<D, TQ>(p, bias, Qs, Ks, Vs, dOs, lse_s, delta_s, nullptr, Ds, k0, ty, tx);
      __syncthreads();
      tile_acc<D, TQ, false>(dq, Ds, Ks, ty, tx);  // dq += ds . k
    }
  }

  T* dq_out = static_cast<T*>(p.dq) + off;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dq_out[(size_t)qi * D + tx + 16 * jj] = from_float<T>(dq[i][jj]);
  }
}

template <typename T, int D, int TQ>
__global__ void __launch_bounds__(kThreads) bsa_bwd_dkdv_kernel(BsaParams p) {
  extern __shared__ float smem[];
  constexpr int R = TQ / 16, NJ = D / 16, PP = TQ + 1;
  float* Ks = smem;
  float* Vs = Ks + TQ * (D + 1);
  float* Qs = Vs + TQ * (D + 1);
  float* dOs = Qs + TQ * (D + 1);
  float* Ps = dOs + TQ * (D + 1);
  float* Ds = Ps + TQ * PP;
  float* lse_s = Ds + TQ * PP;
  float* delta_s = lse_s + TQ;

  const int k0 = blockIdx.x * TQ;
  const int bh = blockIdx.y;
  const int h = bh % p.heads;
  const int nb = p.seq / p.block;
  const int col = h * nb + k0 / p.block;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t off = (size_t)bh * p.seq * D;
  const T* q = static_cast<const T*>(p.q) + off;
  const T* dout = static_cast<const T*>(p.dout) + off;
  const float* lse = p.lse + (size_t)bh * p.seq;
  const float* delta = p.delta + (size_t)bh * p.seq;
  // the bias row of this key tile broadcasts over the query rows
  const float* bias = p.bias ? p.bias + (size_t)(bh / p.heads) * p.seq : nullptr;

  load_tile<T, D, TQ>(Ks, static_cast<const T*>(p.k) + off, k0, tid);
  load_tile<T, D, TQ>(Vs, static_cast<const T*>(p.v) + off, k0, tid);

  float dk[R][NJ], dv[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  const int n_active = p.nnz[col];
  const int* rows = p.lut + (size_t)col * p.max_nnz;
  const int subtiles = p.block / TQ;
  for (int a = 0; a < n_active; ++a) {
    const int qb = rows[a];
    for (int st = 0; st < subtiles; ++st) {
      const int q0 = qb * p.block + st * TQ;
      __syncthreads();
      load_tile<T, D, TQ>(Qs, q, q0, tid);
      load_tile<T, D, TQ>(dOs, dout, q0, tid);
      if (tid < TQ) {
        lse_s[tid] = lse[q0 + tid];
        delta_s[tid] = delta[q0 + tid];
      }
      __syncthreads();
      bwd_tile<D, TQ>(p, bias, Qs, Ks, Vs, dOs, lse_s, delta_s, Ps, Ds, k0, ty, tx);
      __syncthreads();
      // dv += p^T . dO ; dk += ds^T . q  (rows of dk/dv are key positions)
      tile_acc<D, TQ, true>(dv, Ps, dOs, ty, tx);
      tile_acc<D, TQ, true>(dk, Ds, Qs, ty, tx);
    }
  }

  T* dk_out = static_cast<T*>(p.dk) + off;
  T* dv_out = static_cast<T*>(p.dv) + off;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      dk_out[(size_t)kj * D + tx + 16 * jj] = from_float<T>(dk[i][jj]);
      dv_out[(size_t)kj * D + tx + 16 * jj] = from_float<T>(dv[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels (B5 forward, B6 dQ, B7 dK/dV): wgmma + TMA + mbarriers
// ---------------------------------------------------------------------------
constexpr int kTcRows = 64;                   // rows of a q tile and of a k/v tile
constexpr int kTcConsumerWarps = 4;           // one consumer warpgroup
constexpr int kTcThreads = 32 * kTcConsumerWarps + 32;  // + one producer warp
constexpr int kTcStages = 2;                  // ring of k/v (or q/dO) tiles

// bytes of a swizzled 64-row tile at head_dim D (zero-padded to whole panels)
template <int D> __host__ __device__ constexpr uint32_t tc_tile_bytes() {
  return static_cast<uint32_t>(hopper::tc_panels<D>() * kTcRows * hopper::kRowBytes);
}
template <int D> constexpr size_t fwd_tc_smem() {
  // Q, K/V ring, the ring's key-bias rows, 5 mbarriers, 1024 bytes to align the tiles
  return tc_tile_bytes<D>() + 2 * kTcStages * tc_tile_bytes<D>() + kTcStages * kTcRows * sizeof(float) + 64 +
         1024;
}
template <int D> constexpr size_t dq_tc_smem() {
  // Q, dO, K/V ring, the ring's key-bias rows, 5 mbarriers, alignment
  return 2 * tc_tile_bytes<D>() + 2 * kTcStages * tc_tile_bytes<D>() + kTcStages * kTcRows * sizeof(float) +
         64 + 1024;
}
template <int D> constexpr size_t dkdv_tc_smem() {
  // K, V, Q/dO ring, the ring's lse and delta rows, 5 mbarriers, alignment
  return 2 * tc_tile_bytes<D>() + 2 * kTcStages * tc_tile_bytes<D>() +
         kTcStages * 2 * kTcRows * sizeof(float) + 64 + 1024;
}

// One fp32 pair as a bf16 pair `hi` (round to nearest) and the bf16 pair of
// what that rounding left, `lo`: hi + lo holds the pair to about 16 bits.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo, float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - back.x, x1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A 64-column fp32 accumulator as the register A operands of its 4 k-steps
// (see hopper::wgmma_rs), each pair split into hi and lo
__device__ __forceinline__ void split_acc(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_bf16(hi[c][r], lo[c][r], x[8 * c + 2 * r], x[8 * c + 2 * r + 1]);
}

// After the wait that ends the products: the accumulator and both operands
// stay in their registers across it (see hopper::fence_regs)
template <int NP>
__device__ __forceinline__ void fence_split(float (&acc)[NP][32], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) hopper::fence_regs(acc[pp]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::fence_regs(hi[kk]);
    hopper::fence_regs(lo[kk]);
  }
}

// acc[pp] += (hi + lo) . B over 64 k rows, B a 64-row tile of NP swizzled
// panels in shared memory read MN-major: k-step kk reads rows 16 kk .. 16 kk + 15.
// Issued only: the caller commits and waits.
template <int NP>
__device__ __forceinline__ void split_products(float (&acc)[NP][32], const uint32_t (&hi)[4][4],
                                               const uint32_t (&lo)[4][4], uint32_t b_tile) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < kTcRows / 16; ++kk)
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      const uint64_t desc = desc_mn_major(b_tile + pp * kTcRows * kRowBytes + kk * 16 * kRowBytes);
      wgmma_rs(acc[pp], hi[kk], desc);
      wgmma_rs(acc[pp], lo[kk], desc);
    }
}

// 64 fp32 from global `src` to shared `dst`, by the 32 lanes of a warp
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int lane) {
  dst[lane] = src[lane];
  dst[lane + 32] = src[lane + 32];
}

// The producer warp's ring, shared by B5-B7. For each of the n_iter 64-row
// tiles that the LUT row `lut` names (each 64-row half of a 128 block in
// turn) it waits until stage s = it % kTcStages is free, lets all 32 lanes
// write that tile's per-row values through `rows_in(s, r0)`, and loads rows
// r0 .. r0 + 63 of `ma` and of `mb` by TMA into ring + 2 s kBytes and the
// kBytes after it. Every lane arrives on the stage's full barrier, lane 0
// with the bytes of the transfer.
template <int D, typename RowsIn>
__device__ __forceinline__ void produce_ring(const int* lut, int n_iter, int block, const CUtensorMap* ma,
                                             const CUtensorMap* mb, uint32_t ring, uint32_t bar_full,
                                             uint32_t bar_empty, int bh, int lane, RowsIn rows_in) {
  using namespace hopper;
  constexpr uint32_t kBytes = tc_tile_bytes<D>();
  const int subtiles = block / kTcRows;
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kTcStages;
    const int r0 = lut[it / subtiles] * block + (it % subtiles) * kTcRows;
    if (it >= kTcStages) mbar_wait(bar_empty + 8 * s, (it / kTcStages - 1) & 1);
    rows_in(s, r0);
    if (lane == 0) {
      const uint32_t sa = ring + 2 * s * kBytes, sb = sa + kBytes;
      mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kBytes);
      for (int pp = 0; pp < tc_panels<D>(); ++pp) {
        tma_load_3d(sa + pp * kTcRows * kRowBytes, ma, bar_full + 8 * s, pp * kPanelCols, r0, bh);
        tma_load_3d(sb + pp * kTcRows * kRowBytes, mb, bar_full + 8 * s, pp * kPanelCols, r0, bh);
      }
    } else {
      mbar_arrive(bar_full + 8 * s);
    }
  }
}

// B5 on the tensor cores. One block per (bh, 64-row q tile): warps 0-3 are
// one consumer warpgroup, warp 4 the producer. The producer reads the q
// tile's LUT row and loads the Q tile once and, for every active key block
// (each 64-row half of a 128 block in turn), its K and V tiles by TMA and
// its 64 fp32 of key bias into a 2-stage ring. The consumer computes
// S = Q.K^T by wgmma (bf16 operands, whose products are exact in the fp32
// accumulator), s = S * scale + bias in fp32 in that order, the online
// softmax on S's accumulator registers, and O += P.V with p kept to fp32
// accuracy: p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), the
// register A operands of two products into the same fp32 accumulator, V
// read MN-major from the swizzled tile. Several blocks share an SM, so one
// block's products overlap another's softmax.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    bsa_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, BsaParams p) {
  using namespace hopper;
  constexpr int NP = tc_panels<D>();  // output / V panels of 64 columns
  constexpr int KD = D / 16;          // k-steps of Q.K^T
  constexpr uint32_t kBytes = tc_tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base;
  const uint32_t sKV = sQ + kBytes;  // stage s: K at sKV + 2 s kBytes, V after it
  const uint32_t sBias = sKV + 2 * kTcStages * kBytes;  // stage s: 64 fp32 at sBias + 256 s
  const uint32_t bars = sBias + kTcStages * kTcRows * sizeof(float);
  const uint32_t bar_q = bars, bar_full = bars + 8, bar_empty = bars + 8 + 8 * kTcStages;

  const int q0 = blockIdx.x * kTcRows;
  const int bh = blockIdx.y;
  const int nb = p.seq / p.block;
  const int lut_row = (bh % p.heads) * nb + q0 / p.block;
  const int subtiles = p.block / kTcRows;
  const int n_iter = p.nnz[lut_row] * subtiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's 32 lanes
      mbar_init(bar_empty + 8 * s, kTcConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTcConsumerWarps) {  // producer
    const int* cols = p.lut + (size_t)lut_row * p.max_nnz;
    const float* bias = p.bias ? p.bias + (size_t)(bh / p.heads) * p.seq : nullptr;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, kBytes);
      for (int pp = 0; pp < NP; ++pp) tma_load_3d(sQ + pp * kTcRows * kRowBytes, &tm_q, bar_q, pp * kPanelCols, q0, bh);
    }
    produce_ring<D>(cols, n_iter, p.block, &tm_k, &tm_v, sKV, bar_full, bar_empty, bh, lane, [&](int s, int k0) {
      if (bias != nullptr)
        copy_rows(reinterpret_cast<float*>(base_ptr + (sBias + s * kTcRows * sizeof(float) - base)), bias + k0, lane);
    });
    return;
  }

  // the consumer warpgroup: this thread holds rows q0 + 16 w + lane/4 + 8h
  // and, in each 8-column group j of an accumulator, columns 8j + c_off + {0, 1}
  const int w = warp;
  const int c_off = 2 * (lane % 4);
  const bool has_bias = p.bias != nullptr;

  float o[NP][32];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pp][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kTcStages;
    const uint32_t sK = sKV + 2 * s * kBytes, sV = sK + kBytes;
    const float* kb = reinterpret_cast<const float*>(base_ptr + (sBias + s * kTcRows * sizeof(float) - base));
    mbar_wait(bar_full + 8 * s, (it / kTcStages) & 1);

    // S = Q . K^T
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const uint32_t col = (kd % 4) * 32;  // 16 bf16 further along the swizzled row
      wgmma_ss(sc, desc_k_major(sQ + (kd / 4) * kTcRows * kRowBytes + col),
               desc_k_major(sK + (kd / 4) * kTcRows * kRowBytes + col), kd > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // s = (q . k) * scale + bias, two roundings in that order (no fused
    // multiply-add: an all-padded row must tie at exactly -1e30), then the
    // running max. Branches are uniform and outside the element loops.
    if (has_bias) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = __fadd_rn(__fmul_rn(sc[i], p.scale), kb[tc_col(i, c_off)]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = __fmul_rn(sc[i], p.scale);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = exp2f((m[h] - mx[h]) * kLog2e);
      m[h] = mx[h];
    }

    // p = exp(s - m) in fp32 feeds the denominator and, split in two bf16
    // parts, the product with V
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2f((sc[i] - m[(i >> 1) & 1]) * kLog2e);
      row_sum[(i >> 1) & 1] += sc[i];
    }
    uint32_t p_hi[4][4], p_lo[4][4];
    split_acc(p_hi, p_lo, sc);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + row_sum[h];  // per-thread share of the row
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pp][i] *= alpha[(i >> 1) & 1];

    // O += p_hi . V + p_lo . V, V MN-major
    wgmma_fence();
    split_products<NP>(o, p_hi, p_lo, sV);
    wgmma_commit();
    wgmma_wait<0>();
    fence_split<NP>(o, p_hi, p_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // a row with no active block (l = 0) writes zeros and lse = -1e30 + log(1)
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + (size_t)bh * p.seq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * w + lane / 4 + 8 * h;
    const float lt = quad_sum(l[h]);
    const float l_safe = lt == 0.f ? 1.f : lt;
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * pp + 8 * j + c_off;
        if (col < D) {
          const float a = lt > 0.f ? o[pp][4 * j + 2 * h] / l_safe : 0.f;
          const float b = lt > 0.f ? o[pp][4 * j + 2 * h + 1] / l_safe : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + col) = __floats2bfloat162_rn(a, b);
        }
      }
    if (lane % 4 == 0) p.lse_out[(size_t)bh * p.seq + row] = m[h] + logf(l_safe);
  }
}

// Writes a 64-row fp32 tile held in accumulator layout (rows `row0` + 16 w +
// lane/4 + 8h of a (S, D) bf16 matrix at `out`) rounded to bf16
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, const float (&acc)[hopper::tc_panels<D>()][32],
                                           int row0, int w, int lane) {
  const int c_off = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * w + lane / 4 + 8 * h;
#pragma unroll
    for (int pp = 0; pp < hopper::tc_panels<D>(); ++pp)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * pp + 8 * j + c_off;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + col) =
              __floats2bfloat162_rn(acc[pp][4 * j + 2 * h], acc[pp][4 * j + 2 * h + 1]);
      }
  }
}

// B6 on the tensor cores, B3's dataflow over the forward LUT. One block per
// (bh, 64-row q tile): warps 0-3 are one consumer warpgroup, warp 4 the
// producer (a 128-row q tile would span two query blocks at block 64, whose
// LUT rows differ). The producer loads Q and dO once and, for every active
// key block (each 64-row half of a 128 block in turn), its K and V tiles by
// TMA and its 64 fp32 of key bias into a 2-stage ring. The consumer computes
// S = Q.K^T and dP = dO.V^T by wgmma (bf16 operands, exact products, fp32
// sums), s = S * scale + bias as B5 does, p = exp(s - lse) and dS = p (dP -
// delta) scale in fp32, and dQ += dS_hi.K + dS_lo.K with dS split as B5
// splits p, K read MN-major from the swizzled tile. lse and delta of the
// thread's two rows are read once.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    bsa_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                         BsaParams p) {
  using namespace hopper;
  constexpr int NP = tc_panels<D>();
  constexpr int KD = D / 16;
  constexpr uint32_t kBytes = tc_tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base, sDO = sQ + kBytes;
  const uint32_t sKV = sDO + kBytes;  // stage s: K at sKV + 2 s kBytes, V after it
  const uint32_t sBias = sKV + 2 * kTcStages * kBytes;  // stage s: 64 fp32 at sBias + 256 s
  const uint32_t bars = sBias + kTcStages * kTcRows * sizeof(float);
  const uint32_t bar_q = bars, bar_full = bars + 8, bar_empty = bars + 8 + 8 * kTcStages;

  const int q0 = blockIdx.x * kTcRows;
  const int bh = blockIdx.y;
  const int nb = p.seq / p.block;
  const int lut_row = (bh % p.heads) * nb + q0 / p.block;
  const int subtiles = p.block / kTcRows;
  const int n_iter = p.nnz[lut_row] * subtiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's 32 lanes
      mbar_init(bar_empty + 8 * s, kTcConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTcConsumerWarps) {  // producer
    const int* cols = p.lut + (size_t)lut_row * p.max_nnz;
    const float* bias = p.bias ? p.bias + (size_t)(bh / p.heads) * p.seq : nullptr;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * kBytes);
      for (int pp = 0; pp < NP; ++pp) {
        tma_load_3d(sQ + pp * kTcRows * kRowBytes, &tm_q, bar_q, pp * kPanelCols, q0, bh);
        tma_load_3d(sDO + pp * kTcRows * kRowBytes, &tm_do, bar_q, pp * kPanelCols, q0, bh);
      }
    }
    produce_ring<D>(cols, n_iter, p.block, &tm_k, &tm_v, sKV, bar_full, bar_empty, bh, lane, [&](int s, int k0) {
      if (bias != nullptr)
        copy_rows(reinterpret_cast<float*>(base_ptr + (sBias + s * kTcRows * sizeof(float) - base)), bias + k0, lane);
    });
    return;
  }

  // the consumer warpgroup: this thread holds rows q0 + 16 w + lane/4 + 8h
  // and, in each 8-column group j of an accumulator, k columns 8j + c_off + {0, 1}
  const int w = warp;
  const int c_off = 2 * (lane % 4);
  const bool has_bias = p.bias != nullptr;
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * p.seq + q0 + 16 * w + lane / 4 + 8 * h;
    lse[h] = p.lse[row];
    delta[h] = p.delta[row];
  }

  float dq[NP][32];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[pp][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kTcStages;
    const uint32_t sK = sKV + 2 * s * kBytes, sV = sK + kBytes;
    const float* kb = reinterpret_cast<const float*>(base_ptr + (sBias + s * kTcRows * sizeof(float) - base));
    mbar_wait(bar_full + 8 * s, (it / kTcStages) & 1);

    // S = Q . K^T and dP = dO . V^T
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const uint32_t off = (kd / 4) * kTcRows * kRowBytes + (kd % 4) * 32;
      wgmma_ss(sc, desc_k_major(sQ + off), desc_k_major(sK + off), kd > 0);
      wgmma_ss(dp, desc_k_major(sDO + off), desc_k_major(sV + off), kd > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // s = (q . k) * scale + bias in that order (see the forward); p =
    // exp(s - lse) with expf of the difference, as the plain version
    // computes it; dS = p (dP - delta) scale, all in fp32
    if (has_bias) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = __fadd_rn(__fmul_rn(sc[i], p.scale), kb[tc_col(i, c_off)]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = __fmul_rn(sc[i], p.scale);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      dp[i] = expf(sc[i] - lse[h]) * (dp[i] - delta[h]) * p.scale;
    }

    // dQ += dS_hi . K + dS_lo . K
    uint32_t ds_hi[4][4], ds_lo[4][4];
    split_acc(ds_hi, ds_lo, dp);
    wgmma_fence();
    split_products<NP>(dq, ds_hi, ds_lo, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_split<NP>(dq, ds_hi, ds_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  store_tile<D>(static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * p.seq * D, dq, q0, w, lane);
}

// B7 on the tensor cores, B2's dataflow over the transpose LUT. One block
// per (bh, 64-row key tile): warps 0-3 are one consumer warpgroup, warp 4
// the producer (a 128-row key tile would span two key blocks at block 64,
// whose transpose-LUT rows differ; at block 128 the two tiles of a key block
// walk the same row). blockIdx.y is a rank in the head's key blocks ordered
// by descending nnz_t (p.order), so the tiles that walk the most query
// blocks (the global key blocks) start first and the short ones fill the
// tail. The producer loads K and V once and, for every active query block
// (both 64-row halves at block 128), its Q and dO tiles by TMA and their 64
// lse and delta values into a 2-stage ring. The consumer computes the
// transposed products S^T = K.Q^T and dP^T = V.dO^T by wgmma, adds the key
// bias (constant along an accumulator row: this thread's two key rows), p^T
// and dS^T in fp32, then dV += (p_hi + p_lo)^T.dO and dK += (dS_hi +
// dS_lo)^T.Q, dO and Q read MN-major from the same swizzled tiles. dK and dV stay in fp32
// registers (64 a thread per panel) and have one writer each. At head_dim
// 64 two blocks share an SM; at 96 and 128 (two panels: dK and dV take 128
// registers) one.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 2 : 1)
    bsa_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                           BsaParams p) {
  using namespace hopper;
  constexpr int NP = tc_panels<D>();
  constexpr int KD = D / 16;
  constexpr uint32_t kBytes = tc_tile_bytes<D>();
  constexpr uint32_t kStatBytes = 2 * kTcRows * sizeof(float);  // lse[64], delta[64]
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = sK + kBytes;
  const uint32_t sRing = sV + kBytes;  // stage s: Q at sRing + 2 s kBytes, dO after it
  const uint32_t sStats = sRing + 2 * kTcStages * kBytes;  // stage s: at sStats + s kStatBytes
  const uint32_t bars = sStats + kTcStages * kStatBytes;
  const uint32_t bar_kv = bars, bar_full = bars + 8, bar_empty = bars + 8 + 8 * kTcStages;

  const int bh = blockIdx.x;
  const int h = bh % p.heads;
  const int nb = p.seq / p.block;
  const int subtiles = p.block / kTcRows;
  const int kb = p.order[h * nb + blockIdx.y / subtiles];
  const int k0 = kb * p.block + (blockIdx.y % subtiles) * kTcRows;
  const int lut_row = h * nb + kb;
  const int n_iter = p.nnz[lut_row] * subtiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's 32 lanes
      mbar_init(bar_empty + 8 * s, kTcConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTcConsumerWarps) {  // producer
    const int* rows = p.lut + (size_t)lut_row * p.max_nnz;
    const float* lse = p.lse + (size_t)bh * p.seq;
    const float* delta = p.delta + (size_t)bh * p.seq;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * kBytes);
      for (int pp = 0; pp < NP; ++pp) {
        tma_load_3d(sK + pp * kTcRows * kRowBytes, &tm_k, bar_kv, pp * kPanelCols, k0, bh);
        tma_load_3d(sV + pp * kTcRows * kRowBytes, &tm_v, bar_kv, pp * kPanelCols, k0, bh);
      }
    }
    produce_ring<D>(rows, n_iter, p.block, &tm_q, &tm_do, sRing, bar_full, bar_empty, bh, lane, [&](int s, int q0) {
      float* stats = reinterpret_cast<float*>(base_ptr + (sStats + s * kStatBytes - base));
      copy_rows(stats, lse + q0, lane);
      copy_rows(stats + kTcRows, delta + q0, lane);
    });
    return;
  }

  // the consumer warpgroup: this thread holds key rows k0 + 16 w + lane/4 +
  // 8h and, in each 8-column group j of an accumulator, q columns 8j + c_off
  // + {0, 1}
  const int w = warp;
  const int c_off = 2 * (lane % 4);
  const bool has_bias = p.bias != nullptr;
  float kbias[2] = {0.f, 0.f};
  if (has_bias) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      kbias[h2] = p.bias[(size_t)(bh / p.heads) * p.seq + k0 + 16 * w + lane / 4 + 8 * h2];
  }

  float dk[NP][32], dv[NP][32];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[pp][i] = dv[pp][i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kTcStages;
    const uint32_t sQ = sRing + 2 * s * kBytes, sDO = sQ + kBytes;
    const float* lse_s = reinterpret_cast<const float*>(base_ptr + (sStats + s * kStatBytes - base));
    const float* delta_s = lse_s + kTcRows;
    mbar_wait(bar_full + 8 * s, (it / kTcStages) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T (64 k rows x 64 q columns)
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const uint32_t off = (kd / 4) * kTcRows * kRowBytes + (kd % 4) * 32;
      wgmma_ss(st, desc_k_major(sK + off), desc_k_major(sQ + off), kd > 0);
      wgmma_ss(dpt, desc_k_major(sV + off), desc_k_major(sDO + off), kd > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // s = (q . k) * scale + bias in that order (see the forward), then p =
    // exp(s - lse) and dS = p (dP - delta) scale in fp32, lse and delta per
    // q column
    if (has_bias) {
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = __fadd_rn(__fmul_rn(st[i], p.scale), kbias[(i >> 1) & 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = __fmul_rn(st[i], p.scale);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = tc_col(i, c_off);
      st[i] = expf(st[i] - lse_s[c]);
      dpt[i] = st[i] * (dpt[i] - delta_s[c]) * p.scale;
    }

    // dV += p_hi^T . dO + p_lo^T . dO and dK += dS_hi^T . Q + dS_lo^T . Q,
    // both split before either is issued (splitting dS while the dV
    // products run needs more registers than two blocks per SM leave, and
    // ptxas then serializes the products)
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    split_acc(p_hi, p_lo, st);
    split_acc(ds_hi, ds_lo, dpt);
    wgmma_fence();
    split_products<NP>(dv, p_hi, p_lo, sDO);
    split_products<NP>(dk, ds_hi, ds_lo, sQ);
    wgmma_commit();
    wgmma_wait<0>();
    fence_split<NP>(dv, p_hi, p_lo);
    fence_split<NP>(dk, ds_hi, ds_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  const size_t off = (size_t)bh * p.seq * D;
  store_tile<D>(static_cast<__nv_bfloat16*>(p.dk) + off, dk, k0, w, lane);
  store_tile<D>(static_cast<__nv_bfloat16*>(p.dv) + off, dv, k0, w, lane);
}

constexpr int kErrTensorMap = -5;  // a tensor map could not be encoded (or a pointer is unaligned)

enum Which { kFwd = 0, kDq = 1, kDkdv = 2 };

// opts `kernel` into `smem` bytes of dynamic shared memory and launches it
template <typename Kernel, typename... Args>
int launch_tc_kernel(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream, const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kTcThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// the tensor-core kernels, on the tile maps of q, k, v and (for the backward
// sweeps) dO
template <int D>
int launch_tc(Which which, const BsaParams& p, int bh, cudaStream_t stream) {
  const void* src[4] = {p.q, p.k, p.v, p.dout};
  CUtensorMap m[4];
  for (int i = 0; i < (which == kFwd ? 3 : 4); ++i)
    if (!hopper::make_tile_map<D>(&m[i], src[i], p.seq, bh, kTcRows)) return kErrTensorMap;
  const dim3 by_query(p.seq / kTcRows, bh);
  if (which == kFwd) return launch_tc_kernel(bsa_fwd_tc_kernel<D>, fwd_tc_smem<D>(), by_query, stream, m[0], m[1], m[2], p);
  if (which == kDq)
    return launch_tc_kernel(bsa_bwd_dq_tc_kernel<D>, dq_tc_smem<D>(), by_query, stream, m[0], m[1], m[2], m[3], p);
  // bh on x: the blocks of rank 0 (the longest key tiles) of every bh come first
  return launch_tc_kernel(bsa_bwd_dkdv_tc_kernel<D>, dkdv_tc_smem<D>(), dim3(bh, p.seq / kTcRows), stream, m[0], m[1],
                          m[2], m[3], p);
}

template <int D, int TQ> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * TQ * (D + 1) + TQ * (TQ + 1));
}
template <int D, int TQ> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * TQ * (D + 1) + TQ * (TQ + 1) + 2 * TQ);
}
template <int D, int TQ> constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * TQ * (D + 1) + 2 * TQ * (TQ + 1) + 2 * TQ);
}

template <typename T, int D, int TQ>
int launch_typed(Which which, const BsaParams& p, int bh, cudaStream_t stream) {
  void (*kernel)(BsaParams);
  size_t smem;
  if (which == kFwd) {
    kernel = bsa_fwd_kernel<T, D, TQ>;
    smem = fwd_smem<D, TQ>();
  } else if (which == kDq) {
    kernel = bsa_bwd_dq_kernel<T, D, TQ>;
    smem = dq_smem<D, TQ>();
  } else {
    kernel = bsa_bwd_dkdv_kernel<T, D, TQ>;
    smem = dkdv_smem<D, TQ>();
  }
  // above 48 KB a block's dynamic shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.seq / TQ, bh), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// bf16 at block 64 or 128 runs the tensor-core kernels; every other case runs
// the scalar kernels, whose tile is min(block, 64) rows (a 128 block is
// walked as two 64-row tiles). Decided before launch, never by a retry.
// `scalar` launches the scalar kernel at bf16 too: the route the tensor-core
// one replaced, kept so that a run can time the two side by side.
template <typename T, int D>
int launch_block(Which which, const BsaParams& p, int bh, cudaStream_t stream, bool scalar) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!scalar && (p.block == 64 || p.block == 128)) return launch_tc<D>(which, p, bh, stream);
  }
  switch (p.block) {
    case 16: return launch_typed<T, D, 16>(which, p, bh, stream);
    case 32: return launch_typed<T, D, 32>(which, p, bh, stream);
    case 64:
    case 128: return launch_typed<T, D, 64>(which, p, bh, stream);
    default: return -3;
  }
}

template <typename T>
int launch_dim(Which which, const BsaParams& p, int head_dim, int bh, cudaStream_t stream, bool scalar) {
  switch (head_dim) {
    case 64: return launch_block<T, 64>(which, p, bh, stream, scalar);
    case 96: return launch_block<T, 96>(which, p, bh, stream, scalar);
    case 128: return launch_block<T, 128>(which, p, bh, stream, scalar);
    default: return -1;
  }
}

int launch(Which which, const BsaParams& p, int dtype, int head_dim, int bh, void* stream, bool scalar) {
  if (p.block <= 0 || p.seq % p.block != 0) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(which, p, head_dim, bh, s, scalar);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(which, p, head_dim, bh, s, scalar);
  return -2;
}

BsaParams make_params(const void* q, const void* k, const void* v, const void* bias, const void* lut,
                      const void* nnz, int heads, int seq, int block, int max_nnz, float scale) {
  BsaParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.lut = static_cast<const int*>(lut);
  p.nnz = static_cast<const int*>(nnz);
  p.heads = heads;
  p.seq = seq;
  p.block = block;
  p.max_nnz = max_nnz;
  p.scale = scale;
  return p;
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 fp32, 1 bf16. `scalar`
// nonzero launches the scalar kernel whatever the dtype and block (to time the
// bf16 route that a tensor-core kernel replaced; the model never asks for it).
// Each function launches on `stream` and returns cudaGetLastError() (0 =
// launched), -1 for an unsupported head_dim, -2 for an unsupported dtype, -3
// for an unsupported block, -4 for a sequence that is not a multiple of the
// block, -5 when a bf16 operand's TMA tensor map cannot be made (unaligned
// pointer, or the driver has no cuTensorMapEncodeTiled).
extern "C" {

int ds_bsa_fwd(const void* q, const void* k, const void* v, const void* bias, const void* cols,
               const void* nnz, void* out, void* lse, int dtype, int head_dim, int bh, int heads, int seq,
               int block, int max_nnz, float scale, int scalar, void* stream) {
  BsaParams p = make_params(q, k, v, bias, cols, nnz, heads, seq, block, max_nnz, scale);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  return launch(kFwd, p, dtype, head_dim, bh, stream, scalar != 0);
}

int ds_bsa_bwd_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
                  const void* lse, const void* delta, const void* cols, const void* nnz, void* dq, int dtype,
                  int head_dim, int bh, int heads, int seq, int block, int max_nnz, float scale, int scalar,
                  void* stream) {
  BsaParams p = make_params(q, k, v, bias, cols, nnz, heads, seq, block, max_nnz, scale);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  return launch(kDq, p, dtype, head_dim, bh, stream, scalar != 0);
}

// `order`: the (H, nb) key blocks of each head by descending nnz_t, the
// order in which the tensor-core sweep takes its key tiles
int ds_bsa_bwd_dkdv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
                    const void* lse, const void* delta, const void* rows_t, const void* nnz_t, const void* order,
                    void* dk, void* dv, int dtype, int head_dim, int bh, int heads, int seq, int block,
                    int max_nnz_t, float scale, int scalar, void* stream) {
  BsaParams p = make_params(q, k, v, bias, rows_t, nnz_t, heads, seq, block, max_nnz_t, scale);
  p.order = static_cast<const int*>(order);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return launch(kDkdv, p, dtype, head_dim, bh, stream, scalar != 0);
}

}  // extern "C"
