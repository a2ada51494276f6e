// Flash attention for Hopper (sm_90a): forward, dK/dV sweep and dQ sweep.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/transformer/flash_attention.py:
//   flash_fwd_tc_kernel (bf16, fp16), flash_fwd_kernel (fp32)
//                          <- _fwd_kernel       (launched by _flash_fwd)
//   flash_bwd_dkdv_tc_kernel (bf16, fp16), flash_bwd_dkdv_kernel (fp32)
//                          <- _bwd_dkdv_kernel  (launched by _flash_bwd)
//   flash_bwd_dq_tc_kernel (bf16, fp16), flash_bwd_dq_kernel (fp32)
//                          <- _bwd_dq_kernel    (launched by _flash_bwd)
//
// Each kernel computes the whole function of its Pallas counterpart: scaled
// q.k^T scores, an optional additive bias ('key': one (B, S_k) row per batch,
// broadcast over heads and query rows; 'full': one (S_q, S_k) matrix per
// batch*head), the top-left causal mask (q_idx >= k_idx, masked scores set to
// -1e30), an online softmax with fp32 running max and denominator, and the
// murmur3-finalizer dropout hash over the global (bh, q, k) position, bit for
// bit the same uint32 arithmetic as _dropout_keep. Under sequence parallelism
// (Ulysses) a launch holds `heads` of `total_heads` heads, from `head_offset`
// on: the hash indexes b * total_heads + head_offset + h, so the local heads
// draw the whole model's masks (offset 0 of `heads` heads: b * heads + h).
//
// Layout: q, k, v, out, dout, dq, dk, dv are (B*H, S, D) contiguous in the
// storage dtype (bf16, fp16 or fp32); lse and delta are compact (B*H, S_q)
// fp32. The dropout seed is one int32 in device memory, drawn there by the
// caller and read by the kernel, so that a step never waits on the host for
// it.
//
// Routing, by dtype before launch: bf16 and fp16 run the forward and both backward
// sweeps on the tensor cores (flash_fwd_tc_kernel, flash_bwd_dkdv_tc_kernel,
// flash_bwd_dq_tc_kernel); fp32 runs the three scalar kernels,
// whose fp32 products are what the Pallas kernels compute at fp32 (TF32
// tensor cores would not be). At bf16 and fp16, p and dS enter their second
// products rounded to the storage dtype, as the Pallas kernels round them (p_acc.astype(v.dtype),
// p_drop.astype(do.dtype), ds.astype(q.dtype), ds.astype(k.dtype)).
//
// Blocks run in parallel with no order, so the sequential grid axis of the
// Pallas kernels becomes a loop inside one thread block, and the two
// backward sweeps write disjoint outputs, with no atomics.
//
// Tensor-core kernels (bf16 and fp16, one instantiation each, sm_90a). Bound at the GPT-2 slice shape
// (8, 16, 1024, 64) causal: the forward by bytes (0.020 ms), the dK/dV and
// dQ sweeps by operations (0.035 and 0.026 ms); all sit well above it,
// held back by the element-wise softmax work between the products, not by
// the products or the loads. The design:
//   - one block per (bh, 128-row tile) with two consumer warpgroups of 64
//     rows and one producer warp; the forward loops over 128-row k/v tiles,
//     the dQ sweep (one block per 128 q rows) over 64-row k/v tiles, the
//     dK/dV sweep (one block per 128 k rows) over 64-row q/dO tiles;
//   - TMA loads (3-D tensor maps over (bh, S, D), 128-byte swizzle, rows and
//     columns past the tensor arrive as zeros) into a 2-stage ring signalled
//     by mbarriers; the producer loads while the consumers compute; the
//     dK/dV producer also stages each q tile's lse and delta;
//   - wgmma m64n64k16 bf16 (fp16) with fp32 accumulators: S = Q.K^T (forward, dQ),
//     dP = dO.V^T (dQ) and S^T = K.Q^T, dP^T = V.dO^T (dK/dV) with both
//     operands in shared memory; p (forward), dS (dQ) and p_drop^T, dS^T
//     (dK/dV) go from the fp32 accumulator registers pairwise to bf16 (fp16) and
//     are the register A operand of O += P.V, dQ += dS.K, dV += p_drop^T.dO,
//     dK += dS^T.Q, whose B operands (V, K, dO, Q) are read MN-major from the
//     same swizzled tiles: nothing is transposed and P never goes to shared
//     memory;
//   - the row statistics are quad shuffles on the accumulator layout; every
//     warp-uniform branch (bias kind, a tile crossing the diagonal, a ragged
//     edge, dropout) sits outside the unrolled element loops: a branch per
//     element doubled both kernels' times;
//   - causal: tiles wholly above the diagonal are skipped, the forward's and
//     the dQ sweep's longest q tiles and the dK/dV sweep's longest k tiles
//     start first;
//   - head_dim 96 is padded to two 64-column panels with zeros.
//
// Scalar kernels (fp32; the bf16 dQ sweep only on request, for timing): one
// block per (bh, 64-row tile), 64x64 tiles staged in shared memory as fp32 (row pitch D+1 so that
// the 16 threads of a half-warp reading 16 different rows hit 16 different
// banks), 256 threads as a 16x16 grid each owning a 4x4 patch of the score
// tile and a 4 x D/16 patch of the fp32 accumulators, row reductions as
// 16-lane shuffles, scalar fp32 FMAs. Ragged edges (any S) are masked in the
// kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;       // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // 16 x 16 thread grid
constexpr int kScorePitch = kTile + 1;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;    // nullptr, (B, S_k) or (B*H, S_q, S_k), fp32
  const void* dout;
  const float* lse;     // (B*H, S_q)
  const float* delta;   // (B*H, S_q)
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int heads;
  int head_offset;      // the dropout hash's first head and head count
  int total_heads;
  int s_q;
  int s_k;
  float scale;
  int causal;
  int bias_kind;        // 0 none, 1 key, 2 full
  int use_dropout;
  uint32_t drop_threshold;
  float drop_inv_keep;  // 1 / (1 - rate)
  const int32_t* seed;  // dropout seed: one device int32, read by the kernel
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// the dropout seed of batch*head bh, read once by each thread that needs
// it (the wrapper passes the device int32 that the caller drew, so no launch
// waits on the host for it) and mixed with the global batch*head index
__device__ __forceinline__ uint32_t load_seed(const FlashParams& p, int bh) {
  if (!p.use_dropout) return 0u;
  const uint32_t g = (uint32_t)((bh / p.heads) * p.total_heads + p.head_offset + bh % p.heads);
  return static_cast<uint32_t>(__ldg(p.seed)) + 0x9E3779B9u * g;
}

// _dropout_keep: the keep decision for position (qi, kj) of the batch*head
// whose seed load_seed gave
__device__ __forceinline__ bool dropout_keep(const FlashParams& p, uint32_t seed, int qi, int kj) {
  uint32_t rh = mix32(seed ^ (uint32_t)qi);
  uint32_t h = mix32(rh ^ (0x27D4EB2Fu * (uint32_t)kj));
  return h >= p.drop_threshold;
}

// rows [row0, row0 + 64) of a (rows, D) matrix into a (64, D+1) fp32 tile;
// rows past the end are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int rows, int tid) {
  for (int idx = tid; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < rows ? to_float(src[(size_t)gr * D + c]) : 0.f;
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

// scaled, biased, causally masked score of one in-range (qi, kj) pair
__device__ __forceinline__ float score(const FlashParams& p, float dot, int bh, int qi, int kj) {
  float x = dot * p.scale;
  if (p.bias_kind == 1) {
    x += p.bias[(size_t)(bh / p.heads) * p.s_k + kj];
  } else if (p.bias_kind == 2) {
    x += p.bias[((size_t)bh * p.s_q + qi) * p.s_k + kj];
  }
  if (p.causal && qi < kj) x = kNegInf;
  return x;
}

// s[i][j] = sum_d A[ty+16i][d] * B[tx+16j][d] over two (64, D+1) tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][jj] += sum_c P[row_i][c] * X[c][tx+16jj], P a (64, 65) tile read at
// rows ty+16i (transposed: P[c][ty+16i] when transpose_p), X a (64, D+1) tile
template <int D, bool kTransposeP>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16], const float* P, const float* X, int ty,
                                         int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = kTransposeP ? P[c * kScorePitch + ty + 16 * i] : P[(ty + 16 * i) * kScorePitch + c];
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      const float x = X[c * (D + 1) + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(a[i], x, acc[i][jj]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ps = Vs + kTile * (D + 1);
  constexpr int NJ = D / 16;

  const int n_q_tiles = gridDim.x;
  // causal: the longest rows (last q tiles) start first
  const int qt = p.causal ? n_q_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * kTile;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* q = static_cast<const T*>(p.q) + (size_t)bh * p.s_q * D;
  const T* k = static_cast<const T*>(p.k) + (size_t)bh * p.s_k * D;
  const T* v = static_cast<const T*>(p.v) + (size_t)bh * p.s_k * D;

  load_tile<T, D>(Qs, q, q0, p.s_q, tid);
  const uint32_t seed = load_seed(p, bh);

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  int n_k_tiles = (p.s_k + kTile - 1) / kTile;
  if (p.causal) n_k_tiles = min(n_k_tiles, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k, k0, p.s_k, tid);
    load_tile<T, D>(Vs, v, k0, p.s_k, tid);
    __syncthreads();

    float s[4][4];
    tile_dot<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      const int qc = min(qi, p.s_q - 1);  // padding rows read an in-range bias row
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        // columns past S_k take no part in the softmax
        s[i][j] = kj < p.s_k ? score(p, s[i][j], bh, qc, kj) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float pr = expf(s[i][j] - m_new);
        row_sum += pr;
        // the denominator takes the undropped p; dropout scales only the
        // value accumulation
        float pa = pr;
        if (p.use_dropout) pa = dropout_keep(p, seed, qi, kj) ? pr * p.drop_inv_keep : 0.f;
        Ps[(ty + 16 * i) * kScorePitch + tx + 16 * j] = pa;
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    tile_acc<D, false>(acc, Ps, Vs, ty, tx);
  }

  T* out = static_cast<T*>(p.out) + (size_t)bh * p.s_q * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.s_q) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) out[(size_t)qi * D + tx + 16 * jj] = from_float<T>(acc[i][jj] / l_safe);
    if (tx == 0) p.lse_out[(size_t)bh * p.s_q + qi] = m[i] + logf(l_safe);
  }
}

// p = exp(s - lse) and ds = p * (dp' - delta) * scale for one 64x64 tile,
// where dp' is dO.v^T with the dropout keep mask and 1/(1-rate) applied;
// writes p (dropped and rescaled) to Pd when Pd is not null and ds to Ds
template <typename T, int D>
__device__ __forceinline__ void bwd_tile(const FlashParams& p, uint32_t seed, const float* Qs, const float* Ks,
                                         const float* Vs, const float* dOs, const float* lse_s,
                                         const float* delta_s, float* Pd, float* Ds, int bh, int q0,
                                         int k0, int ty, int tx) {
  float s[4][4], dp[4][4];
  tile_dot<D>(s, Qs, Ks, ty, tx);
  tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kj = k0 + c;
      float pd = 0.f, ds = 0.f;
      if (qi < p.s_q && kj < p.s_k) {
        const float pr = expf(score(p, s[i][j], bh, qi, kj) - lse_s[r]);
        float dpv = dp[i][j];
        pd = pr;
        if (p.use_dropout) {
          const bool keep = dropout_keep(p, seed, qi, kj);
          pd = keep ? pr * p.drop_inv_keep : 0.f;
          dpv = keep ? dpv * p.drop_inv_keep : 0.f;
        }
        ds = pr * (dpv - delta_s[r]) * p.scale;
      }
      // both enter their second product in the storage dtype, as the
      // Pallas kernels' p_drop.astype(do.dtype) / ds.astype(q.dtype)
      if (Pd != nullptr) Pd[r * kScorePitch + c] = to_float(from_float<T>(pd));
      Ds[r * kScorePitch + c] = to_float(from_float<T>(ds));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(FlashParams p) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* dOs = Qs + kTile * (D + 1);
  float* Ps = dOs + kTile * (D + 1);
  float* Ds = Ps + kTile * kScorePitch;
  float* lse_s = Ds + kTile * kScorePitch;
  float* delta_s = lse_s + kTile;
  constexpr int NJ = D / 16;

  const int kt = blockIdx.x;
  const int k0 = kt * kTile;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_off = (size_t)bh * p.s_q * D, k_off = (size_t)bh * p.s_k * D;
  const T* q = static_cast<const T*>(p.q) + q_off;
  const T* dout = static_cast<const T*>(p.dout) + q_off;
  const float* lse = p.lse + (size_t)bh * p.s_q;
  const float* delta = p.delta + (size_t)bh * p.s_q;

  load_tile<T, D>(Ks, static_cast<const T*>(p.k) + k_off, k0, p.s_k, tid);
  load_tile<T, D>(Vs, static_cast<const T*>(p.v) + k_off, k0, p.s_k, tid);
  const uint32_t seed = load_seed(p, bh);

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  const int n_q_tiles = (p.s_q + kTile - 1) / kTile;
  // causal: q tiles wholly above this k tile see none of it
  for (int qt = p.causal ? kt : 0; qt < n_q_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(Qs, q, q0, p.s_q, tid);
    load_tile<T, D>(dOs, dout, q0, p.s_q, tid);
    if (tid < kTile) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < p.s_q ? lse[qi] : 0.f;
      delta_s[tid] = qi < p.s_q ? delta[qi] : 0.f;
    }
    __syncthreads();
    bwd_tile<T, D>(p, seed, Qs, Ks, Vs, dOs, lse_s, delta_s, Ps, Ds, bh, q0, k0, ty, tx);
    __syncthreads();
    // dv += p_drop^T . dO ; dk += ds^T . q  (rows of dk/dv are k positions)
    tile_acc<D, true>(dv, Ps, dOs, ty, tx);
    tile_acc<D, true>(dk, Ds, Qs, ty, tx);
  }

  T* dk_out = static_cast<T*>(p.dk) + k_off;
  T* dv_out = static_cast<T*>(p.dv) + k_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= p.s_k) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      dk_out[(size_t)kj * D + tx + 16 * jj] = from_float<T>(dk[i][jj]);
      dv_out[(size_t)kj * D + tx + 16 * jj] = from_float<T>(dv[i][jj]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(FlashParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * (D + 1);
  float* Ks = dOs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ds = Vs + kTile * (D + 1);
  float* lse_s = Ds + kTile * kScorePitch;
  float* delta_s = lse_s + kTile;
  constexpr int NJ = D / 16;

  const int n_q_tiles = gridDim.x;
  const int qt = p.causal ? n_q_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * kTile;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_off = (size_t)bh * p.s_q * D, k_off = (size_t)bh * p.s_k * D;
  const T* k = static_cast<const T*>(p.k) + k_off;
  const T* v = static_cast<const T*>(p.v) + k_off;

  load_tile<T, D>(Qs, static_cast<const T*>(p.q) + q_off, q0, p.s_q, tid);
  load_tile<T, D>(dOs, static_cast<const T*>(p.dout) + q_off, q0, p.s_q, tid);
  const uint32_t seed = load_seed(p, bh);
  if (tid < kTile) {
    const int qi = q0 + tid;
    lse_s[tid] = qi < p.s_q ? p.lse[(size_t)bh * p.s_q + qi] : 0.f;
    delta_s[tid] = qi < p.s_q ? p.delta[(size_t)bh * p.s_q + qi] : 0.f;
  }

  float dq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dq[i][jj] = 0.f;

  int n_k_tiles = (p.s_k + kTile - 1) / kTile;
  if (p.causal) n_k_tiles = min(n_k_tiles, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, k, k0, p.s_k, tid);
    load_tile<T, D>(Vs, v, k0, p.s_k, tid);
    __syncthreads();
    bwd_tile<T, D>(p, seed, Qs, Ks, Vs, dOs, lse_s, delta_s, nullptr, Ds, bh, q0, k0, ty, tx);
    __syncthreads();
    tile_acc<D, false>(dq, Ds, Ks, ty, tx);  // dq += ds . k
  }

  T* dq_out = static_cast<T*>(p.dq) + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.s_q) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dq_out[(size_t)qi * D + tx + 16 * jj] = from_float<T>(dq[i][jj]);
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernels (B1 forward, B2 dK/dV, B3 dQ) at bf16 and fp16: wgmma +
// TMA + mbarriers
// ---------------------------------------------------------------------------
constexpr int kTcConsumerWarps = 8;                      // two consumer warpgroups
constexpr int kTcThreads = 32 * kTcConsumerWarps + 32;   // + one producer warp
constexpr int kTcStages = 2;                             // ring of q or k/v tiles
constexpr int kFwdRowsQ = 128;                           // fwd: q rows of a block
constexpr int kFwdRowsK = 128;                           // fwd: k rows of a stage
constexpr int kBwdRowsK = 128;                           // dK/dV: k rows of a block
constexpr int kBwdRowsQ = 64;                            // dK/dV: q rows of a stage
constexpr int kDqRowsQ = 128;                            // dQ: q rows of a block
constexpr int kDqRowsK = 64;                             // dQ: k rows of a stage
// bytes of a swizzled tile of `rows` rows at head_dim D (zero-padded to whole panels)
template <int D> __host__ __device__ constexpr uint32_t tc_tile_bytes(int rows) {
  return static_cast<uint32_t>(hopper::tc_panels<D>() * rows * hopper::kRowBytes);
}

template <int D> constexpr size_t fwd_tc_smem() {
  // Q, K/V ring, 5 mbarriers, 1024 bytes to align the tiles
  return tc_tile_bytes<D>(kFwdRowsQ) + 2 * kTcStages * tc_tile_bytes<D>(kFwdRowsK) + 64 + 1024;
}
template <int D> constexpr size_t dkdv_tc_smem() {
  // K, V, Q/dO ring with lse and delta rows, 5 mbarriers, alignment
  return 2 * tc_tile_bytes<D>(kBwdRowsK) +
         kTcStages * (2 * tc_tile_bytes<D>(kBwdRowsQ) + 2 * kBwdRowsQ * sizeof(float)) + 64 + 1024;
}
template <int D> constexpr size_t dq_tc_smem() {
  // Q, dO, K/V ring, 5 mbarriers, alignment
  return 2 * tc_tile_bytes<D>(kDqRowsQ) + 2 * kTcStages * tc_tile_bytes<D>(kDqRowsK) + 64 + 1024;
}

// _dropout_keep split in its row and column halves: the row hash of qi (under
// load_seed's batch*head seed) is computed once per row, the column mix per
// element
__device__ __forceinline__ uint32_t dropout_row_hash(uint32_t seed, int qi) {
  return mix32(seed ^ (uint32_t)qi);
}
__device__ __forceinline__ bool dropout_keep_row(const FlashParams& p, uint32_t row_hash, int kj) {
  return mix32(row_hash ^ (0x27D4EB2Fu * (uint32_t)kj)) >= p.drop_threshold;
}

// The 2-byte element types of the tensor-core kernels: bf16 and fp16 take
// the same tiles, swizzle and products, and differ in the wgmma form, the
// rounding of fp32 pairs and the TMA element type.
template <typename T> struct TcElem;
template <> struct TcElem<__nv_bfloat16> {
  static constexpr bool kHalf = false;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct TcElem<__half> {
  static constexpr bool kHalf = true;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// The 4 A-operand registers of k-step `c` (16 columns) taken from a 64-column
// fp32 accumulator, each pair rounded to the element type (see
// hopper::wgmma_rs).
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[32], int c) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = TcElem<T>::kHalf ? hopper::pack_f16(x[8 * c + 2 * r], x[8 * c + 2 * r + 1])
                            : hopper::pack_bf16(x[8 * c + 2 * r], x[8 * c + 2 * r + 1]);
}

// two adjacent output elements from fp32, round to nearest even
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void store_pair(__half* dst, float lo, float hi) {
  *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(lo, hi);
}

// B1. One block per (bh, 128-row q tile): warps 0-7 are two consumer
// warpgroups of 64 q rows each, warp 8 the producer. The producer loads the
// q tile once and the k/v tiles (128 rows) into a 2-stage ring by TMA; each
// consumer warpgroup computes S = Q.K^T by wgmma (both operands in shared
// memory), the masked online softmax on S's accumulator registers, and
// O += P.V with P converted to the element type in registers as the A operand and V read
// MN-major from shared memory, then frees the stage.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, FlashParams p) {
  using namespace hopper;
  constexpr int NP = tc_panels<D>();  // output / V panels of 64 columns
  constexpr int KD = D / 16;          // k-steps of Q.K^T
  constexpr uint32_t kQBytes = tc_tile_bytes<D>(kFwdRowsQ);
  constexpr uint32_t kKBytes = tc_tile_bytes<D>(kFwdRowsK);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = sQ + kQBytes;  // stage s: K at sKV + 2 s kKBytes, V after it
  const uint32_t bars = sKV + 2 * kTcStages * kKBytes;
  const uint32_t bar_q = bars, bar_full = bars + 8, bar_empty = bars + 8 + 8 * kTcStages;

  const int bh = blockIdx.x;
  // causal: the longest rows (last q tiles) start first
  const int qt = p.causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kFwdRowsQ;
  int n_k_tiles = (p.s_k + kFwdRowsK - 1) / kFwdRowsK;
  if (p.causal) n_k_tiles = min(n_k_tiles, (q0 + kFwdRowsQ - 1) / kFwdRowsK + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTcConsumerWarps) {  // producer
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, kQBytes);
      for (int pp = 0; pp < NP; ++pp)
        tma_load_3d(sQ + pp * kFwdRowsQ * kRowBytes, &tm_q, bar_q, pp * kPanelCols, q0, bh);
      for (int it = 0; it < n_k_tiles; ++it) {
        const int s = it % kTcStages;
        if (it >= kTcStages) mbar_wait(bar_empty + 8 * s, (it / kTcStages - 1) & 1);
        const uint32_t sK = sKV + 2 * s * kKBytes, sV = sK + kKBytes;
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kKBytes);
        for (int pp = 0; pp < NP; ++pp) {
          tma_load_3d(sK + pp * kFwdRowsK * kRowBytes, &tm_k, bar_full + 8 * s, pp * kPanelCols,
                      it * kFwdRowsK, bh);
          tma_load_3d(sV + pp * kFwdRowsK * kRowBytes, &tm_v, bar_full + 8 * s, pp * kPanelCols,
                      it * kFwdRowsK, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread holds
  // rows row[h] = q0 + 64 wg + 16 w + lane/4 + 8h and, in each 8-column
  // group j of an accumulator, columns 8j + c_off + {0, 1}
  const int wg = warp / 4, w = warp % 4;
  const uint32_t seed = load_seed(p, bh);
  const int c_off = 2 * (lane % 4);
  const int wg_q0 = q0 + 64 * wg;
  int row[2];
  uint32_t row_hash[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = wg_q0 + 16 * w + lane / 4 + 8 * h;
    row_hash[h] = p.use_dropout ? dropout_row_hash(seed, row[h]) : 0u;
  }
  const float* key_bias = p.bias_kind == 1 ? p.bias + (size_t)(bh / p.heads) * p.s_k : nullptr;

  float o[NP][32];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pp][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_k_tiles; ++it) {
    const int s = it % kTcStages;
    const uint32_t sK = sKV + 2 * s * kKBytes, sV = sK + kKBytes;
    mbar_wait(bar_full + 8 * s, (it / kTcStages) & 1);

    // S = Q . K^T: two 64-column halves of the 128-row k tile
    float sc[2][32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const uint32_t col = (kd % 4) * 32;  // 16 elements further along the swizzled row
      const uint64_t da = desc_k_major(sQ + (kd / 4) * kFwdRowsQ * kRowBytes + wg * 64 * kRowBytes + col);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint64_t db = desc_k_major(sK + (kd / 4) * kFwdRowsK * kRowBytes + n * 64 * kRowBytes + col);
        wgmma_ss<TcElem<T>::kHalf>(sc[n], da, db, kd > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc[0]);
    fence_regs(sc[1]);

    // scale, bias, masks; then the running max. Every branch is uniform
    // over the warp and sits outside the element loops: a branch per element
    // would cut the unrolled loop into short blocks with no overlap between
    // elements (measured: it doubled this kernel's time).
    const int k0 = it * kFwdRowsK;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[n][i] *= p.scale;
    if (p.bias_kind == 1) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[n][i] += key_bias[min(k0 + 64 * n + tc_col(i, c_off), p.s_k - 1)];
    } else if (p.bias_kind == 2) {
      const float* rows_bias[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) rows_bias[h] = p.bias + ((size_t)bh * p.s_q + min(row[h], p.s_q - 1)) * p.s_k;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[n][i] += rows_bias[(i >> 1) & 1][min(k0 + 64 * n + tc_col(i, c_off), p.s_k - 1)];
    }
    if (p.causal && k0 + kFwdRowsK - 1 > wg_q0) {  // a tile that crosses the diagonal
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (row[(i >> 1) & 1] < k0 + 64 * n + tc_col(i, c_off)) sc[n][i] = kNegInf;
    }
    if (k0 + kFwdRowsK > p.s_k) {  // columns past S_k take no part in the softmax
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + 64 * n + tc_col(i, c_off) >= p.s_k) sc[n][i] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[n][i]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = exp2f((m[h] - mx[h]) * kLog2e);
      m[h] = mx[h];
    }

    // p = exp(s - m): the undropped p feeds the denominator; p_acc (dropout
    // applied) goes to the element type as the A operand of P.V
    uint32_t pa[8][4];
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[n][i] = exp2f((sc[n][i] - m[(i >> 1) & 1]) * kLog2e);
        row_sum[(i >> 1) & 1] += sc[n][i];
      }
    if (p.use_dropout) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[n][i] = dropout_keep_row(p, row_hash[(i >> 1) & 1], k0 + 64 * n + tc_col(i, c_off))
                         ? sc[n][i] * p.drop_inv_keep
                         : 0.f;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_to_a<T>(pa[4 * n + c], sc[n], c);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + row_sum[h];  // per-thread share of the row
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pp][i] *= alpha[(i >> 1) & 1];

    // O += P . V, V MN-major: k-step kk reads k rows 16 kk .. 16 kk + 15
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdRowsK / 16; ++kk)
#pragma unroll
      for (int pp = 0; pp < NP; ++pp)
        wgmma_rs<TcElem<T>::kHalf>(o[pp], pa[kk], desc_mn_major(sV + pp * kFwdRowsK * kRowBytes + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) fence_regs(o[pp]);
#pragma unroll
    for (int kk = 0; kk < kFwdRowsK / 16; ++kk) fence_regs(pa[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  T* out = static_cast<T*>(p.out) + (size_t)bh * p.s_q * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]);
    if (row[h] >= p.s_q) continue;
    const float l_safe = lt == 0.f ? 1.f : lt;
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * pp + 8 * j + c_off;
        if (col < D) {
          store_pair(out + (size_t)row[h] * D + col, o[pp][4 * j + 2 * h] / l_safe,
                     o[pp][4 * j + 2 * h + 1] / l_safe);
        }
      }
    if (lane % 4 == 0) p.lse_out[(size_t)bh * p.s_q + row[h]] = m[h] + logf(l_safe);
  }
}

// B2. One block per (bh, 128-row k tile): warps 0-7 are two consumer
// warpgroups of 64 k rows each, warp 8 the producer. The producer loads K
// and V once and the q / dO tiles (64 rows, with their lse and delta) into a
// 2-stage ring. Each consumer warpgroup computes the transposed products
// S^T = K.Q^T and dP^T = V.dO^T by wgmma, p^T and dS^T on the accumulator
// registers, and dV += p_drop^T.dO, dK += dS^T.Q with both converted to the element type
// as register A operands and dO, Q read MN-major from shared memory. dK and
// dV stay in fp32 registers and have one writer each.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                             FlashParams p) {
  using namespace hopper;
  constexpr int NP = tc_panels<D>();
  constexpr int KD = D / 16;
  constexpr uint32_t kKBytes = tc_tile_bytes<D>(kBwdRowsK);
  constexpr uint32_t kQBytes = tc_tile_bytes<D>(kBwdRowsQ);
  constexpr uint32_t kStageBytes = 2 * kQBytes + 2 * kBwdRowsQ * sizeof(float);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = sK + kKBytes;
  const uint32_t sRing = sV + kKBytes;  // stage s: Q, dO, lse[64], delta[64]
  const uint32_t bars = sRing + kTcStages * kStageBytes;
  const uint32_t bar_kv = bars, bar_full = bars + 8, bar_empty = bars + 8 + 8 * kTcStages;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // causal: k tile 0 has the most q tiles and starts first
  const int k0 = kt * kBwdRowsK;
  const int n_q_tiles = (p.s_q + kBwdRowsQ - 1) / kBwdRowsQ;
  // causal: q tiles wholly above this k tile see none of it
  const int qt_first = p.causal ? k0 / kBwdRowsQ : 0;
  const int n_iter = max(n_q_tiles - qt_first, 0);
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
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * kKBytes);
      for (int pp = 0; pp < NP; ++pp) {
        tma_load_3d(sK + pp * kBwdRowsK * kRowBytes, &tm_k, bar_kv, pp * kPanelCols, k0, bh);
        tma_load_3d(sV + pp * kBwdRowsK * kRowBytes, &tm_v, bar_kv, pp * kPanelCols, k0, bh);
      }
    }
    const float* lse = p.lse + (size_t)bh * p.s_q;
    const float* delta = p.delta + (size_t)bh * p.s_q;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kTcStages;
      const int q0 = (qt_first + it) * kBwdRowsQ;
      if (it >= kTcStages) mbar_wait(bar_empty + 8 * s, (it / kTcStages - 1) & 1);
      const uint32_t sQ = sRing + s * kStageBytes, sDO = sQ + kQBytes;
      float* stats = reinterpret_cast<float*>(base_ptr + (sDO + kQBytes - base));
      for (int r = lane; r < kBwdRowsQ; r += 32) {
        const int qi = q0 + r;
        stats[r] = qi < p.s_q ? lse[qi] : 0.f;
        stats[kBwdRowsQ + r] = qi < p.s_q ? delta[qi] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kQBytes);
        for (int pp = 0; pp < NP; ++pp) {
          tma_load_3d(sQ + pp * kBwdRowsQ * kRowBytes, &tm_q, bar_full + 8 * s, pp * kPanelCols, q0, bh);
          tma_load_3d(sDO + pp * kBwdRowsQ * kRowBytes, &tm_do, bar_full + 8 * s, pp * kPanelCols, q0, bh);
        }
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  // consumer warpgroup wg owns k rows k0 + 64 wg .. + 63; this thread holds
  // rows kr[h] = k0 + 64 wg + 16 w + lane/4 + 8h and, in each 8-column group
  // j of an accumulator, q columns 8j + c_off + {0, 1}
  const int wg = warp / 4, w = warp % 4;
  const uint32_t seed = load_seed(p, bh);
  const int c_off = 2 * (lane % 4);
  int kr[2];
  float kbias[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kr[h] = k0 + 64 * wg + 16 * w + lane / 4 + 8 * h;
    if (p.bias_kind == 1) kbias[h] = p.bias[(size_t)(bh / p.heads) * p.s_k + min(kr[h], p.s_k - 1)];
  }

  float dk[NP][32], dv[NP][32];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[pp][i] = dv[pp][i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kTcStages;
    const int q0 = (qt_first + it) * kBwdRowsQ;
    const uint32_t sQ = sRing + s * kStageBytes, sDO = sQ + kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(base_ptr + (sDO + kQBytes - base));
    const float* delta_s = lse_s + kBwdRowsQ;
    mbar_wait(bar_full + 8 * s, (it / kTcStages) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T (k rows x 64 q columns)
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const uint32_t a_off = (kd / 4) * kBwdRowsK * kRowBytes + wg * 64 * kRowBytes + (kd % 4) * 32;
      const uint32_t b_off = (kd / 4) * kBwdRowsQ * kRowBytes + (kd % 4) * 32;
      wgmma_ss<TcElem<T>::kHalf>(st, desc_k_major(sK + a_off), desc_k_major(sQ + b_off), kd > 0);
      wgmma_ss<TcElem<T>::kHalf>(dpt, desc_k_major(sV + a_off), desc_k_major(sDO + b_off), kd > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // scores, masks, p, dropout and dS, each branch uniform over the warp
    // and outside the element loops (see the forward)
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] *= p.scale;
    if (p.bias_kind == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] += kbias[(i >> 1) & 1];
    } else if (p.bias_kind == 2) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        st[i] += p.bias[((size_t)bh * p.s_q + min(q0 + tc_col(i, c_off), p.s_q - 1)) * p.s_k +
                        min(kr[(i >> 1) & 1], p.s_k - 1)];
    }
    if (p.causal && q0 < k0 + 64 * wg + 63) {  // some q row above some k row
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (q0 + tc_col(i, c_off) < kr[(i >> 1) & 1]) st[i] = kNegInf;
    }
    // p = exp(s - lse) with expf of the difference, as the plain version
    // computes it (exp2f of a product with log2(e) adds ~1e-6 relative
    // error, which moves more dS values across a rounding boundary);
    // dS = p (dp - delta) scale, with dropout on p_drop and dp
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = expf(st[i] - lse_s[tc_col(i, c_off)]);
    if (p.use_dropout) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool keep = dropout_keep(p, seed, q0 + tc_col(i, c_off), kr[(i >> 1) & 1]);
        const float dpv = keep ? dpt[i] * p.drop_inv_keep : 0.f;
        dpt[i] = st[i] * (dpv - delta_s[tc_col(i, c_off)]) * p.scale;
        st[i] = keep ? st[i] * p.drop_inv_keep : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) dpt[i] = st[i] * (dpt[i] - delta_s[tc_col(i, c_off)]) * p.scale;
    }
    if (q0 + kBwdRowsQ > p.s_q) {  // padding rows of the last q tile
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (q0 + tc_col(i, c_off) >= p.s_q) st[i] = dpt[i] = 0.f;
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc_to_a<T>(pa[c], st, c);
      acc_to_a<T>(da[c], dpt, c);
    }

    // dV += p_drop^T . dO and dK += dS^T . Q, dO and Q MN-major: k-step kk
    // reads q rows 16 kk .. 16 kk + 15
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdRowsQ / 16; ++kk)
#pragma unroll
      for (int pp = 0; pp < NP; ++pp) {
        const uint32_t off = pp * kBwdRowsQ * kRowBytes + kk * 16 * kRowBytes;
        wgmma_rs<TcElem<T>::kHalf>(dv[pp], pa[kk], desc_mn_major(sDO + off));
        wgmma_rs<TcElem<T>::kHalf>(dk[pp], da[kk], desc_mn_major(sQ + off));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      fence_regs(dk[pp]);
      fence_regs(dv[pp]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  T* dk_out = static_cast<T*>(p.dk) + (size_t)bh * p.s_k * D;
  T* dv_out = static_cast<T*>(p.dv) + (size_t)bh * p.s_k * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kr[h] >= p.s_k) continue;
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * pp + 8 * j + c_off;
        if (col < D) {
          const size_t at = (size_t)kr[h] * D + col;
          store_pair(dk_out + at, dk[pp][4 * j + 2 * h], dk[pp][4 * j + 2 * h + 1]);
          store_pair(dv_out + at, dv[pp][4 * j + 2 * h], dv[pp][4 * j + 2 * h + 1]);
        }
      }
  }
}

// B3. One block per (bh, 128-row q tile): warps 0-7 are two consumer
// warpgroups of 64 q rows each, warp 8 the producer. The producer loads the
// Q and dO tiles once and the k/v tiles (64 rows) into a 2-stage ring by
// TMA. Each consumer warpgroup computes S = Q.K^T and dP = dO.V^T by wgmma
// (both operands in shared memory, K-major as stored), p and dS on the
// accumulator registers, and dQ += dS.K with dS rounded pairwise to the element type as
// the register A operand and K read MN-major from the same swizzled tile.
// dQ stays in fp32 registers and has one writer. 64-row k tiles keep the
// S, dP and dQ accumulators (64 + 64 + D/2 fp32 registers a thread) inside
// the register budget of 288 threads at one block per SM.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                           FlashParams p) {
  using namespace hopper;
  constexpr int NP = tc_panels<D>();
  constexpr int KD = D / 16;
  constexpr uint32_t kQBytes = tc_tile_bytes<D>(kDqRowsQ);
  constexpr uint32_t kKBytes = tc_tile_bytes<D>(kDqRowsK);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = sQ + kQBytes;
  const uint32_t sKV = sDO + kQBytes;  // stage s: K at sKV + 2 s kKBytes, V after it
  const uint32_t bars = sKV + 2 * kTcStages * kKBytes;
  const uint32_t bar_q = bars, bar_full = bars + 8, bar_empty = bars + 8 + 8 * kTcStages;

  const int bh = blockIdx.x;
  // causal: the longest rows (last q tiles) start first
  const int qt = p.causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kDqRowsQ;
  int n_k_tiles = (p.s_k + kDqRowsK - 1) / kDqRowsK;
  // causal: k tiles wholly right of the diagonal see no row of this block
  if (p.causal) n_k_tiles = min(n_k_tiles, (q0 + kDqRowsQ - 1) / kDqRowsK + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTcConsumerWarps) {  // producer
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * kQBytes);
      for (int pp = 0; pp < NP; ++pp) {
        tma_load_3d(sQ + pp * kDqRowsQ * kRowBytes, &tm_q, bar_q, pp * kPanelCols, q0, bh);
        tma_load_3d(sDO + pp * kDqRowsQ * kRowBytes, &tm_do, bar_q, pp * kPanelCols, q0, bh);
      }
      for (int it = 0; it < n_k_tiles; ++it) {
        const int s = it % kTcStages;
        if (it >= kTcStages) mbar_wait(bar_empty + 8 * s, (it / kTcStages - 1) & 1);
        const uint32_t sK = sKV + 2 * s * kKBytes, sV = sK + kKBytes;
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kKBytes);
        for (int pp = 0; pp < NP; ++pp) {
          tma_load_3d(sK + pp * kDqRowsK * kRowBytes, &tm_k, bar_full + 8 * s, pp * kPanelCols,
                      it * kDqRowsK, bh);
          tma_load_3d(sV + pp * kDqRowsK * kRowBytes, &tm_v, bar_full + 8 * s, pp * kPanelCols,
                      it * kDqRowsK, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread holds
  // rows row[h] = q0 + 64 wg + 16 w + lane/4 + 8h and, in each 8-column
  // group j of an accumulator, k columns 8j + c_off + {0, 1}
  const int wg = warp / 4, w = warp % 4;
  const uint32_t seed = load_seed(p, bh);
  const int c_off = 2 * (lane % 4);
  const int wg_q0 = q0 + 64 * wg;
  int row[2];
  uint32_t row_hash[2];
  float lse[2], delta[2];
  const float* rows_bias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = wg_q0 + 16 * w + lane / 4 + 8 * h;
    row_hash[h] = p.use_dropout ? dropout_row_hash(seed, row[h]) : 0u;
    // padding rows read an in-range row; they are never written
    const int rc = min(row[h], p.s_q - 1);
    lse[h] = p.lse[(size_t)bh * p.s_q + rc];
    delta[h] = p.delta[(size_t)bh * p.s_q + rc];
    rows_bias[h] = p.bias_kind == 2 ? p.bias + ((size_t)bh * p.s_q + rc) * p.s_k : nullptr;
  }
  const float* key_bias = p.bias_kind == 1 ? p.bias + (size_t)(bh / p.heads) * p.s_k : nullptr;

  float dq[NP][32];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[pp][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_k_tiles; ++it) {
    const int s = it % kTcStages;
    const uint32_t sK = sKV + 2 * s * kKBytes, sV = sK + kKBytes;
    const int k0 = it * kDqRowsK;
    mbar_wait(bar_full + 8 * s, (it / kTcStages) & 1);
    if (p.causal && k0 > wg_q0 + 63) {
      // every pair of this warpgroup is masked: p = 0 and dS = 0 exactly
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      continue;
    }

    // S = Q . K^T and dP = dO . V^T (64 q rows x 64 k columns)
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const uint32_t a_off = (kd / 4) * kDqRowsQ * kRowBytes + wg * 64 * kRowBytes + (kd % 4) * 32;
      const uint32_t b_off = (kd / 4) * kDqRowsK * kRowBytes + (kd % 4) * 32;
      wgmma_ss<TcElem<T>::kHalf>(sc, desc_k_major(sQ + a_off), desc_k_major(sK + b_off), kd > 0);
      wgmma_ss<TcElem<T>::kHalf>(dp, desc_k_major(sDO + a_off), desc_k_major(sV + b_off), kd > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // scores, masks, p, dropout and dS, each branch uniform over the warp
    // and outside the element loops (see the forward)
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= p.scale;
    if (p.bias_kind == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] += key_bias[min(k0 + tc_col(i, c_off), p.s_k - 1)];
    } else if (p.bias_kind == 2) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] += rows_bias[(i >> 1) & 1][min(k0 + tc_col(i, c_off), p.s_k - 1)];
    }
    if (p.causal && k0 + kDqRowsK - 1 > wg_q0) {  // a tile that crosses the diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (row[(i >> 1) & 1] < k0 + tc_col(i, c_off)) sc[i] = kNegInf;
    }
    // p = exp(s - lse) with expf of the difference, as the plain version
    // computes it (see the dK/dV sweep); dS = p (dp - delta) scale
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = expf(sc[i] - lse[(i >> 1) & 1]);
    if (p.use_dropout) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float dpv =
            dropout_keep_row(p, row_hash[(i >> 1) & 1], k0 + tc_col(i, c_off)) ? dp[i] * p.drop_inv_keep : 0.f;
        dp[i] = sc[i] * (dpv - delta[(i >> 1) & 1]) * p.scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - delta[(i >> 1) & 1]) * p.scale;
    }
    if (k0 + kDqRowsK > p.s_k) {  // columns past S_k (K's rows there arrive as zeros)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + tc_col(i, c_off) >= p.s_k) dp[i] = 0.f;
    }
    uint32_t da[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_to_a<T>(da[c], dp, c);

    // dQ += dS . K, K MN-major: k-step kk reads k rows 16 kk .. 16 kk + 15
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqRowsK / 16; ++kk)
#pragma unroll
      for (int pp = 0; pp < NP; ++pp)
        wgmma_rs<TcElem<T>::kHalf>(dq[pp], da[kk], desc_mn_major(sK + pp * kDqRowsK * kRowBytes + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) fence_regs(dq[pp]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(da[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  T* dq_out = static_cast<T*>(p.dq) + (size_t)bh * p.s_q * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= p.s_q) continue;
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * pp + 8 * j + c_off;
        if (col < D) {
          store_pair(dq_out + (size_t)row[h] * D + col, dq[pp][4 * j + 2 * h], dq[pp][4 * j + 2 * h + 1]);
        }
      }
  }
}

constexpr int kErrTensorMap = -3;  // a tensor map could not be encoded (or a pointer is unaligned)

template <typename T, int D>
int launch_fwd_tc(const FlashParams& p, int bh, cudaStream_t stream) {
  using hopper::make_tile_map;
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType type = TcElem<T>::kMap;
  if (!make_tile_map<D>(&tq, p.q, p.s_q, bh, kFwdRowsQ, type) || !make_tile_map<D>(&tk, p.k, p.s_k, bh, kFwdRowsK, type) ||
      !make_tile_map<D>(&tv, p.v, p.s_k, bh, kFwdRowsK, type))
    return kErrTensorMap;
  constexpr size_t smem = fwd_tc_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(bh, (p.s_q + kFwdRowsQ - 1) / kFwdRowsQ);
  flash_fwd_tc_kernel<T, D><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv_tc(const FlashParams& p, int bh, cudaStream_t stream) {
  using hopper::make_tile_map;
  CUtensorMap tq, tk, tv, tdo;
  constexpr CUtensorMapDataType type = TcElem<T>::kMap;
  if (!make_tile_map<D>(&tq, p.q, p.s_q, bh, kBwdRowsQ, type) || !make_tile_map<D>(&tk, p.k, p.s_k, bh, kBwdRowsK, type) ||
      !make_tile_map<D>(&tv, p.v, p.s_k, bh, kBwdRowsK, type) || !make_tile_map<D>(&tdo, p.dout, p.s_q, bh, kBwdRowsQ, type))
    return kErrTensorMap;
  constexpr size_t smem = dkdv_tc_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(bh, (p.s_k + kBwdRowsK - 1) / kBwdRowsK);
  flash_bwd_dkdv_tc_kernel<T, D><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq_tc(const FlashParams& p, int bh, cudaStream_t stream) {
  using hopper::make_tile_map;
  CUtensorMap tq, tk, tv, tdo;
  constexpr CUtensorMapDataType type = TcElem<T>::kMap;
  if (!make_tile_map<D>(&tq, p.q, p.s_q, bh, kDqRowsQ, type) || !make_tile_map<D>(&tk, p.k, p.s_k, bh, kDqRowsK, type) ||
      !make_tile_map<D>(&tv, p.v, p.s_k, bh, kDqRowsK, type) || !make_tile_map<D>(&tdo, p.dout, p.s_q, bh, kDqRowsQ, type))
    return kErrTensorMap;
  constexpr size_t smem = dq_tc_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(bh, (p.s_q + kDqRowsQ - 1) / kDqRowsQ);
  flash_bwd_dq_tc_kernel<T, D><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kScorePitch);
}
template <int D> constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kScorePitch + 2 * kTile);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kScorePitch + 2 * kTile);
}

enum Which { kFwd = 0, kDkdv = 1, kDq = 2 };

template <typename Kernel>
int launch_scalar(Kernel kernel, size_t smem, dim3 grid, const FlashParams& p, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// bf16 and fp16 run the three tensor-core kernels; every fp32 kernel runs the scalar
// kernels (fp32 products, as the Pallas kernels compute them at fp32).
// Decided by dtype before launch, never by a retry. `scalar` launches the
// scalar dQ sweep at bf16 too: the route the tensor-core one replaced, kept
// so that a run can time the two side by side.
template <typename T, int D>
int launch_typed(Which which, const FlashParams& p, int bh, cudaStream_t stream, bool scalar) {
  const int n_q_tiles = (p.s_q + kTile - 1) / kTile;
  const int n_k_tiles = (p.s_k + kTile - 1) / kTile;
  if constexpr (!std::is_same<T, float>::value) {
    if (which == kFwd) return launch_fwd_tc<T, D>(p, bh, stream);
    if (which == kDkdv) return launch_dkdv_tc<T, D>(p, bh, stream);
    if (!scalar) return launch_dq_tc<T, D>(p, bh, stream);
    return launch_scalar(flash_bwd_dq_kernel<T, D>, dq_smem<D>(), dim3(n_q_tiles, bh), p, stream);
  } else {
    if (which == kFwd) return launch_scalar(flash_fwd_kernel<T, D>, fwd_smem<D>(), dim3(n_q_tiles, bh), p, stream);
    if (which == kDkdv)
      return launch_scalar(flash_bwd_dkdv_kernel<T, D>, dkdv_smem<D>(), dim3(n_k_tiles, bh), p, stream);
    return launch_scalar(flash_bwd_dq_kernel<T, D>, dq_smem<D>(), dim3(n_q_tiles, bh), p, stream);
  }
}

template <typename T>
int launch_dim(Which which, const FlashParams& p, int head_dim, int bh, cudaStream_t stream, bool scalar) {
  switch (head_dim) {
    case 64: return launch_typed<T, 64>(which, p, bh, stream, scalar);
    case 96: return launch_typed<T, 96>(which, p, bh, stream, scalar);
    case 128: return launch_typed<T, 128>(which, p, bh, stream, scalar);
    default: return -1;
  }
}

int launch(Which which, const FlashParams& p, int dtype, int head_dim, int bh, void* stream,
           bool scalar = false) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(which, p, head_dim, bh, s, scalar);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(which, p, head_dim, bh, s, scalar);
  if (dtype == 2) return launch_dim<__half>(which, p, head_dim, bh, s, scalar);
  return -2;
}

FlashParams make_params(const void* q, const void* k, const void* v, const void* bias, int heads,
                        int head_offset, int total_heads, int s_q, int s_k, float scale, int causal, int bias_kind, int use_dropout,
                        unsigned int threshold, float inv_keep, const void* seed) {
  FlashParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.heads = heads;
  p.head_offset = head_offset;
  p.total_heads = total_heads;
  p.s_q = s_q;
  p.s_k = s_k;
  p.scale = scale;
  p.causal = causal;
  p.bias_kind = bias_kind;
  p.use_dropout = use_dropout;
  p.drop_threshold = threshold;
  p.drop_inv_keep = inv_keep;
  p.seed = static_cast<const int32_t*>(seed);
  return p;
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 fp32, 1 bf16, 2 fp16;
// seed: a device int32 (read only with dropout). Each
// function launches on `stream` and returns cudaGetLastError() (0 = launched),
// -1 for an unsupported head_dim, -2 for an unsupported dtype, -3 when a bf16 or fp16
// operand's TMA tensor map cannot be made (unaligned pointer, or the driver
// has no cuTensorMapEncodeTiled).
extern "C" {

int ds_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
                 int dtype, int head_dim, int bh, int heads, int head_offset, int total_heads, int s_q,
                 int s_k, float scale, int causal, int bias_kind, int use_dropout, unsigned int threshold, float inv_keep, const void* seed,
                 void* stream) {
  FlashParams p = make_params(q, k, v, bias, heads, head_offset, total_heads, s_q, s_k, scale, causal,
                              bias_kind, use_dropout, threshold, inv_keep, seed);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  return launch(kFwd, p, dtype, head_dim, bh, stream);
}

int ds_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int dtype, int head_dim, int bh,
                      int heads, int head_offset, int total_heads, int s_q, int s_k, float scale, int causal,
                      int bias_kind, int use_dropout,
                      unsigned int threshold, float inv_keep, const void* seed, void* stream) {
  FlashParams p = make_params(q, k, v, bias, heads, head_offset, total_heads, s_q, s_k, scale, causal,
                              bias_kind, use_dropout, threshold, inv_keep, seed);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return launch(kDkdv, p, dtype, head_dim, bh, stream);
}

int ds_flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
                    const void* lse, const void* delta, void* dq, int dtype, int head_dim, int bh, int heads,
                    int head_offset, int total_heads, int s_q, int s_k, float scale, int causal, int bias_kind, int use_dropout,
                    unsigned int threshold, float inv_keep, const void* seed, void* stream) {
  FlashParams p = make_params(q, k, v, bias, heads, head_offset, total_heads, s_q, s_k, scale, causal,
                              bias_kind, use_dropout, threshold, inv_keep, seed);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  return launch(kDq, p, dtype, head_dim, bh, stream);
}

// ds_flash_bwd_dq on the scalar kernel whatever the dtype (to time the
// bf16 route that the tensor-core kernel replaced)
int ds_flash_bwd_dq_scalar(const void* q, const void* k, const void* v, const void* bias, const void* dout,
                           const void* lse, const void* delta, void* dq, int dtype, int head_dim, int bh,
                           int heads, int head_offset, int total_heads, int s_q, int s_k, float scale, int causal,
                      int bias_kind, int use_dropout,
                           unsigned int threshold, float inv_keep, const void* seed, void* stream) {
  FlashParams p = make_params(q, k, v, bias, heads, head_offset, total_heads, s_q, s_k, scale, causal,
                              bias_kind, use_dropout, threshold, inv_keep, seed);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  return launch(kDq, p, dtype, head_dim, bh, stream, true);
}

}  // extern "C"
