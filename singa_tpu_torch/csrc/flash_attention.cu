// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels of singa_tpu/ops/pallas/flash_attention.py:
//   flash_fwd     <- _flash_fwd_pallas (_fwd_kernel)
//   flash_bwd_dq  <- _flash_bwd_pallas, dQ call (_dq_kernel)
//   flash_bwd_dkv <- _flash_bwd_pallas, dK/dV call (_dkv_kernel)
// and computes what they compute, with the same conventions:
//   * S = Q K^T * scale + key-mask row [+ general mask tile (M, S, S)
//     addressed by (bh / qdiv) % qmod]; under causal, scores above the
//     diagonal (and, with a window, outside the band q - k < window) are
//     REPLACED by the finite floor NEG_INF = -1e30, never -inf;
//   * the running max starts at NEG_INF; a row with zero mass (l == 0)
//     writes O = 0 and lse = m + log(1);
//   * under bf16 and float16, p is rounded to V's (dO's) type before P V
//     (P^T dO) and dS to K's (Q's) type before dS K (dS^T Q), as the
//     Pallas kernels cast before their dots; every sum is kept in float32.
//
// Design for the GPU (not a block-by-block copy of the TPU schedule):
//   * the TPU's sequential key-block grid axis becomes a loop inside one
//     CUDA block; its bounds stop at the causal diagonal and start at the
//     window band, so skipped tiles cost nothing (no idle grid steps);
//   * the online-softmax state and the O / dQ / dK / dV accumulators
//     live in registers, float32 (the tiles of each family: below);
//   * the ragged tail is masked in the kernel: any S and any D <= 1792
//     (kind 2 takes D a multiple of 8: the wrapper pads); key columns
//     past S contribute p = 0, rows past S are not written; scale =
//     1/sqrt(D) of the true D comes from the caller;
//   * dK/dV walks query tiles inside a block that owns one key tile: no
//     atomics, so every result is deterministic;
//   * the kernels allocate nothing; each entry point launches on the
//     stream it is given and returns cudaGetLastError().
//
// What bounds them on the H100: at GPT-2 small's shape (BH = 96,
// S = 1024, D = 64, causal, bf16) the work is 1.29e10 FLOP for the
// forward, 1.93e10 for dQ and 2.58e10 for dK/dV against 51 / 64 / 76 MB
// read and written once: the forward is bound by its bytes (15.1 us at
// 3.35 TB/s), dQ and dK/dV by their products (19.6 / 26.1 us at 989
// TFLOP/s bf16).
//
// Two families of kernels, chosen by the caller's `kind` (the routing
// rule is `route` in ops/flash_attention.py):
//
//   * kinds 2 and 4, bf16 and float16 with D <= 128 -- tensor cores, all
//     three kernels, each templated on the 16-bit element type T (the
//     products' PTX types, mma.sync's and wgmma's .bf16 / .f16, and the
//     tensor maps' data type follow T; ldmatrix, the swizzle and the ring
//     are the same for both):
//       fwd_wg_kernel  <- _flash_fwd_pallas (_fwd_kernel)
//       dq_tc_kernel   <- _flash_bwd_pallas, dQ call (_dq_kernel)
//       dkv_wg_kernel  <- _flash_bwd_pallas, dK/dV call (_dkv_kernel)
//     Operands are T (D a multiple of 8 at 16-byte aligned bases: the
//     wrapper pads any other D with zero columns, which is exact), sums
//     float32.  Only tiles on the causal diagonal, at a window's edge, at
//     the ragged end of S, or under a mask apply per-element masks and
//     exponentiate exact differences (scores at the NEG_INF floor); the
//     others fold the scale into one FMA before a single ex2.
//     - fwd_wg_kernel<DT, NC> and dkv_wg_kernel<DT, NC> (DT = 64 or 128,
//       NC = 2): Hopper's warpgroup design.  A block of 128 (NC + 1)
//       threads holds NC consumer warpgroups, each owning 64 rows
//       (queries / keys) with its accumulators in registers, and a
//       producer warpgroup whose first warp issues TMA loads of
//       128-byte-swizzled boxes, 64 columns wide (zero past S and D by
//       each head's 3-D tensor map), into a ring of stages, each with a
//       "full" and an "empty" mbarrier.  The producer keeps 24 registers
//       (setmaxnreg.dec), the consumers take the rest (240).  Consumers
//       release a stage after the wgmma.wait_group that last reads it.
//       Products are wgmma: S = Q K^T (m64n128k16) and S^T = K Q^T,
//       dP^T = V dO^T (m64n64k16) with both operands in shared memory (SS,
//       K-major); P V, P^T dO and dS^T Q with P / dS packed to T
//       straight into the A registers (RS, m64n64k16) and V / dO / Q read
//       MN-major (the transpose bit).  A wgmma accumulator's per-warp
//       fragment is mma.sync's m16n8, repeated over N, so the masking and
//       online softmax are dq_tc_kernel's; a tile cut only by the causal
//       diagonal or the end of S (no masks, no window) keeps the one-FMA
//       path with its cut scores at -inf.  Each issues the next tile's
//       scores before it exponentiates this one's, so a product runs
//       while the softmax does.
//       fwd_wg_kernel is persistent (a block per SM walks (bh, 128-row)
//       items heaviest first, Q double-buffered so the next item loads
//       while this one ends) and walks keys in tiles of 128 through 4
//       stages (DT = 64; 2 at 128): 161 KB of shared memory at DT = 64.
//       dkv_wg_kernel owns 128 keys a block (heaviest causal blocks
//       first), walks the causal / window band in 64-query tiles through
//       6 stages (4 at DT = 128), lse and delta staged by cp.async beside
//       each tile; no atomics (deterministic): 132 KB at DT = 64.
//     - dq_tc_kernel<DT, 4>: FlashAttention-2's structure on
//       mma.sync.m16n8k16.  One block of 4 warps per (bh, 64-row query
//       tile), heaviest causal tiles first; each warp keeps the Q and dO
//       fragments of its 16 rows, and their lse and delta, in registers.
//       Tiles arrive by cp.async into two stages of rows DT elements wide
//       whose 16-byte chunks are XOR-swizzled by row, so ldmatrix reads
//       them without bank conflicts; one __syncthreads per tile.  Per
//       64-key tile S = Q K^T and dP = dO V^T on the tensor cores, P =
//       2^(S scale log2 e - lse log2 e) and dS = P (dP - delta) scale in
//       registers, dS packed to T into the A fragment of dQ += dS K (K
//       read by ldmatrix.trans).  dQ written once, no atomics.  Q and dO
//       pass once through the second K / V stage, so shared memory is 2
//       stages x (K + V) x 64 x DT x 2 B = 32 KB at DT = 64, 64 KB at
//       DT = 128.
//     (Registers and spills: nvcc -Xptxas -v for sm_90a, as chip_smoke.py's
//     build phase reports them; times and bounds: PERF.md.)
//   * kinds 0, 1 and 3, float32 (tensor cores would need TF32, which
//     misses the float32 tolerance), and bf16 and float16 with
//     128 < D <= 1792 -- CUDA cores:
//       fwd_kernel / dq_kernel / dkv_kernel<T, BR, DT>, and past D = 512
//       fwd_narrow_kernel / dq_narrow_kernel / dkv_narrow_kernel<T, DT>
//     One block of 256 threads per (bh, BR-row tile); Q/K/V/dO tiles
//     staged in shared memory as float32 with an odd row stride (no bank
//     conflicts); float32 FMAs, far above the bounds above (PERF.md).
//     The rows of a tile shrink as D grows, so that the largest of the
//     three kernels' shared memory (dK/dV: 4 BR (DT + 1) + 2 BR (BR + 1)
//     + 2 BR floats) fits 227 KB: BR = 64 at DT = 64 and 128, 32 at 256
//     (137 KB), 16 at 512 (130 KB; 32 rows would need 265 KB), and 8 at
//     DT = 1792 (224 KB; the narrow kernels, a warp a row: see their
//     note).  A wider row raises in the wrapper, naming 1792.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#define NEG_INF (-1e30f)
#define NTHREADS 256

namespace {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back: the cast the Pallas kernels make before a dot.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Rows [row0, row0 + BR) x columns [0, DT) of a (S, D) matrix into
// shared memory with row stride DT + 1; zeros past S and past D.
template <typename T, int BR, int DT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S, int D) {
  for (int idx = threadIdx.x; idx < BR * DT; idx += NTHREADS) {
    const int r = idx / DT, c = idx % DT, row = row0 + r;
    float v = 0.f;
    if (row < S && c < D) v = to_f<T>(src[(size_t)row * D + c]);
    dst[r * (DT + 1) + c] = v;
  }
}

// Score of query qi against key kj after scale, masks and the causal
// band: the value the Pallas kernels hold in `s` before the softmax.
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              const float* kmask,
                                              const float* qm, int qi, int kj,
                                              int S, int causal, int window) {
  float x = dot * scale;
  if (kmask) x += kmask[kj];
  if (qm) x += qm[(size_t)qi * S + kj];
  if (causal) {
    const bool keep = qi >= kj && (window <= 0 || qi - kj < window);
    if (!keep) x = NEG_INF;
  }
  return x;
}

// Sum / max over the 16 threads (tx = 0..15) that share a row.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kmask;  // (BH, S) additive key mask, or null
  const float* qmask;  // (M, S, S) additive general mask, or null
  int qdiv, qmod;      // bh -> mask index (bh / qdiv) % qmod
  const void* dout;    // dO (backward)
  const float* lse;    // (BH, S) (backward)
  const float* delta;  // (BH, S) rowsum(dO*O) - dlse (backward)
  void* out0;          // O | dQ | dK
  void* out1;          // -  | -  | dV
  float* lse_out;      // (BH, S) (forward)
  int bh, S, D;
  float scale;
  int causal, window;  // window <= 0: none
};

// ------------------------------------------------------------- forward

template <typename T, int BR, int DT>
__global__ void __launch_bounds__(NTHREADS) fwd_kernel(Args a) {
  constexpr int RI = BR / 16, DJ = DT / 16, LD = DT + 1, LP = BR + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BR * LD;
  float* sV = sK + BR * LD;
  float* sP = sV + BR * LD;

  const int S = a.S, D = a.D;
  const int ntiles = (S + BR - 1) / BR;
  const int bh = blockIdx.x / ntiles, q0 = (blockIdx.x % ntiles) * BR;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)bh * S * D;
  const T* Q = (const T*)a.q + base;
  const T* K = (const T*)a.k + base;
  const T* V = (const T*)a.v + base;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;

  load_tile<T, BR, DT>(sQ, Q, q0, S, D);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BR, S) - 1;
  const int kt_end = a.causal ? q_last / BR : ntiles - 1;
  int kt_begin = 0;
  if (a.causal && a.window > 0) kt_begin = max(0, q0 - (a.window - 1)) / BR;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();  // the previous tile's reads of sK / sV / sP are done
    load_tile<T, BR, DT>(sK, K, k0, S, D);
    load_tile<T, BR, DT>(sV, V, k0, S, D);
    __syncthreads();

    float s[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DT; ++d) {
      float qv[RI], kv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty * RI + i) * LD + d];
#pragma unroll
      for (int j = 0; j < RI; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = min(q0 + ty * RI + i, S - 1);  // rows past S: unused
      float mloc = NEG_INF;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj < S) {
          s[i][j] = masked_score(s[i][j], a.scale, kmask, qm, qi, kj, S,
                                 a.causal, a.window);
          mloc = fmaxf(mloc, s[i][j]);
        }
      }
      const float m_new = fmaxf(m[i], row_max16(mloc));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float p = kj < S ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        sP[(ty * RI + i) * LP + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sP[(ty * RI + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* O = (T*)a.out0 + base;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty * RI + i;
    if (row >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) O[(size_t)row * D + col] = from_f<T>(acc[i][j] / l_safe);
    }
    if (tx == 0) a.lse_out[(size_t)bh * S + row] = m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------------ dQ

template <typename T, int BR, int DT>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(Args a) {
  constexpr int RI = BR / 16, DJ = DT / 16, LD = DT + 1, LP = BR + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BR * LD;
  float* sK = sdO + BR * LD;
  float* sV = sK + BR * LD;
  float* sS = sV + BR * LD;

  const int S = a.S, D = a.D;
  const int ntiles = (S + BR - 1) / BR;
  const int bh = blockIdx.x / ntiles, q0 = (blockIdx.x % ntiles) * BR;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)bh * S * D;
  const T* Q = (const T*)a.q + base;
  const T* K = (const T*)a.k + base;
  const T* V = (const T*)a.v + base;
  const T* dO = (const T*)a.dout + base;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;

  load_tile<T, BR, DT>(sQ, Q, q0, S, D);
  load_tile<T, BR, DT>(sdO, dO, q0, S, D);

  float lse[RI], delta[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = min(q0 + ty * RI + i, S - 1);
    lse[i] = a.lse[(size_t)bh * S + row];
    delta[i] = a.delta[(size_t)bh * S + row];
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BR, S) - 1;
  const int kt_end = a.causal ? q_last / BR : ntiles - 1;
  int kt_begin = 0;
  if (a.causal && a.window > 0) kt_begin = max(0, q0 - (a.window - 1)) / BR;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();
    load_tile<T, BR, DT>(sK, K, k0, S, D);
    load_tile<T, BR, DT>(sV, V, k0, S, D);
    __syncthreads();

    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DT; ++d) {
      float qv[RI], ov[RI], kv[RI], vv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = sQ[(ty * RI + i) * LD + d];
        ov[i] = sdO[(ty * RI + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = min(q0 + ty * RI + i, S - 1);
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kj = k0 + tx + 16 * j;
        float ds = 0.f;
        if (kj < S) {
          const float x = masked_score(s[i][j], a.scale, kmask, qm, qi, kj, S,
                                       a.causal, a.window);
          const float p = expf(x - lse[i]);
          ds = p * (dp[i][j] - delta[i]) * a.scale;
        }
        sS[(ty * RI + i) * LP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      float sv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = sS[(ty * RI + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  T* dQ = (T*)a.out0 + base;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty * RI + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) dQ[(size_t)row * D + col] = from_f<T>(acc[i][j]);
    }
  }
}

// --------------------------------------------------------------- dK/dV

template <typename T, int BR, int DT>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(Args a) {
  constexpr int RI = BR / 16, DJ = DT / 16, LD = DT + 1, LP = BR + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BR * LD;
  float* sQ = sV + BR * LD;
  float* sdO = sQ + BR * LD;
  float* sPt = sdO + BR * LD;
  float* sSt = sPt + BR * LP;
  float* sLse = sSt + BR * LP;
  float* sDelta = sLse + BR;

  const int S = a.S, D = a.D;
  const int ntiles = (S + BR - 1) / BR;
  const int bh = blockIdx.x / ntiles, k0 = (blockIdx.x % ntiles) * BR;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)bh * S * D;
  const T* Q = (const T*)a.q + base;
  const T* K = (const T*)a.k + base;
  const T* V = (const T*)a.v + base;
  const T* dO = (const T*)a.dout + base;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;

  load_tile<T, BR, DT>(sK, K, k0, S, D);
  load_tile<T, BR, DT>(sV, V, k0, S, D);

  float dk[RI][DJ], dv[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // query tiles that see this key tile: causal rows q >= k0; with a
  // window, rows q <= k_last + window - 1
  const int k_last = min(k0 + BR, S) - 1;
  const int qt_begin = a.causal ? k0 / BR : 0;
  int qt_end = ntiles - 1;
  if (a.causal && a.window > 0)
    qt_end = min(qt_end, (k_last + a.window - 1) / BR);

  for (int qt = qt_begin; qt <= qt_end; ++qt) {
    const int q0 = qt * BR;
    __syncthreads();
    load_tile<T, BR, DT>(sQ, Q, q0, S, D);
    load_tile<T, BR, DT>(sdO, dO, q0, S, D);
    for (int r = tid; r < BR; r += NTHREADS) {
      const int row = q0 + r;
      sLse[r] = row < S ? a.lse[(size_t)bh * S + row] : 0.f;
      sDelta[r] = row < S ? a.delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();

    // transposed tiles: this thread's rows are keys, its columns queries
    float st[RI][RI], dpt[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DT; ++d) {
      float kv[RI], vv[RI], qv[RI], ov[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        kv[i] = sK[(ty * RI + i) * LD + d];
        vv[i] = sV[(ty * RI + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        qv[j] = sQ[(tx + 16 * j) * LD + d];
        ov[j] = sdO[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kj = k0 + ty * RI + i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j, qi = q0 + c;
        float p = 0.f, ds = 0.f;
        if (kj < S && qi < S) {
          const float x = masked_score(st[i][j], a.scale, kmask, qm, qi, kj, S,
                                       a.causal, a.window);
          p = expf(x - sLse[c]);
          ds = p * (dpt[i][j] - sDelta[c]) * a.scale;
        }
        sPt[(ty * RI + i) * LP + c] = round_to<T>(p);
        sSt[(ty * RI + i) * LP + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      float pv[RI], sv[RI], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pv[i] = sPt[(ty * RI + i) * LP + c];
        sv[i] = sSt[(ty * RI + i) * LP + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = sdO[c * LD + tx + 16 * j];
        qv[j] = sQ[c * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
        }
    }
  }

  T* dK = (T*)a.out0 + base;
  T* dV = (T*)a.out1 + base;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty * RI + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) {
        dK[(size_t)row * D + col] = from_f<T>(dk[i][j]);
        dV[(size_t)row * D + col] = from_f<T>(dv[i][j]);
      }
    }
  }
}

// ------------------------------------------------ 8-row tiles (D > 512)
//
// The widest rung, for 512 < D <= 1792: tiles of 8 rows, so that rows of
// DT = 1792 fit the shared memory (dK/dV: 4 x 8 x 1793 + 2 x 8 x 9 +
// 2 x 8 floats = 224 KB; 16-row tiles would pass 227 KB from DT = 897).
// Same layout of shared memory as the kernels above (float32 tiles,
// stride DT + 1) and the same arithmetic, with another thread map: warp
// w owns row w of the tile (a query row of the forward and dQ, a key row
// of dK/dV) and each of its lanes holds DT / 32 columns of that row's
// accumulators.  A score of the 8 x 8 tile is summed by the 4 lanes of
// one key (lane & 7) over interleaved quarters of D and combined by
// shuffles, so every lane ends with the score of key lane & 7; loops over
// D stop at D (the tiles are zero past it).

// Sum over the 4 lanes that share lane & 7.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
// Sum / max over the 8 keys of a row (lanes with the same lane >> 3).
__device__ __forceinline__ float key_sum8(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float key_max8(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// Row `row` of sA against row lane & 7 of sB over columns [0, D).
__device__ __forceinline__ float dot8(const float* sA, const float* sB,
                                      int row, int ld, int D, int lane) {
  const float* x = sA + row * ld;
  const float* y = sB + (lane & 7) * ld;
  float s = 0.f;
  for (int d = lane >> 3; d < D; d += 4) s = fmaf(x[d], y[d], s);
  return quad_sum(s);
}

template <typename T, int DT>
__global__ void __launch_bounds__(NTHREADS) fwd_narrow_kernel(Args a) {
  constexpr int BR = 8, DJ = DT / 32, LD = DT + 1, LP = BR + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BR * LD;
  float* sV = sK + BR * LD;
  float* sP = sV + BR * LD;

  const int S = a.S, D = a.D;
  const int ntiles = (S + BR - 1) / BR;
  const int bh = blockIdx.x / ntiles, q0 = (blockIdx.x % ntiles) * BR;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, kk = lane & 7;
  const size_t base = (size_t)bh * S * D;
  const T* Q = (const T*)a.q + base;
  const T* K = (const T*)a.k + base;
  const T* V = (const T*)a.v + base;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;

  load_tile<T, BR, DT>(sQ, Q, q0, S, D);
  const int qi = min(q0 + w, S - 1);  // rows past S: unused
  float m = NEG_INF, l = 0.f, acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;

  const int q_last = min(q0 + BR, S) - 1;
  const int kt_end = a.causal ? q_last / BR : ntiles - 1;
  int kt_begin = 0;
  if (a.causal && a.window > 0) kt_begin = max(0, q0 - (a.window - 1)) / BR;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BR, kj = k0 + kk;
    __syncthreads();  // the previous tile's reads of sK / sV are done
    load_tile<T, BR, DT>(sK, K, k0, S, D);
    load_tile<T, BR, DT>(sV, V, k0, S, D);
    __syncthreads();
    const float dot = dot8(sQ, sK, w, LD, D, lane);
    const float x = kj < S ? masked_score(dot, a.scale, kmask, qm, qi, kj,
                                          S, a.causal, a.window)
                           : NEG_INF;
    const float m_new = fmaxf(m, key_max8(x));
    const float p = kj < S ? expf(x - m_new) : 0.f;
    if (lane < BR) sP[w * LP + kk] = round_to<T>(p);
    const float alpha = expf(m - m_new);
    l = l * alpha + key_sum8(p);
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      if (32 * j < D) {
        float o = acc[j] * alpha;
#pragma unroll
        for (int c = 0; c < BR; ++c)
          o = fmaf(sP[w * LP + c], sV[c * LD + lane + 32 * j], o);
        acc[j] = o;
      }
    }
  }

  const int row = q0 + w;
  if (row >= S) return;
  T* O = (T*)a.out0 + base;
  const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int col = lane + 32 * j;
    if (col < D) O[(size_t)row * D + col] = from_f<T>(acc[j] / l_safe);
  }
  if (lane == 0) a.lse_out[(size_t)bh * S + row] = m + logf(l_safe);
}

template <typename T, int DT>
__global__ void __launch_bounds__(NTHREADS) dq_narrow_kernel(Args a) {
  constexpr int BR = 8, DJ = DT / 32, LD = DT + 1, LP = BR + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BR * LD;
  float* sK = sdO + BR * LD;
  float* sV = sK + BR * LD;
  float* sS = sV + BR * LD;

  const int S = a.S, D = a.D;
  const int ntiles = (S + BR - 1) / BR;
  const int bh = blockIdx.x / ntiles, q0 = (blockIdx.x % ntiles) * BR;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, kk = lane & 7;
  const size_t base = (size_t)bh * S * D;
  const T* Q = (const T*)a.q + base;
  const T* K = (const T*)a.k + base;
  const T* V = (const T*)a.v + base;
  const T* dO = (const T*)a.dout + base;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;

  load_tile<T, BR, DT>(sQ, Q, q0, S, D);
  load_tile<T, BR, DT>(sdO, dO, q0, S, D);
  const int qi = min(q0 + w, S - 1);
  const float lse = a.lse[(size_t)bh * S + qi];
  const float delta = a.delta[(size_t)bh * S + qi];
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;

  const int q_last = min(q0 + BR, S) - 1;
  const int kt_end = a.causal ? q_last / BR : ntiles - 1;
  int kt_begin = 0;
  if (a.causal && a.window > 0) kt_begin = max(0, q0 - (a.window - 1)) / BR;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BR, kj = k0 + kk;
    __syncthreads();
    load_tile<T, BR, DT>(sK, K, k0, S, D);
    load_tile<T, BR, DT>(sV, V, k0, S, D);
    __syncthreads();
    const float s = dot8(sQ, sK, w, LD, D, lane);
    const float dp = dot8(sdO, sV, w, LD, D, lane);
    float ds = 0.f;
    if (kj < S) {
      const float x = masked_score(s, a.scale, kmask, qm, qi, kj, S,
                                   a.causal, a.window);
      ds = expf(x - lse) * (dp - delta) * a.scale;
    }
    if (lane < BR) sS[w * LP + kk] = round_to<T>(ds);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      if (32 * j < D) {
        float o = acc[j];
#pragma unroll
        for (int c = 0; c < BR; ++c)
          o = fmaf(sS[w * LP + c], sK[c * LD + lane + 32 * j], o);
        acc[j] = o;
      }
    }
  }

  const int row = q0 + w;
  if (row >= S) return;
  T* dQ = (T*)a.out0 + base;
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int col = lane + 32 * j;
    if (col < D) dQ[(size_t)row * D + col] = from_f<T>(acc[j]);
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(NTHREADS) dkv_narrow_kernel(Args a) {
  constexpr int BR = 8, DJ = DT / 32, LD = DT + 1, LP = BR + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BR * LD;
  float* sQ = sV + BR * LD;
  float* sdO = sQ + BR * LD;
  float* sPt = sdO + BR * LD;
  float* sSt = sPt + BR * LP;
  float* sLse = sSt + BR * LP;
  float* sDelta = sLse + BR;

  const int S = a.S, D = a.D;
  const int ntiles = (S + BR - 1) / BR;
  const int bh = blockIdx.x / ntiles, k0 = (blockIdx.x % ntiles) * BR;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 7;
  const size_t base = (size_t)bh * S * D;
  const T* Q = (const T*)a.q + base;
  const T* K = (const T*)a.k + base;
  const T* V = (const T*)a.v + base;
  const T* dO = (const T*)a.dout + base;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;

  load_tile<T, BR, DT>(sK, K, k0, S, D);
  load_tile<T, BR, DT>(sV, V, k0, S, D);
  const int kj = k0 + w;  // this warp's key
  float dk[DJ], dv[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dk[j] = dv[j] = 0.f;

  const int k_last = min(k0 + BR, S) - 1;
  const int qt_begin = a.causal ? k0 / BR : 0;
  int qt_end = ntiles - 1;
  if (a.causal && a.window > 0)
    qt_end = min(qt_end, (k_last + a.window - 1) / BR);

  for (int qt = qt_begin; qt <= qt_end; ++qt) {
    const int q0 = qt * BR, qi = q0 + c;
    __syncthreads();
    load_tile<T, BR, DT>(sQ, Q, q0, S, D);
    load_tile<T, BR, DT>(sdO, dO, q0, S, D);
    for (int r = threadIdx.x; r < BR; r += NTHREADS) {
      const int row = q0 + r;
      sLse[r] = row < S ? a.lse[(size_t)bh * S + row] : 0.f;
      sDelta[r] = row < S ? a.delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();
    const float st = dot8(sK, sQ, w, LD, D, lane);
    const float dpt = dot8(sV, sdO, w, LD, D, lane);
    float p = 0.f, ds = 0.f;
    if (kj < S && qi < S) {
      const float x = masked_score(st, a.scale, kmask, qm, qi, kj, S,
                                   a.causal, a.window);
      p = expf(x - sLse[c]);
      ds = p * (dpt - sDelta[c]) * a.scale;
    }
    if (lane < BR) {
      sPt[w * LP + c] = round_to<T>(p);
      sSt[w * LP + c] = round_to<T>(ds);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      if (32 * j < D) {
        float v_ = dv[j], k_ = dk[j];
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          v_ = fmaf(sPt[w * LP + r], sdO[r * LD + lane + 32 * j], v_);
          k_ = fmaf(sSt[w * LP + r], sQ[r * LD + lane + 32 * j], k_);
        }
        dv[j] = v_;
        dk[j] = k_;
      }
    }
  }

  if (kj >= S) return;
  T* dK = (T*)a.out0 + base;
  T* dV = (T*)a.out1 + base;
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int col = lane + 32 * j;
    if (col < D) {
      dK[(size_t)kj * D + col] = from_f<T>(dk[j]);
      dV[(size_t)kj * D + col] = from_f<T>(dv[j]);
    }
  }
}

// ---------------------------------- tensor-core kernels (bf16, float16)

typedef __nv_bfloat16 bf16;
typedef __half f16;
template <typename T>
constexpr bool kF16 = std::is_same_v<T, f16>;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TC_BN = 64;  // keys per tile of dq_tc_kernel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; the bytes past src_bytes
// are written as zeros (src_bytes = 0: a zero chunk, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  The .trans form hands each thread a column
// pair instead of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b on the tensor cores: a 16x16 bf16 (row-major fragment), b
// 16x8 bf16 (column-major fragment), d 16x8 float32.  With g = lane / 4
// and t = lane % 4, d[0..1] sit at (row g, columns 2t, 2t+1) and d[2..3]
// at row g + 8; a[0..3] hold (g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..); b0 / b1 hold (k = 2t.. / 2t+8.., column g).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The same with float16 a and b.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <typename T>
__device__ __forceinline__ void mma_tc(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (kF16<T>)
    mma_f16(d, a, b0, b1);
  else
    mma_bf16(d, a, b0, b1);
}

// 2^x in one special-function instruction (results below 2^-126 flush
// to 0; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to T (the cast the Pallas kernels make before a
// dot), lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kF16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The A fragment of a 16x16 T tile from two 16x8 float32
// accumulators (columns 0-7 and 8-15): P and dS go from one product to
// the next in registers.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// Element offset of 16-byte chunk c of row r in a tile with rows DT
// 16-bit elements wide: the chunk index is XORed with r % 8, so the 8 rows an ldmatrix
// matrix reads at one logical chunk lie in 8 different bank groups.
template <int DT>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DT + ((c ^ (r & 7)) << 3);
}

// Rows [row0, row0 + R) of a (S, D) T matrix into a swizzled tile of
// width DT by cp.async (D % 8 == 0, 16-byte aligned rows); zeros past S
// and D.
template <int R, int DT, int NT, typename T>
__device__ __forceinline__ void load_tile_tc(T* dst, const T* src,
                                             int row0, int S, int D) {
  constexpr int CH = DT / 8;
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH, row = row0 + r, col = c * 8;
    const bool in = row < S && col < D;
    cp_async16(dst + swz<DT>(r, c), in ? src + (size_t)row * D + col : src,
               in ? 16 : 0);
  }
}

// masked_score, and -inf (p = 0, no part in a row max) for a query or a
// key past S.
__device__ __forceinline__ float tc_score(float dot, float scale,
                                          const float* kmask, const float* qm,
                                          int qi, int kj, int S, int causal,
                                          int window) {
  if (qi >= S || kj >= S) return -INFINITY;
  return masked_score(dot, scale, kmask, qm, qi, kj, S, causal, window);
}

// Row `row` of a (S, D) T output from a thread's two accumulator
// columns per 8-column block; D % 8 == 0.
template <int DB, typename T>
__device__ __forceinline__ void store_row_tc(T* out, const float (&acc)[DB][4],
                                             int half, int row, int D, int t) {
  T* dst = out + (size_t)row * D;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int col = db * 8 + 2 * t;
    if (col < D)
      *reinterpret_cast<uint32_t*>(dst + col) =
          pack2<T>(acc[db][2 * half], acc[db][2 * half + 1]);
  }
}

// (At DT = 64, at most 168 registers: 3 blocks of 4 warps on an SM.)
template <typename T, int DT, int NW>
__global__ void __launch_bounds__(NW * 32, DT == 64 ? 3 : 1)
    dq_tc_kernel(Args a) {
  constexpr int BM = 16 * NW, BN = TC_BN, NT = 32 * NW;
  constexpr int KS = DT / 16, NB = BN / 8, DB = DT / 8;
  static_assert(BM == BN, "Q and dO are staged in a K / V stage buffer");
  extern __shared__ __align__(128) unsigned char smem_tc[];
  T* sK = reinterpret_cast<T*>(smem_tc);  // two stages
  T* sV = sK + 2 * BN * DT;                  // two stages

  const int S = a.S, D = a.D;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16;
  const size_t base = (size_t)bh * S * D;
  const T* Q = (const T*)a.q + base;
  const T* K = (const T*)a.k + base;
  const T* V = (const T*)a.v + base;
  const T* dO = (const T*)a.dout + base;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;

  const int q_last = min(q0 + BM, S) - 1;
  const int kt_end = a.causal ? q_last / BN : (S - 1) / BN;
  int kt_begin = 0;
  if (a.causal && a.window > 0) kt_begin = max(0, q0 - (a.window - 1)) / BN;

  // Q and dO go through stage 1 once, into registers; key tile kt_begin
  // into stage 0.  Stage 1 takes key tile kt_begin + 1 only after the
  // first barrier of the loop, when every warp holds its fragments.
  load_tile_tc<BM, DT, NT>(sK + BN * DT, Q, q0, S, D);
  load_tile_tc<BM, DT, NT>(sV + BN * DT, dO, q0, S, D);
  cp_async_commit();
  load_tile_tc<BN, DT, NT>(sK, K, kt_begin * BN, S, D);
  load_tile_tc<BN, DT, NT>(sV, V, kt_begin * BN, S, D);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KS][4], of[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int off = swz<DT>(rw + (lane & 15), 2 * ks + (lane >> 4));
    ldsm_x4(qf[ks], smem_u32(sK + BN * DT + off));
    ldsm_x4(of[ks], smem_u32(sV + BN * DT + off));
  }

  // lse and delta of rows g (h = 0) and g + 8 (h = 1); rows past S
  // read row S - 1 and are never written
  float lse[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = min(q0 + rw + g + 8 * h, S - 1);
    lse[h] = a.lse[(size_t)bh * S + row];
    dl[h] = a.delta[(size_t)bh * S + row];
  }

  float dq[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BN, st = (kt - kt_begin) & 1;
    const T* cK = sK + st * BN * DT;
    const T* cV = sV + st * BN * DT;
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    if (kt < kt_end) {
      load_tile_tc<BN, DT, NT>(sK + (st ^ 1) * BN * DT, K, k0 + BN, S, D);
      load_tile_tc<BN, DT, NT>(sV + (st ^ 1) * BN * DT, V, k0 + BN, S, D);
      cp_async_commit();
    }

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BN keys
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) {
        const int off = swz<DT>(j * 16 + (lane & 7) + ((lane >> 4) << 3),
                                2 * ks + ((lane >> 3) & 1));
        uint32_t b[4];
        ldsm_x4(b, smem_u32(cK + off));
        mma_tc<T>(s[2 * j], qf[ks], b[0], b[1]);
        mma_tc<T>(s[2 * j + 1], qf[ks], b[2], b[3]);
        ldsm_x4(b, smem_u32(cV + off));
        mma_tc<T>(dp[2 * j], of[ks], b[0], b[1]);
        mma_tc<T>(dp[2 * j + 1], of[ks], b[2], b[3]);
      }
    }

    // P = exp(S - lse) and dS = P (dP - delta) scale, in place; the
    // diagonal, a window's edge, the ends of S and masked tiles take
    // tc_score's value per element and exact differences (the NEG_INF
    // floor), the others one FMA, as in the forward
    const bool edge =
        kmask || qm || k0 + BN > S || q0 + BM > S ||
        (a.causal && (k0 + BN - 1 > q0 ||
                      (a.window > 0 && q0 + BM - 1 - k0 >= a.window)));
    if (edge) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = tc_score(s[j][e], a.scale, kmask, qm,
                                   q0 + rw + g + (e >> 1) * 8,
                                   k0 + j * 8 + 2 * t + (e & 1), S, a.causal,
                                   a.window);
          s[j][e] = (x - lse[e >> 1]) * LOG2E;
        }
    } else {
      const float scl = a.scale * LOG2E;
      const float ml[2] = {lse[0] * LOG2E, lse[1] * LOG2E};
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = fmaf(s[j][e], scl, -ml[e >> 1]);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = ex2(s[j][e]) * (dp[j][e] - dl[e >> 1]) * a.scale;

    // dQ += dS K, dS rounded to T (K read by ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t da[4];
      acc_to_a<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DB / 2; ++j) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(cK + swz<DT>(kk * 16 + (lane & 7) +
                                               (((lane >> 3) & 1) << 3),
                                           2 * j + (lane >> 4))));
        mma_tc<T>(dq[2 * j], da, b[0], b[1]);
        mma_tc<T>(dq[2 * j + 1], da, b[2], b[3]);
      }
    }
  }

  T* dQ = (T*)a.out0 + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rw + g + 8 * h;
    if (row < S) store_row_tc<DB>(dQ, dq, h, row, D, t);
  }
}

// ------------------------------------ Hopper: mbarrier, TMA and wgmma

// A warpgroup of the Hopper kernels owns 64 rows (queries in the forward,
// keys in dK/dV) and walks the other side in tiles of 128 keys (forward)
// or 64 queries (dK/dV).  Every operand tile of R rows is DT / 64 TMA
// boxes of R rows x 64 columns, 128 B a row, stored 128-byte swizzled as
// TMA writes them.
constexpr int WG_TILE = 64;
constexpr int BOX = 64 * 64;  // elements of a 64-row box
constexpr uint32_t BOX_BYTES = BOX * 2;  // 16-bit elements

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// Makes the barriers' initialisation visible to TMA (the async proxy).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Arrives once this thread's cp.async copies so far have landed (one of
// the barrier's counted arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Arrives and adds `bytes` to the transfers the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Box (c0, c1, c2) of a 3-D tensor map into shared memory; its bytes are
// credited to `bar` when they have landed.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// Named barrier `id` among n threads: sync arrives and waits, arrive
// only arrives.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Orders this warpgroup's earlier register and shared-memory accesses
// before the wgmma that follows.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of wgmma are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma's descriptor of a 128-byte-swizzled shared-memory operand
// (layout type 1): start address, leading and stride byte offsets, each
// in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}
// A K-major operand of R rows (a row holds K): k-step ks (16 columns)
// lies in box ks / 4, 32 bytes a step into its 128-byte rows; groups of
// 8 rows are 1024 B apart.
template <int R, typename T>
__device__ __forceinline__ uint64_t kmajor_desc(const T* tile, int ks) {
  return sw128_desc(smem_u32(tile) + (ks >> 2) * R * 128 + (ks & 3) * 32, 16,
                    1024);
}
// An MN-major operand of R rows (a row holds N, rows are K): k-step kk is
// rows 16 kk.. (two groups of 8 rows, 1024 B apart), N-columns 64 nh.. of
// box nh.
template <int R, typename T>
__device__ __forceinline__ uint64_t mnmajor_desc(const T* tile, int kk,
                                                 int nh) {
  return sw128_desc(smem_u32(tile) + nh * R * 128 + kk * 2048, R * 128,
                    1024);
}

// d (+)= A B^T over one k-step on the tensor cores, a warpgroup's 64 x 64
// float32 tile: A (64 x 16) and B (64 x 16) of T, K-major in shared
// memory; `acc` = 0 overwrites d.  With warp w of the warpgroup, g =
// lane / 4 and t = lane % 4, d[4j + e] sits at row 16 w + g + 8 (e / 2)
// and column 8 j + 2 t + e % 2: mma.sync's m16n8 fragment, repeated over
// N.  (TY: the PTX type of T.)
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
#define WGMMA_SS(TY)                                                        \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(da), "l"(db), "r"(acc))
  if constexpr (kF16<T>)
    WGMMA_SS("f16");
  else
    WGMMA_SS("bf16");
#undef WGMMA_SS
}
// The same, 64 x 128: B holds 128 rows.
template <typename T>
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
#define WGMMA_SS128(TY)                                                     \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, " \
      "1, 0, 0;\n}\n"                                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "l"(da), "l"(db), "r"(acc))
  if constexpr (kF16<T>)
    WGMMA_SS128("f16");
  else
    WGMMA_SS128("bf16");
#undef WGMMA_SS128
}
// d += A B over one k-step: A (64 x 16 T) in registers as mma.sync's
// A fragment of each warp's 16 rows, B (16 x 64) MN-major in shared
// memory (the transpose bit).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
#define WGMMA_RS(TY)                                                        \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (kF16<T>)
    WGMMA_RS("f16");
  else
    WGMMA_RS("bf16");
#undef WGMMA_RS
}

// The A fragments of a 64 x 16 KK product's rows as the next product's A
// operand, rounded to T: k-step kk takes columns 16 kk.. (P and dS go
// from one product to the next in registers).
template <typename T, int KK>
__device__ __forceinline__ void acc_to_a_wg(uint32_t (&a)[KK][4],
                                            const float (&d)[8 * KK]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack2<T>(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// Row `row` of a (S, D) T output from half h of a warpgroup
// accumulator (DT / 64 boxes of 64 columns), divided by `div`; D % 8 == 0.
template <int HB, typename T>
__device__ __forceinline__ void store_row_wg(T* out,
                                             const float (&acc)[HB][32],
                                             int h, int row, int D, int t,
                                             float div) {
  T* dst = out + (size_t)row * D;
#pragma unroll
  for (int nh = 0; nh < HB; ++nh)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nh * 64 + j * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(dst + col) = pack2<T>(
            acc[nh][4 * j + 2 * h] / div, acc[nh][4 * j + 2 * h + 1] / div);
    }
}

// The dynamic shared memory from its first 1024-byte boundary: the
// 128-byte swizzle repeats every 8 rows of 128 B, and TMA and wgmma both
// take the pattern from the address bits.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Threads and registers of a Hopper kernel: NC consumer warpgroups, then
// a producer warpgroup whose first warp works; one block an SM.  The
// launch gives each thread ENTRY registers (setmaxnreg counts them a
// warpgroup at a time); the producer gives back all but PRODUCER
// (setmaxnreg.dec), and the consumers take what that frees, up to 240
// (setmaxnreg.inc): at NC = 2, 168 -> 24 and 240, the whole pool.
template <int NC>
struct WgShape {
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int ENTRY = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER = 24;
  static constexpr int FREE =
      (ENTRY * THREADS - 128 * PRODUCER) / (128 * NC) / 8 * 8;
  static constexpr int CONSUMER = FREE > 240 ? 240 : FREE;
  static_assert(CONSUMER >= ENTRY, "setmaxnreg.inc may not shrink");
};

// (Shared memory of fwd_wg_kernel, in bytes from the aligned base: two Q
// buffers (items alternate), then a ring of STAGES (K, V) stages.)
template <int DT, int NC>
struct FwdWg {
  static constexpr int HB = DT / 64, BN = 128, STAGES = DT == 64 ? 4 : 2;
  static constexpr int KBOX = BN * 64;  // elements of a K or V box
  using Shape = WgShape<NC>;
  static constexpr uint32_t Q = 0, K = Q + 2 * NC * HB * BOX_BYTES,
                            V = K + STAGES * HB * KBOX * 2,
                            BARS = V + STAGES * HB * KBOX * 2,
                            BYTES = BARS + 8 * (2 * STAGES + 4) + 1024;
};

// The forward on Hopper, persistent: a block per SM walks work items
// (bh, NC x 64 query rows) b, b + gridDim.x, ..., heaviest causal items
// first.  A producer warp loads each item's Q tile (into one of two
// buffers, so the next item's loads start while this one finishes), then
// the 128-key K and V tiles of its band through a ring of STAGES stages
// (a "full" mbarrier each, completed by TMA's bytes; an "empty" one
// each, completed when every consumer thread has released the stage;
// the same for the Q buffers).  Each consumer warpgroup owns an item's
// 64 query rows: S = Q K^T by SS wgmma (64 x 128, 64 scores a thread:
// the more work a thread holds, the more of each tile's fixed latencies
// it hides), the online softmax in registers (masks and exact
// differences on edge tiles, one FMA before ex2 elsewhere), P packed to
// T into the A registers of O += P V (RS wgmma, V MN-major).  The
// products of one tile overlap the softmax of the next: S of tile j+1
// and P V of tile j are issued together, the softmax of j+1 runs while
// P V does, and O is rescaled once P V has retired.  A warpgroup walks
// the key tiles of its own 64 rows' band and only waits for and releases
// the item's others.
template <typename T, int DT, int NC>
__global__ void __launch_bounds__(FwdWg<DT, NC>::Shape::THREADS, 1)
    fwd_wg_kernel(Args a, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv) {
  using L = FwdWg<DT, NC>;
  using W = typename L::Shape;
  constexpr int HB = L::HB, BM = WG_TILE * NC, BN = L::BN, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* sm = align1024(smem_wg);
  T* sQ = reinterpret_cast<T*>(sm + L::Q);
  T* sK = reinterpret_cast<T*>(sm + L::K);
  T* sV = reinterpret_cast<T*>(sm + L::V);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;  // two each
  uint64_t* qempty = qfull + 2;

  const int S = a.S, D = a.D;
  const int n_qt = (S + BM - 1) / BM, items = a.bh * n_qt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // work item w: query rows q0.. of head bh, heaviest first
  auto item_q0 = [&](int w) { return (n_qt - 1 - w / a.bh) * BM; };
  auto first_kt = [&](int q0) {
    return a.causal && a.window > 0 ? max(0, q0 - (a.window - 1)) / BN : 0;
  };
  auto last_kt = [&](int q0) {
    return a.causal ? (min(q0 + BM, S) - 1) / BN : (S - 1) / BN;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * NC);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 128 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    // the producer warpgroup: its first warp's first lane issues the loads
    setmaxnreg_dec<W::PRODUCER>();
    if (warp > 4 * NC || lane > 0) return;
    int it = 0;  // the block's K/V tiles so far
    for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
      const int bh = w % a.bh, q0 = item_q0(w), qb = j & 1;
      mbar_wait(&qempty[qb], ((j >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(&qfull[qb], NC * HB * BOX_BYTES);
      for (int r = 0; r < NC; ++r)
        for (int h = 0; h < HB; ++h)
          tma_load_3d(sQ + ((qb * NC + r) * HB + h) * BOX, &tq, &qfull[qb],
                      h * 64, q0 + r * WG_TILE, bh);
      for (int kt = first_kt(q0); kt <= last_kt(q0); ++kt, ++it) {
        const int st = it % ST;
        mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * HB * L::KBOX * 2);
        for (int h = 0; h < HB; ++h) {
          tma_load_3d(sK + (st * HB + h) * L::KBOX, &tk, &full[st], h * 64,
                      kt * BN, bh);
          tma_load_3d(sV + (st * HB + h) * L::KBOX, &tv, &full[st], h * 64,
                      kt * BN, bh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows qw.. of each item
  setmaxnreg_inc<W::CONSUMER>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int rw = (warp & 3) * 16;  // this warp's rows in the tile
  // this warpgroup's key tiles for rows qw..: its rows' band; none past S
  auto first_own = [&](int qw) { return first_kt(qw); };
  auto last_own = [&](int qw) {
    return qw >= S     ? -1
           : a.causal ? (min(qw + WG_TILE, S) - 1) / BN
                      : (S - 1) / BN;
  };
  // Ping-pong (two warpgroups): they take turns at issuing their
  // products, warpgroup w after named barrier 1 + w, opening 1 + (1 - w)
  // when issued, so that one's softmax runs under the other's products.
  // Warpgroup 1's first arrival lets warpgroup 0 go first; in an item
  // where the two walk different numbers of tiles (a window, rows past
  // S) they do not take turns, and the turns stay balanced.
  if constexpr (NC == 2)
    if (wg == 1) named_bar_arrive(1, 256);
  int it = 0;  // the block's K/V tiles so far
  for (int w = blockIdx.x, j = 0; w < items; w += gridDim.x, ++j) {
    const int bh = w % a.bh, q0 = item_q0(w), qb = j & 1;
    const int qw = q0 + wg * WG_TILE;
    const int kt_begin = first_kt(q0), kt_end = last_kt(q0), base = it;
    it += kt_end - kt_begin + 1;
    const T* cQ = sQ + (qb * NC + wg) * HB * BOX;
    const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
    const float* qm =
        a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S
                : nullptr;
    const int kb = first_own(qw), ke = last_own(qw);
    const bool pp = NC == 2 && ke - kb == last_own(q0 + WG_TILE * (wg ^ 1)) -
                                               first_own(q0 + WG_TILE * (wg ^ 1));
    auto turn = [&]() {
      if (pp) named_bar_sync(1 + wg, 256);
    };
    auto pass = [&]() {
      if (pp) named_bar_arrive(1 + (wg ^ 1), 256);
    };
    // the ring's stage of key tile kt of this item
    auto slot = [&](int kt) { return (base + kt - kt_begin) % ST; };
    auto wait_full = [&](int kt) {
      mbar_wait(&full[slot(kt)], ((base + kt - kt_begin) / ST) & 1);
    };
    auto release = [&](int kt) { mbar_arrive(&empty[slot(kt)]); };

    float o[HB][32];
#pragma unroll
    for (int nh = 0; nh < HB; ++nh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nh][i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    // S = Q K^T of tile kt into s (issued, committed, not waited for)
    auto issue_s = [&](float (&s)[64], int kt) {
#pragma unroll
      for (int ks = 0; ks < DT / 16; ++ks)
        wgmma_ss128<T>(s, kmajor_desc<64>(cQ, ks),
                    kmajor_desc<BN>(sK + slot(kt) * HB * L::KBOX, ks),
                    ks > 0);
      wgmma_commit();
    };
    // O += P V of tile kt (issued, committed)
    auto issue_pv = [&](const uint32_t (&pa)[BN / 16][4], int kt) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int nh = 0; nh < HB; ++nh)
          wgmma_rs<T>(o[nh], pa[kk],
                   mnmajor_desc<BN>(sV + slot(kt) * HB * L::KBOX, kk, nh));
      wgmma_commit();
    };
    // The scores of tile kt and the online softmax over rows g (h = 0)
    // and g + 8 (h = 1): s becomes P, m and l move on, alpha rescales O.
    // A tile that the diagonal or the end of S cuts ("ragged") without
    // masks or a window keeps the one-FMA path: its cut scores become
    // -inf, exactly as the floor gives them, since each of its rows keeps
    // a key (its max is a score).  Masks and windows ("edge") take the
    // scores per element and exact differences.
    auto softmax = [&](float (&s)[64], int kt, float (&alpha)[2]) {
      const int k0 = kt * BN;
      const bool ragged = k0 + BN > S || qw + WG_TILE > S ||
                          (a.causal && k0 + BN - 1 > qw);
      const bool edge =
          kmask || qm ||
          (a.causal && a.window > 0 &&
           (ragged || qw + WG_TILE - 1 - k0 >= a.window));
      if (edge) {
#pragma unroll
        for (int j8 = 0; j8 < BN / 8; ++j8)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * j8 + e] = tc_score(s[4 * j8 + e], a.scale, kmask, qm,
                                     qw + rw + g + (e >> 1) * 8,
                                     k0 + j8 * 8 + 2 * t + (e & 1), S,
                                     a.causal, a.window);
      } else if (ragged) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qi = qw + rw + g + 8 * h;  // its last key:
          const int last = qi >= S ? -1 : a.causal ? min(qi, S - 1) : S - 1;
#pragma unroll
          for (int j8 = 0; j8 < BN / 8; ++j8)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e)
              if (k0 + j8 * 8 + 2 * t + (e & 1) > last)
                s[4 * j8 + e] = -INFINITY;
        }
      }
      const float sc = edge ? 1.f : a.scale;  // s * sc: the score
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j8 = 0; j8 < BN / 8; ++j8)
          mx = fmaxf(mx, fmaxf(s[4 * j8 + 2 * h], s[4 * j8 + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx * sc);
        alpha[h] = ex2((m[h] - m_new) * LOG2E);
        const float scl = sc * LOG2E, ml = m_new * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j8 = 0; j8 < BN / 8; ++j8)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            float& x = s[4 * j8 + e];
            x = ex2(edge ? (x - m_new) * LOG2E : fmaf(x, scl, -ml));
            sum += x;
          }
        l[h] = l[h] * alpha[h] + sum;  // this thread's part of the row sum
        m[h] = m_new;
      }
    };
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int nh = 0; nh < HB; ++nh)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[nh][i] *= alpha[(i >> 1) & 1];
    };

    // the item's tiles before this warpgroup's band: wait and release
    for (int kt = kt_begin; kt < kb && kt <= kt_end; ++kt) {
      wait_full(kt);
      release(kt);
    }
    mbar_wait(&qfull[qb], (j >> 1) & 1);
    if (kb <= ke) {
      float s[64], alpha[2];
      uint32_t pa[BN / 16][4];
      wait_full(kb);
      turn();
      wgmma_fence();
      issue_s(s, kb);
      pass();
      wgmma_wait<0>();
      wgmma_hold(s);
      softmax(s, kb, alpha);
      acc_to_a_wg<T>(pa, s);
      for (int kt = kb + 1; kt <= ke; ++kt) {
        wait_full(kt);
        turn();
        wgmma_fence();
        issue_s(s, kt);        // S of this tile ...
        issue_pv(pa, kt - 1);  // ... then P V of the last one
        pass();
        wgmma_wait<1>();       // S has landed; P V runs on
        wgmma_hold(s);
        softmax(s, kt, alpha);
        wgmma_wait<0>();
#pragma unroll
        for (int nh = 0; nh < HB; ++nh) wgmma_hold(o[nh]);
        release(kt - 1);
        rescale(alpha);
        acc_to_a_wg<T>(pa, s);
      }
      turn();
      wgmma_fence();
      issue_pv(pa, ke);
      pass();
      wgmma_wait<0>();
#pragma unroll
      for (int nh = 0; nh < HB; ++nh) wgmma_hold(o[nh]);
      release(ke);
    }
    mbar_arrive(&qempty[qb]);  // every S of the item has retired
    // the item's tiles after this warpgroup's band
    for (int kt = max(ke + 1, kb); kt <= kt_end; ++kt) {
      wait_full(kt);
      release(kt);
    }

    T* O = (T*)a.out0 + (size_t)bh * S * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = qw + rw + g + 8 * h;
      if (row >= S) continue;
      const float l_safe = lt == 0.f ? 1.f : lt;
      store_row_wg<HB>(O, o, h, row, D, t, l_safe);
      if (t == 0) a.lse_out[(size_t)bh * S + row] = m[h] + logf(l_safe);
    }
  }
}

// (Shared memory of dkv_wg_kernel, in bytes from the aligned base: K and
// V for each consumer, then a ring of STAGES (Q, dO, lse, delta) stages.)
template <int DT, int NC>
struct DkvWg {
  static constexpr int HB = DT / 64, STAGES = DT == 64 ? 6 : 4;
  using Shape = WgShape<NC>;
  static constexpr uint32_t K = 0, V = K + NC * HB * BOX_BYTES,
                            Q = V + NC * HB * BOX_BYTES,
                            DO = Q + STAGES * HB * BOX_BYTES,
                            ROWS = DO + STAGES * HB * BOX_BYTES,
                            BARS = ROWS + 2 * STAGES * WG_TILE * 4,
                            BYTES = BARS + 8 * (2 * STAGES + 1) + 1024;
};

// dK and dV on Hopper: one block per (bh, NC x 64 keys), heaviest causal
// tiles first.  The producer warp loads the block's K and V once, then
// streams the Q and dO tiles of the causal / window band (TMA), with
// their lse and delta rows (cp.async by its 32 lanes, which the stage's
// "full" barrier counts as they land), through the ring.  Each consumer
// warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T by SS wgmma, P^T
// and dS^T formed in registers (dq_tc_kernel's masks) and rounded to
// T into the A registers of dV += P^T dO and dK += dS^T Q (RS wgmma,
// dO and Q MN-major).  dV's product runs while dS^T is formed; this
// tile's dK product while the next P^T is.  No atomics: deterministic.
template <typename T, int DT, int NC>
__global__ void __launch_bounds__(DkvWg<DT, NC>::Shape::THREADS, 1)
    dkv_wg_kernel(Args a, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo) {
  using L = DkvWg<DT, NC>;
  using W = typename L::Shape;
  constexpr int HB = L::HB, BN = WG_TILE * NC, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* sm = align1024(smem_wg);
  T* sK = reinterpret_cast<T*>(sm + L::K);
  T* sV = reinterpret_cast<T*>(sm + L::V);
  T* sQ = reinterpret_cast<T*>(sm + L::Q);
  T* sO = reinterpret_cast<T*>(sm + L::DO);
  float* sL = reinterpret_cast<float*>(sm + L::ROWS);  // lse, a stage each
  float* sDl = sL + ST * WG_TILE;                       // delta
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + ST;
  uint64_t* kvfull = empty + ST;

  const int S = a.S, D = a.D, bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // query tiles that see the block's keys: causal rows q >= k0; with a
  // window, rows q <= k_last + window - 1
  const int qt_begin = a.causal ? k0 / WG_TILE : 0;
  int qt_end = (S - 1) / WG_TILE;
  if (a.causal && a.window > 0)
    qt_end = min(qt_end, (min(k0 + BN, S) - 1 + a.window - 1) / WG_TILE);

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 33);  // 32 lanes' row copies, TMA's bytes
      mbar_init(&empty[i], 128 * NC);
    }
    mbar_init(kvfull, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    // the producer warpgroup: its first warp streams the tiles
    setmaxnreg_dec<W::PRODUCER>();
    if (warp > 4 * NC) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kvfull, 2 * NC * HB * BOX_BYTES);
      for (int r = 0; r < NC; ++r)
        for (int h = 0; h < HB; ++h) {
          tma_load_3d(sK + (r * HB + h) * BOX, &tk, kvfull, h * 64,
                      k0 + r * WG_TILE, bh);
          tma_load_3d(sV + (r * HB + h) * BOX, &tv, kvfull, h * 64,
                      k0 + r * WG_TILE, bh);
        }
    }
    const float* lse = a.lse + (size_t)bh * S;
    const float* delta = a.delta + (size_t)bh * S;
    for (int qt = qt_begin; qt <= qt_end; ++qt) {
      const int i = qt - qt_begin, st = i % ST;
      mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
      // lse and delta of the tile's rows by cp.async (zeros past S), each
      // lane's copies credited to the stage when they land
      for (int r = lane; r < WG_TILE; r += 32) {
        const int row = qt * WG_TILE + r;
        const bool in = row < S;
        cp_async4(sL + st * WG_TILE + r, in ? lse + row : lse, in ? 4 : 0);
        cp_async4(sDl + st * WG_TILE + r, in ? delta + row : delta,
                  in ? 4 : 0);
      }
      cp_async_mbar_arrive(&full[st]);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * HB * BOX_BYTES);
        for (int h = 0; h < HB; ++h) {
          tma_load_3d(sQ + (st * HB + h) * BOX, &tq, &full[st], h * 64,
                      qt * WG_TILE, bh);
          tma_load_3d(sO + (st * HB + h) * BOX, &tdo, &full[st], h * 64,
                      qt * WG_TILE, bh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: keys kw.. of the block
  setmaxnreg_inc<W::CONSUMER>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int rw = (warp & 3) * 16;  // this warp's keys in the tile
  const int kw = k0 + wg * WG_TILE;
  const T* cK = sK + wg * HB * BOX;
  const T* cV = sV + wg * HB * BOX;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;
  // this warpgroup's query tiles: its keys' band; none for keys past S
  const int qb = a.causal ? kw / WG_TILE : 0;
  int qe = kw >= S ? -1 : (S - 1) / WG_TILE;
  if (a.causal && a.window > 0)
    qe = min(qe, (min(kw + WG_TILE, S) - 1 + a.window - 1) / WG_TILE);
  auto wait_full = [&](int qt) {
    const int i = qt - qt_begin;
    mbar_wait(&full[i % ST], (i / ST) & 1);
  };
  auto release = [&](int qt) { mbar_arrive(&empty[(qt - qt_begin) % ST]); };
  auto stage = [&](const T* ring, int qt) {
    return ring + (qt - qt_begin) % ST * HB * BOX;
  };

  float dk[HB][32], dv[HB][32];
#pragma unroll
  for (int nh = 0; nh < HB; ++nh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[nh][i] = dv[nh][i] = 0.f;

  // S^T = K Q^T and dP^T = V dO^T of tile qt: 64 keys x 64 queries
  // (issued, committed)
  auto issue_s = [&](float (&s)[32], float (&dp)[32], int qt) {
#pragma unroll
    for (int ks = 0; ks < DT / 16; ++ks)
      wgmma_ss<T>(s, kmajor_desc<64>(cK, ks), kmajor_desc<64>(stage(sQ, qt), ks),
               ks > 0);
#pragma unroll
    for (int ks = 0; ks < DT / 16; ++ks)
      wgmma_ss<T>(dp, kmajor_desc<64>(cV, ks), kmajor_desc<64>(stage(sO, qt), ks),
               ks > 0);
    wgmma_commit();
  };
  // acc += A B of tile qt, B = dO or Q MN-major (issued, committed)
  auto issue_rs = [&](float (&acc)[HB][32], const uint32_t (&a4)[4][4],
                      const T* ring, int qt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nh = 0; nh < HB; ++nh)
        wgmma_rs<T>(acc[nh], a4[kk], mnmajor_desc<64>(stage(ring, qt), kk, nh));
    wgmma_commit();
  };
  // Whether the diagonal or the end of S cuts tile qt, and whether it
  // takes per-element masks and exact differences (as in the forward:
  // without masks or a window a cut score is -inf, and P^T there 0).
  auto ragged_tile = [&](int qt) {
    const int q0 = qt * WG_TILE;
    return kw + WG_TILE > S || q0 + WG_TILE > S ||
           (a.causal && q0 < kw + WG_TILE - 1);
  };
  auto edge_tile = [&](int qt) {
    const int q0 = qt * WG_TILE;
    return kmask || qm ||
           (a.causal && a.window > 0 &&
            (ragged_tile(qt) || q0 + WG_TILE - 1 - kw >= a.window));
  };

  // the block's tiles before this warpgroup's band: wait and release
  for (int qt = qt_begin; qt < qb && qt <= qt_end; ++qt) {
    wait_full(qt);
    release(qt);
  }
  mbar_wait(kvfull, 0);
  if (qb <= qe) {
    float s[32], dp[32];
    uint32_t pa[4][4], da[4][4];
    // One query tile, its S^T and dP^T landed: dV's product runs while
    // dS^T is formed; then the next tile's S^T and dP^T (when there is
    // one: a compile-time choice, since a wgmma behind a run-time branch
    // makes ptxas serialise every wgmma of the kernel) and this tile's dK
    // product, of which only the first is waited for.
    auto step = [&](int qt, auto next) {
      const int q0 = qt * WG_TILE, st = (qt - qt_begin) % ST;
      const float* cL = sL + st * WG_TILE;
      const float* cDl = sDl + st * WG_TILE;

      // P^T = exp(S^T - lse), rounded to T; dV += P^T dO
      const bool edge = edge_tile(qt);
      if (!edge && ragged_tile(qt)) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kj = kw + rw + g + 8 * h;  // its first query:
          const int first = kj >= S ? S : a.causal ? kj : 0;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              const int qi = q0 + j * 8 + 2 * t + (e & 1);
              if (qi < first || qi >= S) s[4 * j + e] = -INFINITY;
            }
        }
      }
      const float scl = a.scale * LOG2E;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          float& x = s[4 * j + e];
          x = ex2(edge ? (tc_score(x, a.scale, kmask, qm, q0 + c,
                                   kw + rw + g + (e >> 1) * 8, S, a.causal,
                                   a.window) -
                          cL[c]) *
                             LOG2E
                       : fmaf(x, scl, -cL[c] * LOG2E));
        }
      acc_to_a_wg<T>(pa, s);
      wgmma_fence();
      issue_rs(dv, pa, sO, qt);

      // dS^T = P^T (dP^T - delta) scale, rounded to T once dK of the
      // last tile has let go of da (and of its stage)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              s[4 * j + e] * (dp[4 * j + e] - cDl[j * 8 + 2 * t + (e & 1)]) *
              a.scale;
      wgmma_wait<1>();
      if (qt > qb) release(qt - 1);
      acc_to_a_wg<T>(da, dp);

      if constexpr (decltype(next)::value) wait_full(qt + 1);
      wgmma_fence();  // after the wait: no loop between fence and wgmma
      if constexpr (decltype(next)::value) issue_s(s, dp, qt + 1);
      issue_rs(dk, da, sQ, qt);
      if constexpr (decltype(next)::value) {
        wgmma_wait<1>();  // the next S^T and dP^T; dK runs on
        wgmma_hold(s);
        wgmma_hold(dp);
      }
    };
    wait_full(qb);
    wgmma_fence();
    issue_s(s, dp, qb);
    wgmma_wait<0>();
    wgmma_hold(s);
    wgmma_hold(dp);
    for (int qt = qb; qt < qe; ++qt) step(qt, std::true_type());
    step(qe, std::false_type());
    wgmma_wait<0>();
#pragma unroll
    for (int nh = 0; nh < HB; ++nh) {
      wgmma_hold(dv[nh]);
      wgmma_hold(dk[nh]);
    }
    release(qe);
  }
  // the block's tiles after this warpgroup's band
  for (int qt = max(qe + 1, qb); qt <= qt_end; ++qt) {
    wait_full(qt);
    release(qt);
  }

  T* dK = (T*)a.out0 + (size_t)bh * S * D;
  T* dV = (T*)a.out1 + (size_t)bh * S * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw + rw + g + 8 * h;
    if (row >= S) continue;
    store_row_wg<HB>(dK, dk, h, row, D, t, 1.f);
    store_row_wg<HB>(dV, dv, h, row, D, t, 1.f);
  }
}

// ------------------------------------------------------------ launching

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int BR, int DT>
constexpr size_t smem_bytes(int which) {
  return sizeof(float) *
         (which == kFwd ? 3 * BR * (DT + 1) + BR * (BR + 1)
          : which == kDq ? 4 * BR * (DT + 1) + BR * (BR + 1)
                         : 4 * BR * (DT + 1) + 2 * BR * (BR + 1) + 2 * BR);
}

// Raises a kernel's dynamic shared-memory limit to `bytes` the first time
// a launch needs more than the last setting, so the launches a CUDA graph
// captures (after an eager call at the same shapes) set no attribute.
template <auto Kernel>
int allow_smem(size_t bytes) {
  static size_t allowed = 0;
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return (int)err;
}

template <void (*Kernel)(Args)>
int launch_grid(dim3 grid, int nthreads, size_t smem, const Args& a,
                cudaStream_t stream) {
  const int err = allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return err;
  Kernel<<<grid, nthreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int BR, int DT>
int launch(int which, const Args& a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && DT <= 128) {
    // bf16 and float16 at D <= 128: tensor cores only
    return (int)cudaErrorInvalidValue;
  } else {
    const size_t smem = smem_bytes<BR, DT>(which);
    const dim3 grid((unsigned)a.bh * (unsigned)((a.S + BR - 1) / BR));
    if constexpr (BR == 8) {
      if (which == kFwd)
        return launch_grid<fwd_narrow_kernel<T, DT>>(grid, NTHREADS, smem,
                                                     a, stream);
      if (which == kDq)
        return launch_grid<dq_narrow_kernel<T, DT>>(grid, NTHREADS, smem, a,
                                                    stream);
      return launch_grid<dkv_narrow_kernel<T, DT>>(grid, NTHREADS, smem, a,
                                                   stream);
    } else {
      if (which == kFwd)
        return launch_grid<fwd_kernel<T, BR, DT>>(grid, NTHREADS, smem, a,
                                                  stream);
      if (which == kDq)
        return launch_grid<dq_kernel<T, BR, DT>>(grid, NTHREADS, smem, a,
                                                 stream);
      return launch_grid<dkv_kernel<T, BR, DT>>(grid, NTHREADS, smem, a,
                                                stream);
    }
  }
}

// The CUDA-core kernels: float32, bf16 or float16, D <= 1792 (the header gives
// each rung's tile rows and shared memory).
template <typename T>
int dispatch_d(int which, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64, 64>(which, a, stream);
  if (a.D <= 128) return launch<T, 64, 128>(which, a, stream);
  if (a.D <= 256) return launch<T, 32, 256>(which, a, stream);
  if (a.D <= 512) return launch<T, 16, 512>(which, a, stream);
  if (a.D <= 1792) return launch<T, 8, 1792>(which, a, stream);
  return (int)cudaErrorInvalidValue;
}

// dq_tc_kernel over a grid of (bh, 64-row tiles of S).
template <typename T, int DT>
int launch_dq_tc(const Args& a, cudaStream_t stream) {
  constexpr int NW = 4, BM = 16 * NW;
  constexpr size_t smem = sizeof(T) * 4 * TC_BN * DT;
  const int tiles = (a.S + BM - 1) / BM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int err = allow_smem<dq_tc_kernel<T, DT, NW>>(smem);
  if (err != cudaSuccess) return err;
  dq_tc_kernel<T, DT, NW><<<dim3((unsigned)a.bh, (unsigned)tiles), 32 * NW,
                            smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library needs no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A (bh, S, D) T operand (bf16 or float16) as a 3-D tensor map, built at
// each launch and passed to the kernel by value (so a CUDA graph captures
// it with the launch): boxes of `rows` rows x 64 columns of one head,
// 128-byte swizzled; rows past S and columns past D arrive as zeros (a
// 2-D (bh S, D) view would read the next head's rows into a ragged tile).
template <typename T>
int tile_map(CUtensorMap* map, const void* base, const Args& a,
             int rows = 64) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)a.D, (cuuint64_t)a.S,
                              (cuuint64_t)a.bh};
  const cuuint64_t strides[2] = {(cuuint64_t)a.D * sizeof(T),
                                 (cuuint64_t)a.S * a.D * sizeof(T)};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1}, unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map,
      kF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// setmaxnreg.inc waits until the block's pool of registers (the build's
// count for the kernel times its threads) holds what the consumers ask
// for: a build that allotted fewer would hang, so it is refused here.
// (ptxas sets the count at entry: 168 for 384 threads, one block an SM.)
template <auto Kernel, class W>
int check_registers() {
  static int ok = -1;
  if (ok < 0) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, Kernel) != cudaSuccess)
      return (int)cudaErrorInvalidValue;
    ok = attr.numRegs * W::THREADS >=
         W::CONSUMER * (W::THREADS - 128) + W::PRODUCER * 128;
  }
  return ok ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Consumer warpgroups a block of each Hopper kernel: 64 rows each.
constexpr int FWD_WGS = 2, DKV_WGS = 2;

// The card's SMs: the persistent forward's grid.
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <typename T, int DT>
int launch_fwd_wg(const Args& a, cudaStream_t stream) {
  using L = FwdWg<DT, FWD_WGS>;
  CUtensorMap tq, tk, tv;
  const long long items =
      (long long)a.bh * ((a.S + WG_TILE * FWD_WGS - 1) / (WG_TILE * FWD_WGS));
  const int blocks = items < sm_count() ? (int)items : sm_count();
  int err = blocks <= 0 || items > INT32_MAX ? (int)cudaErrorInvalidValue : 0;
  if (!err) err = tile_map<T>(&tq, a.q, a);
  if (!err) err = tile_map<T>(&tk, a.k, a, L::BN);
  if (!err) err = tile_map<T>(&tv, a.v, a, L::BN);
  if (!err)
    err = check_registers<fwd_wg_kernel<T, DT, FWD_WGS>, typename L::Shape>();
  if (!err) err = allow_smem<fwd_wg_kernel<T, DT, FWD_WGS>>(L::BYTES);
  if (err) return err;
  fwd_wg_kernel<T, DT, FWD_WGS><<<blocks, L::Shape::THREADS, L::BYTES,
                               stream>>>(
      a, tq, tk, tv);
  return (int)cudaGetLastError();
}

template <typename T, int DT>
int launch_dkv_wg(const Args& a, cudaStream_t stream) {
  using L = DkvWg<DT, DKV_WGS>;
  CUtensorMap tq, tk, tv, tdo;
  const int tiles = (a.S + WG_TILE * DKV_WGS - 1) / (WG_TILE * DKV_WGS);
  int err = tiles > 65535 ? (int)cudaErrorInvalidValue : 0;
  if (!err) err = tile_map<T>(&tq, a.q, a);
  if (!err) err = tile_map<T>(&tk, a.k, a);
  if (!err) err = tile_map<T>(&tv, a.v, a);
  if (!err) err = tile_map<T>(&tdo, a.dout, a);
  if (!err)
    err = check_registers<dkv_wg_kernel<T, DT, DKV_WGS>, typename L::Shape>();
  if (!err) err = allow_smem<dkv_wg_kernel<T, DT, DKV_WGS>>(L::BYTES);
  if (err) return err;
  dkv_wg_kernel<T, DT, DKV_WGS><<<dim3((unsigned)a.bh, (unsigned)tiles),
                               L::Shape::THREADS, L::BYTES, stream>>>(
      a, tq, tk, tv, tdo);
  return (int)cudaGetLastError();
}

// The tensor-core kernels: bf16 or float16, D <= 128, read through TMA: D a
// multiple of 8 and 16-byte aligned bases (the wrapper pads any other D).
template <typename T>
int dispatch_tc(int which, const Args& a, cudaStream_t stream) {
  const uintptr_t ptrs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                         (uintptr_t)a.dout;
  if (a.D % 8 != 0 || ptrs % 16 != 0) return (int)cudaErrorInvalidValue;
  if (which == kFwd && a.D <= 64) return launch_fwd_wg<T, 64>(a, stream);
  if (which == kFwd && a.D <= 128) return launch_fwd_wg<T, 128>(a, stream);
  if (which == kDq && a.D <= 64) return launch_dq_tc<T, 64>(a, stream);
  if (which == kDq && a.D <= 128) return launch_dq_tc<T, 128>(a, stream);
  if (which == kDkv && a.D <= 64) return launch_dkv_wg<T, 64>(a, stream);
  if (which == kDkv && a.D <= 128) return launch_dkv_wg<T, 128>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// kind: 0 = float32 on CUDA cores, 1 = bf16 on CUDA cores (D > 128), 2 =
// bf16 on tensor cores (D <= 128), 3 = float16 on CUDA cores (D > 128), 4
// = float16 on tensor cores (D <= 128).  The caller chooses; a kind that
// does not take the call returns cudaErrorInvalidValue.
int dispatch(int which, int kind, const Args& a, void* stream) {
  if (a.bh <= 0 || a.S <= 0 || a.D <= 0) return 0;  // nothing to do
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) return dispatch_d<float>(which, a, st);
  if (kind == 1) return dispatch_d<bf16>(which, a, st);
  if (kind == 2) return dispatch_tc<bf16>(which, a, st);
  if (kind == 3) return dispatch_d<f16>(which, a, st);
  if (kind == 4) return dispatch_tc<f16>(which, a, st);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v,
               const float* kmask, const float* qmask, int qdiv, int qmod,
               int bh, int S, int D, float scale, int causal, int window) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.kmask = kmask;
  a.qmask = qmask;
  a.qdiv = qdiv > 0 ? qdiv : 1;
  a.qmod = qmod > 0 ? qmod : 1;
  a.bh = bh;
  a.S = S;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  return a;
}

}  // namespace

extern "C" {

// q, k, v, o: (bh, S, D) contiguous; lse: (bh, S) float32.
int flash_fwd(const void* q, const void* k, const void* v, const float* kmask,
              const float* qmask, int qdiv, int qmod, void* o, float* lse,
              int bh, int S, int D, float scale, int causal, int window,
              int kind, void* stream) {
  Args a = make_args(q, k, v, kmask, qmask, qdiv, qmod, bh, S, D, scale,
                     causal, window);
  a.out0 = o;
  a.lse_out = lse;
  return dispatch(kFwd, kind, a, stream);
}

// dq: (bh, S, D); lse, delta: (bh, S) float32.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const float* kmask, const float* qmask, int qdiv, int qmod,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int bh, int S, int D, float scale, int causal,
                 int window, int kind, void* stream) {
  Args a = make_args(q, k, v, kmask, qmask, qdiv, qmod, bh, S, D, scale,
                     causal, window);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out0 = dq;
  return dispatch(kDq, kind, a, stream);
}

// dk, dv: (bh, S, D).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const float* kmask, const float* qmask, int qdiv, int qmod,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int bh, int S, int D, float scale,
                  int causal, int window, int kind, void* stream) {
  Args a = make_args(q, k, v, kmask, qmask, qdiv, qmod, bh, S, D, scale,
                     causal, window);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out0 = dk;
  a.out1 = dv;
  return dispatch(kDkv, kind, a, stream);
}

}  // extern "C"
