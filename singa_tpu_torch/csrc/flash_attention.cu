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
//   * under bf16, p is rounded to V's (dO's) type before P V (P^T dO) and
//     dS to K's (Q's) type before dS K (dS^T Q), as the Pallas kernels
//     cast before their dots; every sum is kept in float32.
//
// Design for the GPU (not a block-by-block copy of the TPU schedule):
//   * the TPU's sequential key-block grid axis becomes a loop inside one
//     CUDA block; its bounds stop at the causal diagonal and start at the
//     window band, so skipped tiles cost nothing (no idle grid steps);
//   * the online-softmax state and the O / dQ / dK / dV accumulators
//     live in registers, float32 (the tiles of each family: below);
//   * the ragged tail is masked in the kernel: any S and any D <= 1792,
//     no padding; key columns past S contribute p = 0, rows past S are
//     not written; scale = 1/sqrt(D) of the true D comes from the caller;
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
//   * kind 2, bf16 with D <= 128 -- tensor cores, all three kernels:
//       fwd_tc_kernel  <- _flash_fwd_pallas (_fwd_kernel)
//       dq_tc_kernel   <- _flash_bwd_pallas, dQ call (_dq_kernel)
//       dkv_tc_kernel  <- _flash_bwd_pallas, dK/dV call (_dkv_kernel)
//     FlashAttention-2's structure on mma.sync.m16n8k16 (bf16 in, f32
//     sums).  Operands stay bf16 in shared memory, in rows of DT = 64 or
//     128 elements (D zero-filled up to DT) whose 16-byte chunks are
//     XOR-swizzled by row, so ldmatrix reads them without bank
//     conflicts.  Tiles arrive by cp.async (16 bytes a thread, zero-fill
//     past S and D; element loads when D % 8 != 0) into two stages: tile
//     i + 1 loads while tile i computes, one __syncthreads per tile.
//     Only tiles on the causal diagonal, at a window's edge, at the
//     ragged end of S, or under a mask apply per-element masks and
//     exponentiate exact differences (scores at the NEG_INF floor); the
//     others fold the scale into one FMA before a single ex2.
//     - fwd_tc_kernel<DT, 4>: one block of 4 warps per (bh, 64-row query
//       tile), heaviest causal tiles first; each warp owns 16 query rows
//       and keeps their Q fragments in registers.  S = Q K^T lands in
//       registers, the online-softmax max and sum reduce over the 4
//       threads of a fragment row with shuffles, and P is packed to bf16
//       straight into the A fragment of P V (V read by ldmatrix.trans):
//       no shared-memory round trip for P, no barrier between the two
//       products.  Key tiles of 64.  Shared memory (64 + 4 * 64) * DT * 2
//       B = 40 KB at DT = 64, 80 KB at DT = 128.  At DT = 64 it is held
//       to 128 registers (16 warps on an SM), which spills 44 B; DT = 128:
//       203 registers, no spills.
//     - dq_tc_kernel<DT, 4>: the forward's grid and warps; each warp keeps
//       the Q and dO fragments of its 16 rows, and their lse and delta, in
//       registers.  Per 64-key tile S = Q K^T and dP = dO V^T on the
//       tensor cores, P = 2^(S scale log2 e - lse log2 e) and dS = P (dP -
//       delta) scale in registers, dS packed to bf16 into the A fragment
//       of dQ += dS K (K read by ldmatrix.trans).  dQ written once, no
//       atomics.  Q and dO pass once through the second K / V stage, so
//       shared memory is 2 stages x (K + V) x 64 x DT x 2 B = 32 KB at
//       DT = 64, 64 KB at DT = 128.
//     - dkv_tc_kernel<DT, 4>: one block of 4 warps per (bh, 64-key tile),
//       each warp owning 16 keys with their dK and dV sums in registers,
//       walking the 32-row query tiles of the causal / window band.
//       S^T = K Q^T and dP^T = V dO^T on the tensor cores, P^T and dS^T
//       formed in registers and packed into the A fragments of
//       dV += P^T dO and dK += dS^T Q (dO and Q read by ldmatrix.trans).
//       No atomics: deterministic.  Q, dO, lse and delta are
//       double-buffered; shared memory (2 * 64 + 4 * 32) * DT * 2 B +
//       512 B = 33 KB at DT = 64, 66 KB at DT = 128.  168 / 252 registers,
//       no spills.
//     (Registers and spills: nvcc -Xptxas -v for sm_90a, as chip_smoke.py's
//     build phase reports them; times and bounds: PERF.md.)
//   * kinds 0 and 1, float32 (tensor cores would need TF32, which misses
//     the float32 tolerance) and bf16 with 128 < D <= 1792 -- CUDA cores:
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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
  int vec;             // D % 8 == 0 and q, k, v, dO 16-byte aligned
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

// ------------------------------------------- tensor-core kernels (bf16)

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TC_BN = 64;  // keys per tile of fwd_tc_kernel
constexpr int TC_BQ = 32;  // query rows per tile of dkv_tc_kernel

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

// 2^x in one special-function instruction (results below 2^-126 flush
// to 0; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (the cast the Pallas kernels make before a
// dot), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 bf16 tile from two 16x8 float32
// accumulators (columns 0-7 and 8-15): P and dS go from one product to
// the next in registers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Element offset of 16-byte chunk c of row r in a tile with rows DT bf16
// wide: the chunk index is XORed with r % 8, so the 8 rows an ldmatrix
// matrix reads at one logical chunk lie in 8 different bank groups.
template <int DT>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DT + ((c ^ (r & 7)) << 3);
}

// Rows [row0, row0 + R) of a (S, D) bf16 matrix into a swizzled tile of
// width DT: cp.async when `vec`, else element loads; zeros past S and D.
template <int R, int DT, int NT>
__device__ __forceinline__ void load_tile_tc(bf16* dst, const bf16* src,
                                             int row0, int S, int D,
                                             bool vec) {
  constexpr int CH = DT / 8;
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH, row = row0 + r, col = c * 8;
    bf16* d = dst + swz<DT>(r, c);
    if (vec) {
      const bool in = row < S && col < D;
      cp_async16(d, in ? src + (size_t)row * D + col : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = row < S && col + e < D ? src[(size_t)row * D + col + e]
                                      : __float2bfloat16_rn(0.f);
    }
  }
}

// Entries [row0, row0 + R) of a (S,) float32 row vector; zeros past S.
template <int R, int NT>
__device__ __forceinline__ void load_rows_tc(float* dst, const float* src,
                                             int row0, int S) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const bool in = row0 + r < S;
    cp_async4(dst + r, in ? src + row0 + r : src, in ? 4 : 0);
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

// Row `row` of a (S, D) bf16 output from a thread's two accumulator
// columns per 8-column block, divided by `div`.
template <int DB>
__device__ __forceinline__ void store_row_tc(bf16* out, const float (&acc)[DB][4],
                                             int half, int row, int D, int t,
                                             float div) {
  bf16* dst = out + (size_t)row * D;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int col = db * 8 + 2 * t;
    const float x0 = acc[db][2 * half] / div, x1 = acc[db][2 * half + 1] / div;
    if ((D & 1) == 0) {
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(x0, x1);
    } else {
      if (col < D) dst[col] = __float2bfloat16_rn(x0);
      if (col + 1 < D) dst[col + 1] = __float2bfloat16_rn(x1);
    }
  }
}

// (At DT = 64, at most 128 registers: 16 warps on an SM.)
template <int DT, int NW>
__global__ void __launch_bounds__(NW * 32, DT == 64 ? 16 / NW : 1)
    fwd_tc_kernel(Args a) {
  constexpr int BM = 16 * NW, BN = TC_BN, NT = 32 * NW;
  constexpr int KS = DT / 16, NB = BN / 8, DB = DT / 8;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sK = sQ + BM * DT;      // two stages
  bf16* sV = sK + 2 * BN * DT;  // two stages

  const int S = a.S, D = a.D;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16;
  const size_t base = (size_t)bh * S * D;
  const bf16* Q = (const bf16*)a.q + base;
  const bf16* K = (const bf16*)a.k + base;
  const bf16* V = (const bf16*)a.v + base;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;
  const bool vec = a.vec;

  const int q_last = min(q0 + BM, S) - 1;
  const int kt_end = a.causal ? q_last / BN : (S - 1) / BN;
  int kt_begin = 0;
  if (a.causal && a.window > 0) kt_begin = max(0, q0 - (a.window - 1)) / BN;

  load_tile_tc<BM, DT, NT>(sQ, Q, q0, S, D, vec);
  cp_async_commit();
  load_tile_tc<BN, DT, NT>(sK, K, kt_begin * BN, S, D, vec);
  load_tile_tc<BN, DT, NT>(sV, V, kt_begin * BN, S, D, vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], smem_u32(sQ + swz<DT>(rw + (lane & 15), 2 * ks + (lane >> 4))));

  float o[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BN, st = (kt - kt_begin) & 1;
    const bf16* cK = sK + st * BN * DT;
    const bf16* cV = sV + st * BN * DT;
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    if (kt < kt_end) {
      load_tile_tc<BN, DT, NT>(sK + (st ^ 1) * BN * DT, K, k0 + BN, S, D, vec);
      load_tile_tc<BN, DT, NT>(sV + (st ^ 1) * BN * DT, V, k0 + BN, S, D, vec);
      cp_async_commit();
    }

    // S = Q K^T: this warp's 16 rows x BN keys
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(cK + swz<DT>(j * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         2 * ks + ((lane >> 3) & 1))));
        mma_bf16(s[2 * j], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * j + 1], qf[ks], b[2], b[3]);
      }
    }

    // Scores and the online softmax over rows g (h = 0) and g + 8
    // (h = 1).  A tile on the diagonal, a window's edge, the end of S or
    // under a mask takes masked_score's value per element and
    // exponentiates differences, so that scores at the NEG_INF floor give
    // exactly 1 against a max at the floor; any other tile folds the
    // scale into one FMA (a max above the floor, every score finite).
    const bool edge =
        kmask || qm || k0 + BN > S || q0 + BM > S ||
        (a.causal && (k0 + BN - 1 > q0 ||
                      (a.window > 0 && q0 + BM - 1 - k0 >= a.window)));
    if (edge) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = tc_score(s[j][e], a.scale, kmask, qm,
                             q0 + rw + g + (e >> 1) * 8,
                             k0 + j * 8 + 2 * t + (e & 1), S, a.causal,
                             a.window);
    }
    const float sc = edge ? 1.f : a.scale;  // s * sc: the score
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * sc);
      const float alpha = ex2((m[h] - m_new) * LOG2E);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e)
            s[j][e] = (s[j][e] - m_new) * LOG2E;
      } else {
        const float scl = a.scale * LOG2E, ml = m_new * LOG2E;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e)
            s[j][e] = fmaf(s[j][e], scl, -ml);
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = ex2(s[j][e]);
          sum += s[j][e];
        }
      l[h] = l[h] * alpha + sum;  // this thread's part of the row sum
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DB / 2; ++j) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(cV + swz<DT>(kk * 16 + (lane & 7) +
                                               (((lane >> 3) & 1) << 3),
                                           2 * j + (lane >> 4))));
        mma_bf16(o[2 * j], pa, b[0], b[1]);
        mma_bf16(o[2 * j + 1], pa, b[2], b[3]);
      }
    }
  }

  bf16* O = (bf16*)a.out0 + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + rw + g + 8 * h;
    if (row >= S) continue;
    const float l_safe = lt == 0.f ? 1.f : lt;
    store_row_tc<DB>(O, o, h, row, D, t, l_safe);
    if (t == 0) a.lse_out[(size_t)bh * S + row] = m[h] + logf(l_safe);
  }
}

// (At DT = 64, at most 168 registers: 3 blocks of 4 warps on an SM.)
template <int DT, int NW>
__global__ void __launch_bounds__(NW * 32, DT == 64 ? 3 : 1)
    dkv_tc_kernel(Args a) {
  constexpr int BN = 16 * NW, BM = TC_BQ, NT = 32 * NW;
  constexpr int KS = DT / 16, NB = BM / 8, DB = DT / 8;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sK = reinterpret_cast<bf16*>(smem_tc);
  bf16* sV = sK + BN * DT;
  bf16* sQ = sV + BN * DT;       // two stages
  bf16* sO = sQ + 2 * BM * DT;   // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * BM * DT);  // lse, two stages
  float* sDl = sL + 2 * BM;                                 // delta, two

  const int S = a.S, D = a.D;
  const int bh = blockIdx.x, k0 = blockIdx.y * BN;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16;
  const size_t base = (size_t)bh * S * D;
  const bf16* Q = (const bf16*)a.q + base;
  const bf16* K = (const bf16*)a.k + base;
  const bf16* V = (const bf16*)a.v + base;
  const bf16* dO = (const bf16*)a.dout + base;
  const float* lse = a.lse + (size_t)bh * S;
  const float* delta = a.delta + (size_t)bh * S;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;
  const bool vec = a.vec;

  // query tiles that see this key tile: causal rows q >= k0; with a
  // window, rows q <= k_last + window - 1
  const int k_last = min(k0 + BN, S) - 1;
  const int qt_begin = a.causal ? k0 / BM : 0;
  int qt_end = (S - 1) / BM;
  if (a.causal && a.window > 0)
    qt_end = min(qt_end, (k_last + a.window - 1) / BM);

  load_tile_tc<BN, DT, NT>(sK, K, k0, S, D, vec);
  load_tile_tc<BN, DT, NT>(sV, V, k0, S, D, vec);
  load_tile_tc<BM, DT, NT>(sQ, Q, qt_begin * BM, S, D, vec);
  load_tile_tc<BM, DT, NT>(sO, dO, qt_begin * BM, S, D, vec);
  load_rows_tc<BM, NT>(sL, lse, qt_begin * BM, S);
  load_rows_tc<BM, NT>(sDl, delta, qt_begin * BM, S);
  cp_async_commit();

  float dk[DB][4], dv[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int qt = qt_begin; qt <= qt_end; ++qt) {
    const int q0 = qt * BM, st = (qt - qt_begin) & 1;
    const bf16* cQ = sQ + st * BM * DT;
    const bf16* cO = sO + st * BM * DT;
    const float* cL = sL + st * BM;
    const float* cDl = sDl + st * BM;
    cp_async_wait<0>();
    __syncthreads();  // tile qt landed; every warp is done with tile qt-1
    if (qt < qt_end) {
      const int n0 = q0 + BM, ns = st ^ 1;
      load_tile_tc<BM, DT, NT>(sQ + ns * BM * DT, Q, n0, S, D, vec);
      load_tile_tc<BM, DT, NT>(sO + ns * BM * DT, dO, n0, S, D, vec);
      load_rows_tc<BM, NT>(sL + ns * BM, lse, n0, S);
      load_rows_tc<BM, NT>(sDl + ns * BM, delta, n0, S);
      cp_async_commit();
    }

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BM queries
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ak[4], av[4];
      const int arow = rw + (lane & 15), achunk = 2 * ks + (lane >> 4);
      ldsm_x4(ak, smem_u32(sK + swz<DT>(arow, achunk)));
      ldsm_x4(av, smem_u32(sV + swz<DT>(arow, achunk)));
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) {
        const int off = swz<DT>(j * 16 + (lane & 7) + ((lane >> 4) << 3),
                                2 * ks + ((lane >> 3) & 1));
        uint32_t b[4];
        ldsm_x4(b, smem_u32(cQ + off));
        mma_bf16(s[2 * j], ak, b[0], b[1]);
        mma_bf16(s[2 * j + 1], ak, b[2], b[3]);
        ldsm_x4(b, smem_u32(cO + off));
        mma_bf16(dp[2 * j], av, b[0], b[1]);
        mma_bf16(dp[2 * j + 1], av, b[2], b[3]);
      }
    }

    // P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) scale, in
    // place; per-element masks and exact differences only on the tiles
    // that need them, as in the forward
    const bool edge =
        kmask || qm || k0 + BN > S || q0 + BM > S ||
        (a.causal && (q0 < k0 + BN - 1 ||
                      (a.window > 0 && q0 + BM - 1 - k0 >= a.window)));
    if (edge) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          const float x = tc_score(s[j][e], a.scale, kmask, qm, q0 + c,
                                   k0 + rw + g + (e >> 1) * 8, S, a.causal,
                                   a.window);
          s[j][e] = (x - cL[c]) * LOG2E;
        }
    } else {
      const float scl = a.scale * LOG2E;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = fmaf(s[j][e], scl, -cL[j * 8 + 2 * t + (e & 1)] * LOG2E);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        s[j][e] = ex2(s[j][e]);
        dp[j][e] = s[j][e] * (dp[j][e] - cDl[c]) * a.scale;
      }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DB / 2; ++j) {
        const int off = swz<DT>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                2 * j + (lane >> 4));
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(cO + off));
        mma_bf16(dv[2 * j], pa, b[0], b[1]);
        mma_bf16(dv[2 * j + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, smem_u32(cQ + off));
        mma_bf16(dk[2 * j], da, b[0], b[1]);
        mma_bf16(dk[2 * j + 1], da, b[2], b[3]);
      }
    }
  }

  bf16* dK = (bf16*)a.out0 + base;
  bf16* dV = (bf16*)a.out1 + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + rw + g + 8 * h;
    if (row >= S) continue;
    store_row_tc<DB>(dK, dk, h, row, D, t, 1.f);
    store_row_tc<DB>(dV, dv, h, row, D, t, 1.f);
  }
}

// (At DT = 64, at most 168 registers: 3 blocks of 4 warps on an SM.)
template <int DT, int NW>
__global__ void __launch_bounds__(NW * 32, DT == 64 ? 3 : 1)
    dq_tc_kernel(Args a) {
  constexpr int BM = 16 * NW, BN = TC_BN, NT = 32 * NW;
  constexpr int KS = DT / 16, NB = BN / 8, DB = DT / 8;
  static_assert(BM == BN, "Q and dO are staged in a K / V stage buffer");
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sK = reinterpret_cast<bf16*>(smem_tc);  // two stages
  bf16* sV = sK + 2 * BN * DT;                  // two stages

  const int S = a.S, D = a.D;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16;
  const size_t base = (size_t)bh * S * D;
  const bf16* Q = (const bf16*)a.q + base;
  const bf16* K = (const bf16*)a.k + base;
  const bf16* V = (const bf16*)a.v + base;
  const bf16* dO = (const bf16*)a.dout + base;
  const float* kmask = a.kmask ? a.kmask + (size_t)bh * S : nullptr;
  const float* qm =
      a.qmask ? a.qmask + (size_t)((bh / a.qdiv) % a.qmod) * S * S : nullptr;
  const bool vec = a.vec;

  const int q_last = min(q0 + BM, S) - 1;
  const int kt_end = a.causal ? q_last / BN : (S - 1) / BN;
  int kt_begin = 0;
  if (a.causal && a.window > 0) kt_begin = max(0, q0 - (a.window - 1)) / BN;

  // Q and dO go through stage 1 once, into registers; key tile kt_begin
  // into stage 0.  Stage 1 takes key tile kt_begin + 1 only after the
  // first barrier of the loop, when every warp holds its fragments.
  load_tile_tc<BM, DT, NT>(sK + BN * DT, Q, q0, S, D, vec);
  load_tile_tc<BM, DT, NT>(sV + BN * DT, dO, q0, S, D, vec);
  cp_async_commit();
  load_tile_tc<BN, DT, NT>(sK, K, kt_begin * BN, S, D, vec);
  load_tile_tc<BN, DT, NT>(sV, V, kt_begin * BN, S, D, vec);
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
    const bf16* cK = sK + st * BN * DT;
    const bf16* cV = sV + st * BN * DT;
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    if (kt < kt_end) {
      load_tile_tc<BN, DT, NT>(sK + (st ^ 1) * BN * DT, K, k0 + BN, S, D, vec);
      load_tile_tc<BN, DT, NT>(sV + (st ^ 1) * BN * DT, V, k0 + BN, S, D, vec);
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
        mma_bf16(s[2 * j], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * j + 1], qf[ks], b[2], b[3]);
        ldsm_x4(b, smem_u32(cV + off));
        mma_bf16(dp[2 * j], of[ks], b[0], b[1]);
        mma_bf16(dp[2 * j + 1], of[ks], b[2], b[3]);
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

    // dQ += dS K, dS rounded to bf16 (K read by ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DB / 2; ++j) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(cK + swz<DT>(kk * 16 + (lane & 7) +
                                               (((lane >> 3) & 1) << 3),
                                           2 * j + (lane >> 4))));
        mma_bf16(dq[2 * j], da, b[0], b[1]);
        mma_bf16(dq[2 * j + 1], da, b[2], b[3]);
      }
    }
  }

  bf16* dQ = (bf16*)a.out0 + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rw + g + 8 * h;
    if (row < S) store_row_tc<DB>(dQ, dq, h, row, D, t, 1.f);
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
template <void (*Kernel)(Args)>
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
  if constexpr (std::is_same_v<T, bf16> && DT <= 128) {
    return (int)cudaErrorInvalidValue;  // bf16 at D <= 128: tensor cores only
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

// The CUDA-core kernels: float32 or bf16, D <= 1792 (the header gives
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

// One tensor-core kernel over a grid of (bh, tiles of S).
template <void (*Kernel)(Args)>
int launch_tc(int tile, size_t smem, int nthreads, const Args& a,
              cudaStream_t stream) {
  const int tiles = (a.S + tile - 1) / tile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int err = allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return err;
  Kernel<<<dim3((unsigned)a.bh, (unsigned)tiles), nthreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_fwd_tc(const Args& a, cudaStream_t stream) {
  constexpr int NW = 4, BM = 16 * NW;
  return launch_tc<fwd_tc_kernel<DT, NW>>(
      BM, sizeof(bf16) * (BM + 4 * TC_BN) * DT, 32 * NW, a, stream);
}

template <int DT>
int launch_dq_tc(const Args& a, cudaStream_t stream) {
  constexpr int NW = 4, BM = 16 * NW;
  return launch_tc<dq_tc_kernel<DT, NW>>(
      BM, sizeof(bf16) * 4 * TC_BN * DT, 32 * NW, a, stream);
}

template <int DT>
int launch_dkv_tc(const Args& a, cudaStream_t stream) {
  constexpr int NW = 4, BN = 16 * NW;
  return launch_tc<dkv_tc_kernel<DT, NW>>(
      BN,
      sizeof(bf16) * (2 * BN + 4 * TC_BQ) * DT + sizeof(float) * 4 * TC_BQ,
      32 * NW, a, stream);
}

// The tensor-core kernels: bf16, D <= 128.
int dispatch_tc(int which, const Args& a, cudaStream_t stream) {
  if (which == kFwd && a.D <= 64) return launch_fwd_tc<64>(a, stream);
  if (which == kFwd && a.D <= 128) return launch_fwd_tc<128>(a, stream);
  if (which == kDq && a.D <= 64) return launch_dq_tc<64>(a, stream);
  if (which == kDq && a.D <= 128) return launch_dq_tc<128>(a, stream);
  if (which == kDkv && a.D <= 64) return launch_dkv_tc<64>(a, stream);
  if (which == kDkv && a.D <= 128) return launch_dkv_tc<128>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// kind: 0 = float32 on CUDA cores, 1 = bf16 on CUDA cores (D > 128), 2 =
// bf16 on tensor cores (D <= 128).  The caller chooses; a kind that does
// not take the call returns cudaErrorInvalidValue.
int dispatch(int which, int kind, Args a, void* stream) {
  if (a.bh <= 0 || a.S <= 0 || a.D <= 0) return 0;  // nothing to do
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t ptrs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                         (uintptr_t)a.dout;
  a.vec = a.D % 8 == 0 && ptrs % 16 == 0;
  if (kind == 0) return dispatch_d<float>(which, a, st);
  if (kind == 1) return dispatch_d<bf16>(which, a, st);
  if (kind == 2) return dispatch_tc(which, a, st);
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
