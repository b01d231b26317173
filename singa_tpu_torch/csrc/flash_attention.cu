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
//   * one block of 256 threads per (bh, 64-row tile) (32 rows when
//     D > 128), Q/K/V/dO tiles staged in shared memory as float32 with an
//     odd row stride (no bank conflicts), the online-softmax state and
//     the O / dQ / dK / dV accumulators in registers, float32;
//   * the ragged tail is masked in the kernel: any S and any D <= 256,
//     no padding; key columns past S contribute p = 0, rows past S are
//     not written; scale = 1/sqrt(D) of the true D comes from the caller;
//   * dK/dV walks query tiles inside a block that owns one key tile: no
//     atomics, so every result is deterministic;
//   * the kernels allocate nothing; each entry point launches on the
//     stream it is given and returns cudaGetLastError().
//
// What bounds them on the H100: at GPT-2 small's shape (BH = 96,
// S = 1024, D = 64, causal, bf16) the work is ~1.3e10 FLOP for the
// forward, 2.0e10 for dQ and 2.6e10 for dK/dV against ~50 MB of traffic,
// i.e. tensor-core bound (~13 / 20 / 26 us at 989 TFLOP/s bf16).  This
// first version does the products with float32 FMAs on the CUDA cores
// (67 TFLOP/s peak), so it sits an order of magnitude or more above that
// bound; mma.sync / wgmma tiles are the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// ------------------------------------------------------------ launching

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int BR, int DT>
constexpr size_t smem_bytes(int which) {
  return sizeof(float) *
         (which == kFwd ? 3 * BR * (DT + 1) + BR * (BR + 1)
          : which == kDq ? 4 * BR * (DT + 1) + BR * (BR + 1)
                         : 4 * BR * (DT + 1) + 2 * BR * (BR + 1) + 2 * BR);
}

template <typename T, int BR, int DT>
int launch(int which, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<BR, DT>(which);
  const dim3 grid((unsigned)a.bh * (unsigned)((a.S + BR - 1) / BR));
  void (*kernel)(Args) = which == kFwd  ? fwd_kernel<T, BR, DT>
                         : which == kDq ? dq_kernel<T, BR, DT>
                                        : dkv_kernel<T, BR, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  D <= 256 (the caller checks).
template <typename T>
int dispatch_d(int which, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64, 64>(which, a, stream);
  if (a.D <= 128) return launch<T, 64, 128>(which, a, stream);
  if (a.D <= 256) return launch<T, 32, 256>(which, a, stream);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int which, int dtype, const Args& a, void* stream) {
  if (a.bh <= 0 || a.S <= 0 || a.D <= 0) return 0;  // nothing to do
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(which, a, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(which, a, st);
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
              int dtype, void* stream) {
  Args a = make_args(q, k, v, kmask, qmask, qdiv, qmod, bh, S, D, scale,
                     causal, window);
  a.out0 = o;
  a.lse_out = lse;
  return dispatch(kFwd, dtype, a, stream);
}

// dq: (bh, S, D); lse, delta: (bh, S) float32.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const float* kmask, const float* qmask, int qdiv, int qmod,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int bh, int S, int D, float scale, int causal,
                 int window, int dtype, void* stream) {
  Args a = make_args(q, k, v, kmask, qmask, qdiv, qmod, bh, S, D, scale,
                     causal, window);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out0 = dq;
  return dispatch(kDq, dtype, a, stream);
}

// dk, dv: (bh, S, D).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const float* kmask, const float* qmask, int qdiv, int qmod,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int bh, int S, int D, float scale,
                  int causal, int window, int dtype, void* stream) {
  Args a = make_args(q, k, v, kmask, qmask, qdiv, qmod, bh, S, D, scale,
                     causal, window);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out0 = dk;
  a.out1 = dv;
  return dispatch(kDkv, dtype, a, stream);
}

}  // extern "C"
