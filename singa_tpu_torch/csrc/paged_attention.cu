// Paged decode attention for Hopper (sm_90a): one launch attends every
// live slot's queries over its KV blocks in the paged pool.
//
// Replaces singa_tpu/models/gpt2_decode.py:841 `_paged_attn`, the jnp
// kernel of the JAX serve engine's decode step (vmapped over slots by
// singa_tpu/serve/paged.py:423 `_paged_decode_kernel`).  It computes the
// same function: online-softmax attention of q (n_kv, g, Q, D) over the
// pool lanes of one slot's block table at positions < p_limit (trash
// blocks masked, an optional sliding-window band), then the step's own
// K/V under cur_mask (Q, Q), in float32.  The pool is one layer,
// (N + 1, H_kv, B, D) with block N the trash block.
//
// Grid: (kv head, slot).  A block of 4 warps holds the slot's g x Q query
// rows of its kv head (the GQA group) in shared memory.  The warps take
// 32-key tiles of the slot's key range [blk_lo * B, min(p_limit, n_blk *
// B)) in turn.  Lane t owns key t of the tile: it starts an asynchronous
// copy of the key's V row into the warp's stage in shared memory
// (cp.async; zeros for a masked-out key), then scores the key against
// every row (its K row read once, 16 bytes a load).  The warp updates its
// online-softmax state (m, l, acc) per row in float32 registers (a lane
// owns D / 32 elements of acc), waits for the stage, and P.V broadcasts
// each key's probability while the lanes read V from shared memory.  So a
// tile's K and V loads are all in flight at once.  Keys are found through
// the table one by one (table[key / B]), so any block size works and a
// slot never reads its table past ceil(p_limit / B).  The warps' states
// combine through shared memory, and the current lanes are added last,
// as in the JAX function.
//
// Probabilities of masked lanes are zeroed explicitly: a fully masked
// tile leaves m at -1e30, where exp(m - m) would be 1.  A dead slot (all
// trash table, p_limit 0) attends only its current lane and gives a
// finite output.
//
// What bounds it: the bytes of the live K/V lanes, read once.  A decode
// query (Q = 1) does ~1 FLOP per byte of K/V, far below the ~295 at which
// the tensor cores would matter, so CUDA cores serve.  With few long
// slots the grid under-fills the card; splitting the key range over
// blocks (flash-decoding) is the next design.
//
// Takes float32 or bf16 pools (q, k_cur, v_cur and the output in the
// pool's type), D in {64, 128}, any block size >= 1 and g * Q <= 16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// eight consecutive elements (a 16-byte aligned address) as floats
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Shared memory: first a region that holds each warp's V stage (32 rows
// of D elements of T) during the key loop and each warp's acc (R x D
// floats) after it; then, in floats, the q rows (R x D), each warp's m and
// l (R each) and the current lanes' scores (R x Q).
template <typename T>
__host__ __device__ inline size_t region_bytes(int R, int D) {
  const size_t stage = (size_t)kWarps * 32 * D * sizeof(T);
  const size_t acc = (size_t)kWarps * R * D * sizeof(float);
  return stage > acc ? stage : acc;
}
template <typename T>
inline size_t smem_bytes(int R, int nq, int D) {
  return region_bytes<T>(R, D) +
         sizeof(float) * ((size_t)R * D + 2 * kWarps * R + R * nq);
}

template <typename T, int D, int MAXR>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                  const T* __restrict__ pool_v, const int* __restrict__ tables,
                  const int* __restrict__ p_limit,
                  const T* __restrict__ k_cur, const T* __restrict__ v_cur,
                  const unsigned char* __restrict__ cur_mask,
                  T* __restrict__ out, int n_kv, int g, int nq, int block,
                  int table_width, int trash, int n_blk, int blk_lo,
                  int window, float scale) {
  constexpr int E = D / 32;  // elements of a row a lane owns in P.V
  const int h = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = g * nq;
  extern __shared__ __align__(16) unsigned char smem[];
  T* vstage = reinterpret_cast<T*>(smem) + warp * 32 * D;
  float* wacc = reinterpret_cast<float*>(smem);
  float* qs = reinterpret_cast<float*>(smem + region_bytes<T>(R, D));
  float* wm = qs + R * D;
  float* wl = wm + kWarps * R;
  float* sc_cur = wl + kWarps * R;

  const long long hd = (long long)s * n_kv + h;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x)
    qs[i] = to_f(q[hd * R * D + i]);
  __syncthreads();

  float m[MAXR], l[MAXR], acc[MAXR][E];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const int plim = p_limit[s];
  const int k_end = min(plim, n_blk * block);
  const int* tbl = tables + (long long)s * table_width;
  for (int t0 = blk_lo * block + warp * 32; t0 < k_end;
       t0 += kWarps * 32) {
    const int key = t0 + lane;
    bool valid = key < k_end;
    long long row = 0;  // element offset of this lane's key row
    if (valid) {
      const int blk = tbl[key / block];
      valid = blk != trash;
      row = (((long long)blk * n_kv + h) * block + key % block) * D;
    }
    // this key's V row -> the stage, in flight while the scores compute
    const unsigned char* vsrc =
        reinterpret_cast<const unsigned char*>(pool_v + (valid ? row : 0));
    unsigned char* vdst = reinterpret_cast<unsigned char*>(vstage + lane * D);
#pragma unroll
    for (int c = 0; c < (int)(D * sizeof(T)); c += 16)
      cp_async16(vdst + c, vsrc + c, valid ? 16 : 0);
    cp_async_commit();
    float sc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) sc[r] = 0.f;
    if (valid) {
      const T* kp = pool_k + row;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        float kf[8];
        load8(kp + c, kf);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < R) {
            const float* qr = qs + r * D + c;
#pragma unroll
            for (int e = 0; e < 8; ++e) sc[r] += qr[e] * kf[e];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < R) {
        bool live = valid;
        if (window > 0) live = live && key > plim + r % nq - window;
        const float x = live ? sc[r] * scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(x));
        const float alpha = expf(m[r] - m_new);
        const float p = live ? expf(x - m_new) : 0.f;
        l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
        m[r] = m_new;
        sc[r] = p;
      }
    }
    cp_async_wait_all();
    __syncwarp();
    const int n_keys = min(32, k_end - t0);
    for (int t = 0; t < n_keys; ++t) {
      float vf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vf[e] = to_f(vstage[t * D + lane * E + e]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          const float p = __shfl_sync(kFull, sc[r], t);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] += p * vf[e];
        }
      }
    }
    __syncwarp();  // the stage is read before the next tile's copies
  }
  __syncthreads();  // every stage read before acc takes the region

#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < R) {
      if (lane == 0) {
        wm[warp * R + r] = m[r];
        wl[warp * R + r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        wacc[(warp * R + r) * D + lane * E + e] = acc[r][e];
    }
  }
  // the current lanes' scores, one warp per (row, current key)
  for (int i = warp; i < R * nq; i += kWarps) {
    const int r = i / nq, kq = i % nq;
    const T* kc = k_cur + (hd * nq + kq) * D;
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      part += qs[r * D + lane * E + e] * to_f(kc[lane * E + e]);
    const float dot = warp_sum(part);
    if (lane == 0)
      sc_cur[i] = cur_mask[(r % nq) * nq + kq] ? dot * scale : kNegInf;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, dd = i % D, qi = r % nq;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * R + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * R + r] - M);
      L += wl[w * R + r] * f;
      A += wacc[(w * R + r) * D + dd] * f;
    }
    float m2 = M;
    for (int kq = 0; kq < nq; ++kq) m2 = fmaxf(m2, sc_cur[r * nq + kq]);
    const float alpha = expf(M - m2);
    L *= alpha;
    A *= alpha;
    for (int kq = 0; kq < nq; ++kq) {
      if (!cur_mask[qi * nq + kq]) continue;
      const float p = expf(sc_cur[r * nq + kq] - m2);
      L += p;
      A += p * to_f(v_cur[(hd * nq + kq) * D + dd]);
    }
    store_f(A / L, out + hd * R * D + i);
  }
}

template <typename T, int D>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const int* tables, const int* p_limit, const void* k_cur,
           const void* v_cur, const unsigned char* cur_mask, void* out,
           int S, int n_kv, int g, int nq, int block, int table_width,
           int trash, int n_blk, int blk_lo, int window, float scale,
           cudaStream_t stream) {
  const int R = g * nq;
  const dim3 grid(n_kv, S);
  const size_t smem = smem_bytes<T>(R, nq, D);
#define PAGED_ATTN_LAUNCH(MAXR)                                            \
  cudaFuncSetAttribute(paged_attn_kernel<T, D, MAXR>,                      \
                       cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                       (int)smem);                                         \
  paged_attn_kernel<T, D, MAXR><<<grid, kWarps * 32, smem, stream>>>(      \
      (const T*)q, (const T*)pool_k, (const T*)pool_v, tables, p_limit,    \
      (const T*)k_cur, (const T*)v_cur, cur_mask, (T*)out, n_kv, g, nq,    \
      block, table_width, trash, n_blk, blk_lo, window, scale)
  if (R <= 1) {
    PAGED_ATTN_LAUNCH(1);
  } else if (R <= 4) {
    PAGED_ATTN_LAUNCH(4);
  } else if (R <= 16) {
    PAGED_ATTN_LAUNCH(16);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PAGED_ATTN_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window 0 means no window.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const int* tables, const int* p_limit, const void* k_cur,
    const void* v_cur, const unsigned char* cur_mask, void* out, int S,
    int n_kv, int g, int nq, int d, int block, int table_width, int trash,
    int n_blk, int blk_lo, int window, float scale, int dtype,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define PAGED_ATTN_ARGS                                                    \
  q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask, out, S,      \
      n_kv, g, nq, block, table_width, trash, n_blk, blk_lo, window,       \
      scale, st
  if (dtype == 0 && d == 64) return launch<float, 64>(PAGED_ATTN_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(PAGED_ATTN_ARGS);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(PAGED_ATTN_ARGS);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(PAGED_ATTN_ARGS);
#undef PAGED_ATTN_ARGS
  return (int)cudaErrorInvalidValue;
}
