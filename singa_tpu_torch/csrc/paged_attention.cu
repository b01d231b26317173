// Paged decode attention for Hopper (sm_90a), split over the key range
// (flash-decoding): every live slot's queries attend its KV blocks in the
// paged pool in two launches, a split kernel and a combine kernel.
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
// What bounds it: the bytes of the live K/V lanes, read once.  A decode
// query (g * Q = 1 row for GPT-2) does ~1 FLOP per byte of K/V, far below
// the ~295 at which the tensor cores would matter, and one row fills no
// mma tile, so CUDA cores serve.  At GPT-2 small's serve step (8 slots of
// 115-511 lanes, 12 kv heads, D 64, bf16) the lanes are 8.7 MB: 2.6 us at
// 3.35 TB/s.  Reaching that takes most of those bytes in flight at once
// across the card, which the design below is for.
//
// paged_attn_kernel<T, DT, MAXR>, grid (kv head, slot, split): the key
// range [blk_lo * B, min(p_limit, n_blk * B)) of every slot is cut into
// `n_split` splits of `chunk` keys.  n_blk, the longest live slot's block
// count, is read on the device: every block takes the max of the S
// slots' p_limit (the JAX function's traced `jnp.max` at
// singa_tpu/serve/paged.py:450), so a decode step captured in a CUDA
// graph reads no block past any slot's position however far the slots
// have grown since the capture.  The host knows only the table width,
// the upper bound of n_blk: it chooses n_split from it, B, S * n_kv and
// the SM count (paged_split_count below: ~4 blocks an SM, at least 128
// keys a split, so few long slots fill the card as well as many short
// ones), and each block cuts the live range into n_split chunks.  A
// block of NW warps holds its slot's g x Q query rows (the GQA group) in
// shared memory; its warps take the split's 32-key tiles in turn.  For
// each tile a lane looks up its key's block in the
// table once, and the warp copies the tile's K and V rows into a shared
// stage by cp.async in 16-byte chunks, consecutive lanes on consecutive
// chunks: where a tile lies in one pool block (B >= 32) that is one
// contiguous span read coalesced; otherwise each row is.  The stage's
// 16-byte chunks are XOR-swizzled by row, so lane t reading row t (the
// scores) and every lane reading one row (P.V) are both free of bank
// conflicts.  Two stages: the next tile's K and V are in flight while the
// current one is scored (one stage where two would not fit: float32 at
// D 512 and both types at D 1024; at float32 D 1024 one tile of K and V
// together would pass 227 KB, so K and V take turns in the one stage).
// Per tile, lane t scores key t against every row, the warp
// updates its online-softmax state (m, l, acc) per row in float32
// registers and puts the tile's probabilities in shared memory, and P.V
// reads V from the stage 16 bytes at a time: a group of lanes covers a
// row, chunk by chunk, and the warp's groups take alternate keys (at
// D = 64 in bf16, four groups of 8 lanes), summed across groups once at
// the end.  The warps' states combine through shared
// memory into one partial (m, l, acc) per (slot, kv head, split), written
// to a float32 workspace the wrapper allocates.  A split whose range
// holds no live key of its slot writes m = -1e30 and l = 0 and exits; so
// does a window's dead range, which is skipped.
//
// paged_combine_kernel<T>, grid (kv head, slot): rescales and sums the
// splits (those with l > 0), adds the current lanes under cur_mask last,
// as the JAX function does, and writes the output in the pool's dtype.
//
// Probabilities of masked lanes are zeroed explicitly: a fully masked
// tile leaves m at -1e30, where exp(m - m) would be 1.  A dead slot (all
// trash table, p_limit 0) attends only its current lane and gives a
// finite output.  Where int8 pools come (per-row scales, ROADMAP Queue B
// item 1), a score takes its K row's scale where it is formed and a
// probability its V row's scale where P.V reads it.
//
// Takes float32 or bf16 pools (q, k_cur, v_cur and the output in the
// pool's type), any D <= 1024 (the templates' rows are DT = 16, 32, ...,
// 1024 wide, D rounded up and the tail zero-filled; 16-byte copies where
// a row is a whole number of 16-byte chunks, element copies otherwise;
// a float32 row of 2048 would need 256 KB for one tile of K), any block
// size >= 1, and g * Q <= 16 rows a kv head (<= 4 at D > 128; the
// wrapper launches wider groups in parts).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;           // keys a warp scores at once
constexpr int kBlocksPerSm = 4;     // the split plan's aim
constexpr int kMinSplitKeys = 128;  // the split plan's floor

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// one 16-byte chunk of shared memory as floats
__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Warps a block and stages a warp, by element type and row width: four
// warps where their two stages of K and V (2 x 2 x 32 x DT elements a
// warp) fit 64 KB, else two, else one; one stage where two would pass
// 160 KB (float32 at DT = 512, both types at 1024); K and V in turns in
// that stage where together they would pass it (float32 at 1024).  Rows
// a kv head: 16, or 4 past DT = 128, where a lane's acc (MAXR x DT / 32
// floats) would crowd the registers.
template <typename T, int DT>
struct Shape {
  static constexpr int kMat = kTile * DT * (int)sizeof(T);  // K or V
  static constexpr int kKV = 2 * kMat;                      // K + V
  static constexpr int kNw = 2 * kKV * 4 <= 65536   ? 4
                             : 2 * kKV * 2 <= 65536 ? 2
                                                    : 1;
  static constexpr bool kTurns = kKV > 160 * 1024;
  static constexpr int kStage = kTurns ? kMat : kKV;
  static constexpr int kStages = 2 * kKV <= 160 * 1024 ? 2 : 1;
  static constexpr int kMaxR = DT <= 128 ? 16 : 4;
};

// Shared memory of the split kernel: a region that holds each warp's
// stages during the key loop and each warp's acc (R x DT floats) after
// it; then each warp's row offsets (a long long a key and stage), and in
// floats the q rows (R x DT) and each warp's m and l (R each).
template <typename T, int DT>
__host__ __device__ inline size_t region_bytes(int R) {
  using S = Shape<T, DT>;
  const size_t stage = (size_t)S::kNw * S::kStages * S::kStage;
  const size_t acc = (size_t)S::kNw * R * DT * sizeof(float);
  return stage > acc ? stage : acc;
}
template <typename T, int DT>
__host__ __device__ inline size_t split_smem_bytes(int R) {
  using S = Shape<T, DT>;
  return region_bytes<T, DT>(R) +
         sizeof(long long) * S::kNw * S::kStages * kTile +
         sizeof(float) * ((size_t)R * DT + 2 * S::kNw * R +
                          (size_t)S::kNw * R * kTile);
}

// Keys a split takes: whole units of one tile a warp, and at least
// kMinSplitKeys, over n_split splits of the widest key range.
__host__ __device__ inline int split_chunk(int span, int unit, int n_split) {
  const int units = (span + unit - 1) / unit;
  const int per = (units + n_split - 1) / n_split;
  return (per > 0 ? per : 1) * unit;
}

template <typename T, int DT, int MAXR>
__global__ void __launch_bounds__(Shape<T, DT>::kNw * 32)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                  const T* __restrict__ pool_v,
                  const int* __restrict__ tables,
                  const int* __restrict__ p_limit, float* __restrict__ ws,
                  int n_kv, int g, int nq, int d, int block, int table_width,
                  int trash, int n_blk, int blk_lo, int window, float scale,
                  int vec) {
  using Sh = Shape<T, DT>;
  constexpr int NW = Sh::kNw, STAGES = Sh::kStages;
  constexpr bool TURNS = Sh::kTurns;
  constexpr int EPC = 16 / (int)sizeof(T);      // elements a 16-byte chunk
  constexpr int CH = DT / EPC;                  // chunks a staged row
  constexpr int SW = CH < 8 ? CH : 8;           // swizzle span
  // P.V: LPR lanes cover a row, a chunk (or CPL) each, and the warp's
  // KG groups of them take every KG-th key
  constexpr int LPR = CH < 32 ? CH : 32;        // lanes a V row
  constexpr int KG = 32 / LPR;                  // key groups
  constexpr int CPL = CH / LPR;                 // chunks a lane
  constexpr int E = CPL * EPC;                  // dims a lane
  const int h = blockIdx.x, s = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = g * nq;
  const long long hd = (long long)s * n_kv + h;
  const long long part = hd * n_split + split;  // this block's partial
  float* ws_ml = ws + part * R * 2;
  float* ws_acc = ws + (long long)gridDim.y * n_kv * n_split * R * 2 +
                  part * R * d;

  // the live bound: the longest slot's blocks, at most the host's n_blk
  float longest = 0.f;
  for (int i = lane; i < (int)gridDim.y; i += 32)
    longest = fmaxf(longest, (float)p_limit[i]);
  const int live_blk = min(n_blk, ((int)warp_max(longest) + block - 1) /
                                      block);
  const int chunk = split_chunk((live_blk - blk_lo) * block, NW * kTile,
                                n_split);
  const int plim = p_limit[s];
  const int k_end = min(plim, live_blk * block);
  int r0 = blk_lo * block + split * chunk;
  const int r1 = min(r0 + chunk, k_end);
  // keys no row of the window sees: key <= p_limit - window
  if (window > 0) r0 = max(r0, plim - window + 1);
  if (r0 >= r1) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      ws_ml[2 * r] = kNegInf;
      ws_ml[2 * r + 1] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);  // [NW][STAGES][K, V][32][DT]
                                          // (TURNS: [NW][K or V][32][DT])
  float* wacc = reinterpret_cast<float*>(smem);  // after the key loop
  long long* rows =
      reinterpret_cast<long long*>(smem + region_bytes<T, DT>(R));
  float* qs = reinterpret_cast<float*>(rows + NW * STAGES * kTile);
  float* wm = qs + R * DT;
  float* wl = wm + NW * R;
  float* wp = wl + NW * R + warp * R * kTile;  // this warp's probabilities

  float m[MAXR], l[MAXR], acc[MAXR][E];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const int* tbl = tables + (long long)s * table_width;
  const int n_tiles = (r1 - r0 + kTile - 1) / kTile;
  long long* wrows = rows + warp * STAGES * kTile;
  constexpr int SLOT = TURNS ? kTile * DT : 2 * kTile * DT;  // a stage
  T* wstage = stage + (size_t)warp * STAGES * SLOT;

  // The rows of tile ti -> stage st: lane t looks up key t's row
  // (element offset, -1 when masked out or past the range); then the warp
  // copies the 32 rows of K (mats & 1) and V (mats & 2) chunk by chunk,
  // consecutive lanes on consecutive chunks, zero-filling masked rows and
  // the tail past D.  K lands at the stage's start, V after it (at the
  // start, too, under TURNS, once K has been read).
  auto fetch = [&](int ti, int st, int mats) {
    if (mats & 1) {
      const int key = r0 + ti * kTile + lane;
      long long row = -1;
      if (key < r1) {
        const int blk = tbl[key / block];
        if (blk != trash)
          row = (((long long)blk * n_kv + h) * block + key % block) * d;
      }
      wrows[st * kTile + lane] = row;
      __syncwarp();
    }
    T* ks = wstage + (size_t)st * SLOT;
    T* vs = TURNS ? ks : ks + kTile * DT;
    if (vec) {
      const int dch = d / EPC;  // chunks holding data
#pragma unroll 4
      for (int c = lane; c < kTile * CH; c += 32) {
        const int kk = c / CH, cc = c % CH;
        const long long rw = wrows[st * kTile + kk];
        const bool in = rw >= 0 && cc < dch;
        const long long src = in ? rw + cc * EPC : 0;
        const int dst = kk * DT + (cc ^ (kk & (SW - 1))) * EPC;
        if (mats & 1) cp_async16(ks + dst, pool_k + src, in ? 16 : 0);
        if (mats & 2) cp_async16(vs + dst, pool_v + src, in ? 16 : 0);
      }
    } else {
      for (int e = lane; e < kTile * DT; e += 32) {
        const int kk = e / DT, dd = e % DT;
        const long long rw = wrows[st * kTile + kk];
        const bool in = rw >= 0 && dd < d;
        const int dst =
            kk * DT + ((dd / EPC) ^ (kk & (SW - 1))) * EPC + dd % EPC;
        if (mats & 1) ks[dst] = in ? pool_k[rw + dd] : from_f<T>(0.f);
        if (mats & 2) vs[dst] = in ? pool_v[rw + dd] : from_f<T>(0.f);
      }
    }
    cp_async_commit();
  };
  constexpr int FIRST = TURNS ? 1 : 3;  // what a tile's first fetch copies

  // the first tile's copies are in flight while q is read
  int st = 0;
  if (warp < n_tiles) fetch(warp, 0, FIRST);
  for (int i = threadIdx.x; i < R * DT; i += blockDim.x) {
    const int r = i / DT, dd = i % DT;
    qs[i] = dd < d ? to_f(q[(hd * R + r) * d + dd]) : 0.f;
  }
  __syncthreads();
  for (int ti = warp; ti < n_tiles; ti += NW) {
    const bool more = ti + NW < n_tiles;
    if (STAGES > 1 && more) {
      fetch(ti + NW, st ^ 1, FIRST);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* ks = wstage + (size_t)st * SLOT;
    const T* vs = TURNS ? ks : ks + kTile * DT;
    const int key = r0 + ti * kTile + lane;
    const bool valid = wrows[st * kTile + lane] >= 0;

    // scores: lane t against its key's K row
    float sc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) sc[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      float kf[EPC];
      load_chunk(ks + lane * DT + (c ^ (lane & (SW - 1))) * EPC, kf);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          const float* qr = qs + r * DT + c * EPC;
#pragma unroll
          for (int e = 0; e < EPC; ++e) sc[r] += qr[e] * kf[e];
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
        wp[r * kTile + lane] = p;
      }
    }
    __syncwarp();
    if (TURNS) {  // V takes the stage K held
      fetch(ti, st, 2);
      cp_async_wait<0>();
      __syncwarp();
    }
    // P.V: a lane reads its chunks of every KG-th key's V row (16 bytes a
    // read) and that key's probability (one shared word for its group);
    // masked keys have p = 0 and zero rows
    const int kg = lane / LPR;
    const int n_keys = min(kTile, r1 - (r0 + ti * kTile));
    for (int t0 = 0; t0 < n_keys; t0 += KG) {
      const int t = t0 + kg;
      float vf[E];
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = lane % LPR + u * LPR;
        float f[EPC];
        load_chunk(vs + t * DT + (c ^ (t & (SW - 1))) * EPC, f);
#pragma unroll
        for (int e = 0; e < EPC; ++e) vf[u * EPC + e] = f[e];
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          const float p = wp[r * kTile + t];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] += p * vf[e];
        }
      }
    }
    __syncwarp();  // the stage and wp are read before they are rewritten
    if (STAGES == 1 && more) fetch(ti + NW, 0, FIRST);
    if (STAGES > 1) st ^= 1;
  }
  if (KG > 1) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e)
        for (int o = 16; o >= LPR; o >>= 1)
          acc[r][e] += __shfl_xor_sync(kFull, acc[r][e], o);
  }
  __syncthreads();  // every stage read before acc takes the region

#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < R) {
      if (lane == 0) {
        wm[warp * R + r] = m[r];
        wl[warp * R + r] = l[r];
      }
      if (lane < LPR) {
#pragma unroll
        for (int u = 0; u < CPL; ++u)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            wacc[(warp * R + r) * DT + (lane + u * LPR) * EPC + e] =
                acc[r][u * EPC + e];
      }
    }
  }
  __syncthreads();

  // the warps' states -> this split's partial
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, dd = i % d;
    float M = kNegInf;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * R + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w * R + r] - M);
      L += wl[w * R + r] * f;
      A += wacc[(w * R + r) * DT + dd] * f;
    }
    ws_acc[i] = A;
    if (dd == 0) {
      ws_ml[2 * r] = M;
      ws_ml[2 * r + 1] = L;
    }
  }
}

// The splits' partials of one (slot, kv head), merged online (running
// max, rescaled sums) in split order, skipping splits with l = 0; then
// the current lanes, as the JAX function adds them last; written in the
// pool's dtype.  A thread owns an output element and reads what it needs
// (its splits' m, l and acc, its current V elements) at once; the last
// warps score the current lanes meanwhile.
template <typename T>
__global__ void __launch_bounds__(128)
paged_combine_kernel(const T* __restrict__ q, const T* __restrict__ k_cur,
                     const T* __restrict__ v_cur,
                     const unsigned char* __restrict__ cur_mask,
                     const float* __restrict__ ws, T* __restrict__ out,
                     int n_kv, int g, int nq, int d, int n_split,
                     float scale) {
  constexpr int kMaxQ = 16;
  const int h = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int R = g * nq;
  const long long hd = (long long)s * n_kv + h;
  const float* ml = ws + hd * n_split * R * 2;
  const float* pacc =
      ws + (long long)gridDim.y * n_kv * n_split * R * 2 + hd * n_split * R * d;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc_cur = reinterpret_cast<float*>(smem);  // [R][nq]

  // the current lanes' scores, one warp per (row, current key), from the
  // last warp down
  for (int i = nw - 1 - warp; i < R * nq; i += nw) {
    const int r = i / nq, kq = i % nq;
    float part = 0.f;
    for (int dd = lane; dd < d; dd += 32)
      part += to_f(q[(hd * R + r) * d + dd]) *
              to_f(k_cur[(hd * nq + kq) * d + dd]);
    const float dot = warp_sum(part);
    if (lane == 0)
      sc_cur[i] = cur_mask[(r % nq) * nq + kq] ? dot * scale : kNegInf;
  }
  // the splits, merged online, for each output element of this thread
  const int n_out = R * d;
  for (int base = 0; base < n_out; base += blockDim.x) {
    const int o = base + threadIdx.x;
    const int r = o / d, dd = o % d;
    float M = kNegInf, L = 0.f, A = 0.f, vc[kMaxQ];
    if (o < n_out) {
      // four splits' loads in flight at a time; a split with l = 0
      // wrote no acc, so its acc is read but not used
      for (int j0 = 0; j0 < n_split; j0 += 4) {
        float mj[4], lj[4], aj[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = min(j0 + u, n_split - 1);
          mj[u] = ml[(j * R + r) * 2];
          lj[u] = j0 + u < n_split ? ml[(j * R + r) * 2 + 1] : 0.f;
          aj[u] = pacc[(j * R + r) * d + dd];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (lj[u] > 0.f) {
            const float M2 = fmaxf(M, mj[u]);
            const float a = expf(M - M2), b = expf(mj[u] - M2);
            L = L * a + lj[u] * b;
            A = A * a + aj[u] * b;
            M = M2;
          }
        }
      }
#pragma unroll
      for (int kq = 0; kq < kMaxQ; ++kq)
        if (kq < nq) vc[kq] = to_f(v_cur[(hd * nq + kq) * d + dd]);
    }
    __syncthreads();  // sc_cur is written
    if (o < n_out) {
      const int qi = r % nq;
      float m2 = M;
      for (int kq = 0; kq < nq; ++kq) m2 = fmaxf(m2, sc_cur[r * nq + kq]);
      const float alpha = expf(M - m2);
      L *= alpha;
      A *= alpha;
#pragma unroll
      for (int kq = 0; kq < kMaxQ; ++kq) {
        if (kq < nq && cur_mask[qi * nq + kq]) {
          const float p = expf(sc_cur[r * nq + kq] - m2);
          L += p;
          A += p * vc[kq];
        }
      }
      out[(hd * R + r) * d + dd] = from_f<T>(A / L);
    }
  }
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

template <typename T, int DT>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const int* tables, const int* p_limit, const void* k_cur,
           const void* v_cur, const unsigned char* cur_mask, void* out,
           float* ws, int S, int n_kv, int g, int nq, int d, int block,
           int table_width, int trash, int n_blk, int blk_lo, int window,
           int n_split, float scale, int vec, cudaStream_t stream) {
  using Sh = Shape<T, DT>;
  const int R = g * nq;
  if (R > Sh::kMaxR || n_split < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_kv, S, n_split);
  const size_t smem = split_smem_bytes<T, DT>(R);
#define PAGED_SPLIT_LAUNCH(MAXR)                                           \
  do {                                                                     \
    const int err = allow_smem<paged_attn_kernel<T, DT, MAXR>>(smem);      \
    if (err != cudaSuccess) return err;                                    \
    paged_attn_kernel<T, DT, MAXR><<<grid, Sh::kNw * 32, smem, stream>>>(  \
        (const T*)q, (const T*)pool_k, (const T*)pool_v, tables, p_limit,  \
        ws, n_kv, g, nq, d, block, table_width, trash, n_blk, blk_lo,      \
        window, scale, vec);                                               \
  } while (0)
  if (R <= 1) {
    PAGED_SPLIT_LAUNCH(1);
  } else {
    PAGED_SPLIT_LAUNCH(Sh::kMaxR);
  }
#undef PAGED_SPLIT_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t csmem = sizeof(float) * R * nq;
  paged_combine_kernel<T><<<dim3(n_kv, S), 128, csmem, stream>>>(
      (const T*)q, (const T*)k_cur, (const T*)v_cur, cur_mask, ws, (T*)out,
      n_kv, g, nq, d, n_split, scale);
  return (int)cudaGetLastError();
}

// The row width DT a head dim takes: the smallest of 16, 32, ..., 1024
// that holds it, or 0.
inline int row_width(int d) {
  for (int dt = 16; dt <= 1024; dt *= 2)
    if (d <= dt) return dt;
  return 0;
}

template <typename T>
int warps_for(int dt) {
  switch (dt) {
    case 16: return Shape<T, 16>::kNw;
    case 32: return Shape<T, 32>::kNw;
    case 64: return Shape<T, 64>::kNw;
    case 128: return Shape<T, 128>::kNw;
    case 256: return Shape<T, 256>::kNw;
    case 512: return Shape<T, 512>::kNw;
    case 1024: return Shape<T, 1024>::kNw;
  }
  return 0;
}

}  // namespace

extern "C" {

// Splits of the key range for one call: about kBlocksPerSm blocks an SM
// over S * n_kv (slot, kv head) pairs, each split at least kMinSplitKeys
// keys and whole units of one 32-key tile a warp; 0 for a head dim or
// dtype the kernel does not take.  Reads only what the host knows (the
// bound n_blk, no p_limit), so choosing it costs no device sync.
int paged_split_count(int d, int dtype, int n_blk, int blk_lo, int block,
                      int pairs, int n_sm) {
  const int dt = row_width(d);
  if (dt == 0 || dtype < 0 || dtype > 1) return 0;
  const int unit = (dtype == 0 ? warps_for<float>(dt)
                               : warps_for<__nv_bfloat16>(dt)) * kTile;
  const int span = (n_blk - blk_lo) * block;
  if (span <= 0 || pairs <= 0) return 1;
  const int units = (span + unit - 1) / unit;
  int most = span / kMinSplitKeys;
  if (most > units) most = units;
  if (most < 1) most = 1;
  int want = (kBlocksPerSm * n_sm + pairs - 1) / pairs;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const int per = (units + want - 1) / want;
  return (units + per - 1) / per;
}

// dtype: 0 float32, 1 bfloat16.  window 0 means no window.  n_blk: the
// upper bound of the blocks read (the table width); the kernel reads
// blocks [blk_lo, min(n_blk, ceil(max p_limit / block))).  ws: float32
// workspace of S * n_kv * n_split * g * Q * (d + 2) elements.  Returns
// the CUDA error of the launches (0 on success).
int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                    const int* tables, const int* p_limit, const void* k_cur,
                    const void* v_cur, const unsigned char* cur_mask,
                    void* out, float* ws, int S, int n_kv, int g, int nq,
                    int d, int block, int table_width, int trash, int n_blk,
                    int blk_lo, int window, int n_split, float scale,
                    int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int elem = dtype == 0 ? 4 : 2;
  const uintptr_t ptrs = (uintptr_t)pool_k | (uintptr_t)pool_v;
  const int vec = (d * elem) % 16 == 0 && ptrs % 16 == 0;
#define PAGED_ARGS                                                         \
  q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask, out, ws, S,  \
      n_kv, g, nq, d, block, table_width, trash, n_blk, blk_lo, window,    \
      n_split, scale, vec, st
#define PAGED_DISPATCH(T)                                                  \
  switch (row_width(d)) {                                                  \
    case 16: return launch<T, 16>(PAGED_ARGS);                             \
    case 32: return launch<T, 32>(PAGED_ARGS);                             \
    case 64: return launch<T, 64>(PAGED_ARGS);                             \
    case 128: return launch<T, 128>(PAGED_ARGS);                           \
    case 256: return launch<T, 256>(PAGED_ARGS);                           \
    case 512: return launch<T, 512>(PAGED_ARGS);                           \
    case 1024: return launch<T, 1024>(PAGED_ARGS);                         \
  }
  if (dtype == 0) PAGED_DISPATCH(float)
  if (dtype == 1) PAGED_DISPATCH(__nv_bfloat16)
#undef PAGED_DISPATCH
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
