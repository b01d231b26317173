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
// paged_combine_kernel<T, WIDE>, grid (kv head, slot): rescales and sums the
// splits (those with l > 0), adds the current lanes under cur_mask last,
// as the JAX function does, and writes the output in the pool's dtype.
//
// Probabilities of masked lanes are zeroed explicitly: a fully masked
// tile leaves m at -1e30, where exp(m - m) would be 1.  A dead slot (all
// trash table, p_limit 0) attends only its current lane and gives a
// finite output.
//
// int8 pools (the JAX package's cache_dtype="int8": int8 values and one
// float32 scale a (block, kv head, lane) row, the pool element type P =
// int8_t beside the q type T): the values are staged as the other types
// are (16 int8 a 16-byte chunk; a row of D 64 is four chunks, D 16 one),
// and each fetch also stages its 32 keys' K and V scales (a float a lane
// each) beside the tile.  A score takes its K row's scale as it is formed,
// ((q . k8) * kscale) * scale; m and l are updated from the unscaled
// probabilities; the probability a lane writes for P.V is multiplied by
// its V row's scale; P.V reads V 4 bytes (4 int8) at a time, so a lane
// holds as many dims as for float32.  The combine kernel reads the
// current lanes as int8 values with their scales, placed the same way.
// Each int8 element is converted to float32 where it is used.
//
// Takes float32 or bf16 pools (q, k_cur, v_cur and the output in the
// pool's type), int8 pools with float32 or bf16 q (the output in q's
// type), any D <= 1024 (the templates' rows are DT = 16, 32, ...,
// 1024 wide, D rounded up and the tail zero-filled; 16-byte copies where
// a row is a whole number of 16-byte chunks, element copies otherwise;
// a float32 row of 2048 would need 256 KB for one tile of K), any block
// size >= 1, and g * Q <= 16 rows a kv head a launch (<= 4 at D > 128;
// the wrapper launches wider groups in parts: groups of heads, and past
// that runs of query positions, each launch taking all Q current lanes
// and its rows of cur_mask).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;           // keys a warp scores at once
constexpr int kBlocksPerSm = 4;     // the split plan's aim
constexpr int kMinSplitKeys = 128;  // the split plan's floor
constexpr int kCombineMaxQ = 16;    // current lanes the combine holds in
                                    // registers (more: WIDE reads them)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ int8_t from_f<int8_t>(float v) {
  return (int8_t)v;
}
template <typename P>
constexpr bool kQuant = std::is_same<P, int8_t>::value;

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
// 16 int8 of shared memory as floats (byte j of a word at bits 8j)
__device__ __forceinline__ void load_chunk(const int8_t* p, float (&f)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xff);
}
// 4 int8 of shared memory as floats: one P.V read of an int8 row
__device__ __forceinline__ void load_chunk(const int8_t* p, float (&f)[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = (float)(int8_t)((w >> (8 * j)) & 0xff);
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
// floats the q rows (R x DT), each warp's m and l (R each), its
// probabilities (R x 32) and, for int8 pools, its staged K and V scales
// (32 each a stage).
template <typename P, int DT>
__host__ __device__ inline size_t region_bytes(int R) {
  using S = Shape<P, DT>;
  const size_t stage = (size_t)S::kNw * S::kStages * S::kStage;
  const size_t acc = (size_t)S::kNw * R * DT * sizeof(float);
  return stage > acc ? stage : acc;
}
template <typename P, int DT>
__host__ __device__ inline size_t split_smem_bytes(int R) {
  using S = Shape<P, DT>;
  return region_bytes<P, DT>(R) +
         sizeof(long long) * S::kNw * S::kStages * kTile +
         sizeof(float) * ((size_t)R * DT + 2 * S::kNw * R +
                          (size_t)S::kNw * R * kTile +
                          (kQuant<P> ? (size_t)S::kNw * S::kStages * 2 * kTile
                                     : 0));
}

// Keys a split takes: whole units of one tile a warp, and at least
// kMinSplitKeys, over n_split splits of the widest key range.
__host__ __device__ inline int split_chunk(int span, int unit, int n_split) {
  const int units = (span + unit - 1) / unit;
  const int per = (units + n_split - 1) / n_split;
  return (per > 0 ? per : 1) * unit;
}

// T: the type of q and the output; P: the pools' (T, or int8_t with
// float32 scales pool_ks / pool_vs, one a (block, kv head, lane) row).
template <typename T, typename P, int DT, int MAXR>
__global__ void __launch_bounds__(Shape<P, DT>::kNw * 32)
paged_attn_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                  const P* __restrict__ pool_v,
                  const float* __restrict__ pool_ks,
                  const float* __restrict__ pool_vs,
                  const int* __restrict__ tables,
                  const int* __restrict__ p_limit, float* __restrict__ ws,
                  int n_kv, int g, int nq, int q0, int d, int block,
                  int table_width, int trash, int n_blk, int blk_lo,
                  int window, float scale, int vec) {
  using Sh = Shape<P, DT>;
  constexpr bool Q8 = kQuant<P>;
  constexpr int NW = Sh::kNw, STAGES = Sh::kStages;
  constexpr bool TURNS = Sh::kTurns;
  constexpr int EPC = 16 / (int)sizeof(P);      // elements a 16-byte chunk
  constexpr int CH = DT / EPC;                  // chunks a staged row
  constexpr int SW = CH < 8 ? CH : 8;           // swizzle span
  // P.V: a lane reads EPR elements at a time (a 16-byte chunk; 4 bytes of
  // int8), LPR lanes cover a row, RPL reads each, and the warp's KG groups
  // of them take every KG-th key
  constexpr int EPR = Q8 ? 4 : EPC;             // elements a read
  constexpr int NRD = DT / EPR;                 // reads a row
  constexpr int LPR = NRD < 32 ? NRD : 32;      // lanes a V row
  constexpr int KG = 32 / LPR;                  // key groups
  constexpr int RPL = NRD / LPR;                // reads a lane
  constexpr int E = RPL * EPR;                  // dims a lane
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
  P* stage = reinterpret_cast<P*>(smem);  // [NW][STAGES][K, V][32][DT]
                                          // (TURNS: [NW][K or V][32][DT])
  float* wacc = reinterpret_cast<float*>(smem);  // after the key loop
  long long* rows =
      reinterpret_cast<long long*>(smem + region_bytes<P, DT>(R));
  float* qs = reinterpret_cast<float*>(rows + NW * STAGES * kTile);
  float* wm = qs + R * DT;
  float* wl = wm + NW * R;
  float* wp = wl + NW * R + warp * R * kTile;  // this warp's probabilities
  // int8: this warp's K and V scales, [STAGES][K, V][32]
  float* wsc = wl + NW * R + NW * R * kTile + warp * STAGES * 2 * kTile;

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
  P* wstage = stage + (size_t)warp * STAGES * SLOT;

  // The rows of tile ti -> stage st: lane t looks up key t's row
  // (element offset, -1 when masked out or past the range), and on int8
  // pools stages that row's K and V scales (0 where masked); then the
  // warp copies the 32 rows of K (mats & 1) and V (mats & 2) chunk by
  // chunk, consecutive lanes on consecutive chunks, zero-filling masked
  // rows and the tail past D.  K lands at the stage's start, V after it
  // (at the start, too, under TURNS, once K has been read).
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
      if constexpr (Q8) {
        wsc[(st * 2) * kTile + lane] = row >= 0 ? pool_ks[row / d] : 0.f;
        wsc[(st * 2 + 1) * kTile + lane] = row >= 0 ? pool_vs[row / d] : 0.f;
      }
      __syncwarp();
    }
    P* ks = wstage + (size_t)st * SLOT;
    P* vs = TURNS ? ks : ks + kTile * DT;
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
        if (mats & 1) ks[dst] = in ? pool_k[rw + dd] : from_f<P>(0.f);
        if (mats & 2) vs[dst] = in ? pool_v[rw + dd] : from_f<P>(0.f);
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
    const P* ks = wstage + (size_t)st * SLOT;
    const P* vs = TURNS ? ks : ks + kTile * DT;
    const int key = r0 + ti * kTile + lane;
    const bool valid = wrows[st * kTile + lane] >= 0;
    // int8: this lane's key's K and V scales (1 otherwise)
    const float ksc = Q8 ? wsc[(st * 2) * kTile + lane] : 1.f;
    const float vsc = Q8 ? wsc[(st * 2 + 1) * kTile + lane] : 1.f;

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
        if (window > 0) live = live && key > plim + q0 + r % nq - window;
        const float x =
            live ? (Q8 ? sc[r] * ksc * scale : sc[r] * scale) : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(x));
        const float alpha = expf(m[r] - m_new);
        const float p = live ? expf(x - m_new) : 0.f;
        l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
        m[r] = m_new;
        wp[r * kTile + lane] = Q8 ? p * vsc : p;
      }
    }
    __syncwarp();
    if (TURNS) {  // V takes the stage K held
      fetch(ti, st, 2);
      cp_async_wait<0>();
      __syncwarp();
    }
    // P.V: a lane reads its parts of every KG-th key's V row (EPR
    // elements a read) and that key's probability (one shared word for its
    // group); masked keys have p = 0 and zero rows
    const int kg = lane / LPR;
    const int n_keys = min(kTile, r1 - (r0 + ti * kTile));
    for (int t0 = 0; t0 < n_keys; t0 += KG) {
      const int t = t0 + kg;
      float vf[E];
#pragma unroll
      for (int u = 0; u < RPL; ++u) {
        const int el = (lane % LPR + u * LPR) * EPR;  // element in the row
        const int c = el / EPC;
        float f[EPR];
        load_chunk(vs + t * DT + (c ^ (t & (SW - 1))) * EPC + el % EPC, f);
#pragma unroll
        for (int e = 0; e < EPR; ++e) vf[u * EPR + e] = f[e];
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
        for (int u = 0; u < RPL; ++u)
#pragma unroll
          for (int e = 0; e < EPR; ++e)
            wacc[(warp * R + r) * DT + (lane + u * LPR) * EPR + e] =
                acc[r][u * EPR + e];
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
// type of q.  A thread owns an output element and reads what it needs
// (its splits' m, l and acc, its current V elements) at once; the last
// warps score the current lanes meanwhile.  int8 (P = int8_t): the current
// lanes' scales k_cur_s / v_cur_s (one a (slot, kv head, lane)) are placed
// as the split kernel places the pool's.
template <typename T, typename P, bool WIDE>
__global__ void __launch_bounds__(128)
paged_combine_kernel(const T* __restrict__ q, const P* __restrict__ k_cur,
                     const P* __restrict__ v_cur,
                     const float* __restrict__ k_cur_s,
                     const float* __restrict__ v_cur_s,
                     const unsigned char* __restrict__ cur_mask,
                     const float* __restrict__ ws, T* __restrict__ out,
                     int n_kv, int g, int nq, int nc, int q0, int d,
                     int n_split, float scale) {
  constexpr int kMaxQ = kCombineMaxQ;
  constexpr bool Q8 = kQuant<P>;
  const int h = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int R = g * nq;
  const long long hd = (long long)s * n_kv + h;
  const float* ml = ws + hd * n_split * R * 2;
  const float* pacc =
      ws + (long long)gridDim.y * n_kv * n_split * R * 2 + hd * n_split * R * d;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc_cur = reinterpret_cast<float*>(smem);  // [R][nc]

  // the current lanes' scores, one warp per (row, current key), from the
  // last warp down; row r is query position q0 + r % nq of cur_mask's nc
  for (int i = nw - 1 - warp; i < R * nc; i += nw) {
    const int r = i / nc, kq = i % nc;
    float part = 0.f;
    for (int dd = lane; dd < d; dd += 32)
      part += to_f(q[(hd * R + r) * d + dd]) *
              to_f(k_cur[(hd * nc + kq) * d + dd]);
    float dot = warp_sum(part);
    if (Q8) dot *= k_cur_s[hd * nc + kq];
    if (lane == 0)
      sc_cur[i] =
          cur_mask[(q0 + r % nq) * nc + kq] ? dot * scale : kNegInf;
  }
  // int8: a current lane's probability takes its V scale for P.V only
  auto vscale = [&](int kq) { return Q8 ? v_cur_s[hd * nc + kq] : 1.f; };
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
        if (kq < nc) vc[kq] = to_f(v_cur[(hd * nc + kq) * d + dd]);
    }
    __syncthreads();  // sc_cur is written
    if (o < n_out) {
      const unsigned char* mrow = cur_mask + (q0 + r % nq) * nc;
      const float* srow = sc_cur + r * nc;
      float m2 = M;
      for (int kq = 0; kq < nc; ++kq) m2 = fmaxf(m2, srow[kq]);
      const float alpha = expf(M - m2);
      L *= alpha;
      A *= alpha;
#pragma unroll
      for (int kq = 0; kq < kMaxQ; ++kq) {
        if (kq < nc && mrow[kq]) {
          const float p = expf(srow[kq] - m2);
          L += p;
          A += (Q8 ? p * vscale(kq) : p) * vc[kq];
        }
      }
      // lanes past the first kMaxQ (a verify of more than 16 positions)
      // read V where they use it; a decode step compiles without them
      if constexpr (WIDE) {
        for (int kq = kMaxQ; kq < nc; ++kq) {
          if (mrow[kq]) {
            const float p = expf(srow[kq] - m2);
            L += p;
            A += (Q8 ? p * vscale(kq) : p) *
                 to_f(v_cur[(hd * nc + kq) * d + dd]);
          }
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

template <typename T, typename P, int DT>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const float* pool_ks, const float* pool_vs, const int* tables,
           const int* p_limit, const void* k_cur, const void* v_cur,
           const float* k_cur_s, const float* v_cur_s,
           const unsigned char* cur_mask, void* out, float* ws, int S,
           int n_kv, int g, int nq, int nc, int q0, int d, int block,
           int table_width, int trash, int n_blk, int blk_lo, int window,
           int n_split, float scale, int vec, cudaStream_t stream) {
  using Sh = Shape<P, DT>;
  const int R = g * nq;
  if (R > Sh::kMaxR || n_split < 1 || q0 < 0 || q0 + nq > nc)
    return (int)cudaErrorInvalidValue;
  if (kQuant<P> && !(pool_ks && pool_vs && k_cur_s && v_cur_s))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_kv, S, n_split);
  const size_t smem = split_smem_bytes<P, DT>(R);
#define PAGED_SPLIT_LAUNCH(MAXR)                                           \
  do {                                                                     \
    const int err = allow_smem<paged_attn_kernel<T, P, DT, MAXR>>(smem);   \
    if (err != cudaSuccess) return err;                                    \
    paged_attn_kernel<T, P, DT, MAXR><<<grid, Sh::kNw * 32, smem, stream>>>( \
        (const T*)q, (const P*)pool_k, (const P*)pool_v, pool_ks, pool_vs, \
        tables, p_limit, ws, n_kv, g, nq, q0, d, block, table_width,       \
        trash, n_blk, blk_lo, window, scale, vec);                         \
  } while (0)
  if (R <= 1) {
    PAGED_SPLIT_LAUNCH(1);
  } else {
    PAGED_SPLIT_LAUNCH(Sh::kMaxR);
  }
#undef PAGED_SPLIT_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the combine keeps every current lane's score of its R rows in shared
  // memory: past 48 KB (nc > 768 at R = 16) it needs the attribute too
  const size_t csmem = sizeof(float) * R * nc;
#define PAGED_COMBINE_LAUNCH(WIDE)                                         \
  do {                                                                     \
    const int err = allow_smem<paged_combine_kernel<T, P, WIDE>>(csmem);   \
    if (err != cudaSuccess) return err;                                    \
    paged_combine_kernel<T, P, WIDE><<<dim3(n_kv, S), 128, csmem, stream>>>( \
        (const T*)q, (const P*)k_cur, (const P*)v_cur, k_cur_s, v_cur_s,   \
        cur_mask, ws, (T*)out, n_kv, g, nq, nc, q0, d, n_split, scale);    \
  } while (0)
  if (nc <= kCombineMaxQ) {
    PAGED_COMBINE_LAUNCH(false);
  } else {
    PAGED_COMBINE_LAUNCH(true);
  }
#undef PAGED_COMBINE_LAUNCH
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
  if (dt == 0 || dtype < 0 || dtype > 3) return 0;
  const int unit = (dtype == 0   ? warps_for<float>(dt)
                    : dtype == 1 ? warps_for<__nv_bfloat16>(dt)
                                 : warps_for<int8_t>(dt)) *
                   kTile;
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

// q holds query positions [q0, q0 + nq) of the step's nc (its rows are
// (S, n_kv, g, nq, D)); k_cur and v_cur hold all nc current lanes and
// cur_mask is (nc, nc).
// dtype: 0 float32, 1 bfloat16 (q, pools, k_cur, v_cur and the output);
// 2 and 3 int8 pools and current lanes with float32 scales pool_ks,
// pool_vs ((N + 1, n_kv, block)), k_cur_s, v_cur_s ((S, n_kv, nc)), q and
// the output float32 (2) or bfloat16 (3); the scale pointers are unused
// for 0 and 1.  window 0 means no window.  n_blk: the
// upper bound of the blocks read (the table width); the kernel reads
// blocks [blk_lo, min(n_blk, ceil(max p_limit / block))).  ws: float32
// workspace of S * n_kv * n_split * g * nq * (d + 2) elements.  Returns
// the CUDA error of the launches (0 on success).
int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                    const float* pool_ks, const float* pool_vs,
                    const int* tables, const int* p_limit, const void* k_cur,
                    const void* v_cur, const float* k_cur_s,
                    const float* v_cur_s, const unsigned char* cur_mask,
                    void* out, float* ws, int S, int n_kv, int g, int nq,
                    int nc, int q0, int d, int block, int table_width,
                    int trash, int n_blk, int blk_lo, int window,
                    int n_split, float scale, int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  const uintptr_t ptrs = (uintptr_t)pool_k | (uintptr_t)pool_v;
  const int vec = (d * elem) % 16 == 0 && ptrs % 16 == 0;
#define PAGED_ARGS                                                         \
  q, pool_k, pool_v, pool_ks, pool_vs, tables, p_limit, k_cur, v_cur,      \
      k_cur_s, v_cur_s, cur_mask, out, ws, S, n_kv, g, nq, nc, q0, d,      \
      block, table_width, trash, n_blk, blk_lo, window, n_split, scale,    \
      vec, st
#define PAGED_DISPATCH(T, P)                                               \
  switch (row_width(d)) {                                                  \
    case 16: return launch<T, P, 16>(PAGED_ARGS);                          \
    case 32: return launch<T, P, 32>(PAGED_ARGS);                          \
    case 64: return launch<T, P, 64>(PAGED_ARGS);                          \
    case 128: return launch<T, P, 128>(PAGED_ARGS);                        \
    case 256: return launch<T, P, 256>(PAGED_ARGS);                        \
    case 512: return launch<T, P, 512>(PAGED_ARGS);                        \
    case 1024: return launch<T, P, 1024>(PAGED_ARGS);                      \
  }
  if (dtype == 0) PAGED_DISPATCH(float, float)
  if (dtype == 1) PAGED_DISPATCH(__nv_bfloat16, __nv_bfloat16)
  if (dtype == 2) PAGED_DISPATCH(float, int8_t)
  if (dtype == 3) PAGED_DISPATCH(__nv_bfloat16, int8_t)
#undef PAGED_DISPATCH
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
