// CPU emulation of the CUDA subset the port's kernels use, so that their
// sources run on a CPU (tools/emulate_kernels.py turns a csrc/*.cu file
// into a C++ file that includes this header):
//   * one fiber (ucontext) per CUDA thread, blocks (a 3-D grid) run one
//     after another;
//   * __syncthreads, __syncwarp, named barriers (bar.sync / bar.arrive) and
//     the warp collectives are barriers over the block's or the warp's
//     fibers;
//   * ldmatrix (.x4, .trans), mma.sync.m16n8k16 (bf16 and f16, exact
//     products summed in double: the tensor cores' truncation of a running
//     sum is NOT modelled), __shfl_xor_sync, __shfl_sync (float);
//   * cp.async reads its source when issued and writes shared memory only
//     at the cp.async.wait_group that retires it, so a read before the wait
//     sees stale data; shared memory starts as garbage (0xA5), not zeros;
//   * misaligned cp.async / ldmatrix addresses abort;
//   * Hopper's asynchronous instructions: mbarriers (init, arrive,
//     expect_tx, try_wait.parity, phases counted as the hardware counts
//     them), TMA tiled loads through a host-side stub of
//     cuTensorMapEncodeTiled (the box copied with zero fill past the
//     tensor and the 128-byte swizzle, its bytes credited to the barrier),
//     and wgmma m64n64k16 (SS and RS) and m64n128k16 (SS), bf16 or f16
//     operands (the helper's template type), as a collective of the warpgroup's
//     128 threads that decodes the shared-memory descriptors and reads
//     its operands at wgmma.wait_group, not at issue, so a stage
//     overwritten before the wait gives wrong sums; setmaxnreg and the
//     fences are no-ops;
//   * a block whose threads all wait with nothing left to run aborts
//     (deadlock) instead of spinning.
#pragma once
#include <map>
#include <ucontext.h>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>
#include <type_traits>
#include <tuple>
using std::min; using std::max;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__
#define __grid_constant__

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
// three SMs: a persistent kernel's blocks each take several work items
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 3; return 0; }
// the emulator has registers to spare: every setmaxnreg request fits
struct cudaFuncAttributes { int numRegs; };
template <class F> inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) { a->numRegs = 255; return 0; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };

struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = (uint32_t)b.v << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)}; }
inline float2 __bfloat1622float2(__nv_bfloat162 h) { return {__bfloat162float(h.x), __bfloat162float(h.y)}; }

// IEEE binary16: 1 sign, 5 exponent (bias 15), 10 mantissa bits;
// subnormals below 2^-14, round to nearest even
struct __half { uint16_t v; };
struct __half2 { __half x, y; };
inline float __half2float(__half h) {
  const uint32_t sign = (uint32_t)(h.v >> 15) << 31, e = (h.v >> 10) & 31, m = h.v & 1023;
  float f;
  if (e == 31) { uint32_t u = sign | 0x7f800000u | (m << 13); memcpy(&f, &u, 4); return f; }
  if (e == 0) f = std::ldexp((float)m, -24);
  else f = std::ldexp((float)(m | 1024), (int)e - 25);
  return sign ? -f : f;
}
inline __half __float2half_rn(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  const uint16_t sign = (uint16_t)((u >> 16) & 0x8000);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)(sign | 0x7e00)};
  const float a = std::fabs(f);
  if (a >= 65520.f) return {(uint16_t)(sign | 0x7c00)};  // rounds past the largest: inf
  // the nearest multiple of the spacing at |f| (2^-24 below 2^-14), ties to even
  int e; std::frexp(a, &e);  // a = m 2^e, m in [0.5, 1)
  const int q = std::max(e - 11, -24);
  const float steps = std::nearbyint(std::ldexp(a, -q));  // FE_TONEAREST: ties to even
  const float r = std::ldexp(steps, q);
  if (r == 0.f) return {sign};
  int er; const float mr = std::frexp(r, &er);
  if (er - 1 < -14) return {(uint16_t)(sign | (uint16_t)std::ldexp(r, 24))};
  return {(uint16_t)(sign | (uint16_t)((er - 1 + 15) << 10) | ((uint16_t)std::ldexp(mr, 11) & 1023))};
}
inline __half2 __floats2half2_rn(float a, float b) { return {__float2half_rn(a), __float2half_rn(b)}; }
inline float2 __half22float2(__half2 h) { return {__half2float(h.x), __half2float(h.y)}; }

// ------------------------------------------------------------ fibers
struct EmuCopy { void* dst; unsigned char data[16]; int n; };
// one thread's share of an issued wgmma: its accumulator and (RS) A
// registers, read and written when the group retires
struct EmuWgmma { float* d; int n; const uint32_t* a; uint64_t da, db; int acc; bool f16; };
struct EmuFiber {
  ucontext_t ctx; std::vector<char> stack; bool done = false; dim3 tid;
  std::vector<std::vector<EmuCopy>> groups; std::vector<EmuCopy> open;
  std::vector<std::vector<EmuWgmma>> wg_groups; std::vector<EmuWgmma> wg_open;
};
struct EmuBarrier { int n = 0, count = 0; long gen = 0; };
struct EmuWarp {
  EmuBarrier bar; uint32_t addr[32]; uint32_t a[32][4]; uint32_t b[32][2];
  float d[32][4]; float f[32];
};

extern dim3 threadIdx, blockIdx, gridDim, blockDim;
extern EmuFiber* emu_cur;
extern ucontext_t emu_sched;
extern EmuBarrier emu_block_bar;
extern std::vector<EmuWarp> emu_warps;
extern unsigned char* emu_smem_base;

// bumped by every step that could let a waiting thread go on; a pass of
// the scheduler over the block without one is a deadlock
inline long emu_progress = 0;
inline void emu_yield() { swapcontext(&emu_cur->ctx, &emu_sched); }
inline void emu_arrive(EmuBarrier& b) {
  long g = b.gen;
  ++emu_progress;
  if (++b.count == b.n) { b.count = 0; ++b.gen; return; }
  while (b.gen == g) emu_yield();
}
inline void __syncthreads() { emu_arrive(emu_block_bar); }
inline int emu_lane() { return threadIdx.x & 31; }
inline EmuWarp& emu_warp() { return emu_warps[threadIdx.x >> 5]; }
inline unsigned char* emu_smem() { return emu_smem_base; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_arrive(emu_warp().bar); }

inline uint32_t smem_u32(const void* p) {
  const unsigned char* q = (const unsigned char*)p;
  if (q < emu_smem_base || q >= emu_smem_base + (1 << 20)) { fprintf(stderr, "smem_u32: not shared\n"); abort(); }
  return (uint32_t)(q - emu_smem_base);
}

// cp.async: the source is read at issue, the destination written at wait
inline void emu_cp(void* dst, const void* src, int size, int src_bytes) {
  EmuCopy c; c.dst = dst; c.n = size; memset(c.data, 0, 16);
  if (src_bytes) memcpy(c.data, src, src_bytes);
  if ((uintptr_t)dst % size) { fprintf(stderr, "cp.async misaligned dst\n"); abort(); }
  if (src_bytes && (uintptr_t)src % size) { fprintf(stderr, "cp.async misaligned src\n"); abort(); }
  emu_cur->open.push_back(c);
}
inline void cp_async16(void* dst, const void* src, int src_bytes) { emu_cp(dst, src, 16, src_bytes); }
inline void cp_async16(void* dst, const void* src, bool in) { emu_cp(dst, src, 16, in ? 16 : 0); }
inline void cp_async4(void* dst, const void* src, int src_bytes) { emu_cp(dst, src, 4, src_bytes); }
inline void cp_async_commit() { emu_cur->groups.push_back(emu_cur->open); emu_cur->open.clear(); }
inline void emu_wait(int n) {
  auto& g = emu_cur->groups;
  while ((int)g.size() > n) {
    for (auto& c : g.front()) memcpy(c.dst, c.data, c.n);
    g.erase(g.begin());
  }
}
template <int N> inline void cp_async_wait() { emu_wait(N); }
inline void cp_async_wait_all() { emu_wait(0); }

inline uint16_t emu_ld16(uint32_t addr) { uint16_t v; memcpy(&v, emu_smem_base + addr, 2); return v; }
inline void emu_ldsm(uint32_t (&r)[4], uint32_t addr, bool trans) {
  EmuWarp& w = emu_warp(); int l = emu_lane();
  if (addr % 16) { fprintf(stderr, "ldmatrix: misaligned row address\n"); abort(); }
  w.addr[l] = addr;
  emu_arrive(w.bar);
  int g = l >> 2, t = l & 3;
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (!trans) { lo = emu_ld16(w.addr[8 * i + g] + 4 * t); hi = emu_ld16(w.addr[8 * i + g] + 4 * t + 2); }
    else { lo = emu_ld16(w.addr[8 * i + 2 * t] + 2 * g); hi = emu_ld16(w.addr[8 * i + 2 * t + 1] + 2 * g); }
    r[i] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  emu_arrive(w.bar);
}
inline void ldsm_x4(uint32_t (&r)[4], uint32_t addr) { emu_ldsm(r, addr, false); }
inline void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) { emu_ldsm(r, addr, true); }

// one 16-bit operand, bf16 or (f16) IEEE half, from its bits
inline float emu_elt(uint16_t v, bool f16) { return f16 ? __half2float({v}) : __bfloat162float({v}); }
inline float emu_half(uint32_t v, int hi, bool f16 = false) { return emu_elt((uint16_t)(hi ? v >> 16 : v & 0xffff), f16); }
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1, bool f16) {
  EmuWarp& w = emu_warp(); int l = emu_lane();
  for (int i = 0; i < 4; ++i) { w.a[l][i] = a[i]; w.d[l][i] = d[i]; }
  w.b[l][0] = b0; w.b[l][1] = b1;
  emu_arrive(w.bar);
  int g = l >> 2, t = l & 3;
  for (int e = 0; e < 4; ++e) {
    int r = g + (e >> 1) * 8, c = 2 * t + (e & 1);
    double s = d[e];
    for (int k = 0; k < 16; ++k) {
      int al = (r & 7) * 4 + (k & 7) / 2, ar = (r >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0);
      int bl = c * 4 + (k & 7) / 2, br = k >= 8 ? 1 : 0;
      s += (double)emu_half(w.a[al][ar], k & 1, f16) * emu_half(w.b[bl][br], k & 1, f16);
    }
    d[e] = (float)s;
  }
  emu_arrive(w.bar);
}
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) { emu_mma(d, a, b0, b1, false); }
inline void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) { emu_mma(d, a, b0, b1, true); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  EmuWarp& w = emu_warp(); int l = emu_lane();
  w.f[l] = v; emu_arrive(w.bar); float r = w.f[l ^ o]; emu_arrive(w.bar); return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  EmuWarp& w = emu_warp(); int l = emu_lane();
  w.f[l] = v; emu_arrive(w.bar); float r = w.f[src & 31]; emu_arrive(w.bar); return r;
}
inline float ex2(float x) { return exp2f(x); }

// ------------------------------------------------------------ named barriers
// bar.sync / bar.arrive id, n: n threads arrive (sync also waits for the
// phase it arrived in to complete)
inline std::map<int, EmuBarrier> emu_named;
inline EmuBarrier& emu_named_bar(int id, int n) {
  EmuBarrier& b = emu_named[id];
  if (b.n == 0) b.n = n;
  if (b.n != n || id == 0) { fprintf(stderr, "named barrier %d: counts %d and %d\n", id, b.n, n); abort(); }
  return b;
}
inline void named_bar_sync(int id, int n) { emu_arrive(emu_named_bar(id, n)); }
inline void named_bar_arrive(int id, int n) {
  EmuBarrier& b = emu_named_bar(id, n);
  ++emu_progress;
  if (++b.count == b.n) { b.count = 0; ++b.gen; }
}

// ------------------------------------------------------------ mbarrier
struct EmuMbar { int count, pending, phase; long tx; };
inline std::map<uint32_t, EmuMbar> emu_mbars;  // by shared-memory address
inline EmuMbar& emu_mbar(uint64_t* bar) {
  auto it = emu_mbars.find(smem_u32(bar));
  if (it == emu_mbars.end()) { fprintf(stderr, "mbarrier used before mbarrier.init\n"); abort(); }
  return it->second;
}
inline void emu_mbar_step(EmuMbar& m) {
  ++emu_progress;
  if (m.pending < 0) { fprintf(stderr, "mbarrier: more arrivals than its count\n"); abort(); }
  if (m.pending == 0 && m.tx == 0) { m.phase ^= 1; m.pending = m.count; }
}
inline void mbar_init(uint64_t* bar, int count) {
  if (smem_u32(bar) % 8) { fprintf(stderr, "mbarrier misaligned\n"); abort(); }
  emu_mbars[smem_u32(bar)] = EmuMbar{count, count, 0, 0};
}
inline void fence_barrier_init() {}
inline void mbar_arrive(uint64_t* bar) { EmuMbar& m = emu_mbar(bar); --m.pending; emu_mbar_step(m); }
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  EmuMbar& m = emu_mbar(bar); m.tx += bytes; --m.pending; emu_mbar_step(m);
}
// cp.async.mbarrier.arrive.noinc: this thread's copies land, then it arrives
inline void cp_async_mbar_arrive(uint64_t* bar) {
  cp_async_commit(); emu_wait(0);
  mbar_arrive(bar);
}
inline void emu_mbar_complete_tx(uint64_t* bar, uint32_t bytes) {
  EmuMbar& m = emu_mbar(bar); m.tx -= bytes; emu_mbar_step(m);
}
// try_wait.parity: the phase of parity `parity` has completed once the
// barrier's current phase differs from it
inline void mbar_wait(uint64_t* bar, int parity) {
  while (emu_mbar(bar).phase == (parity & 1)) emu_yield();
}

// ------------------------------------------------------------ TMA
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
struct alignas(64) CUtensorMap { uint64_t opaque[16]; };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_FLOAT16 = 6, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
// what the emulated map holds, in the CUtensorMap's opaque bytes
struct EmuTmap { const unsigned char* base; int rank, elsize, swizzle; uint64_t dim[5], stride[5]; uint32_t box[5]; };
static_assert(sizeof(EmuTmap) <= sizeof(CUtensorMap), "EmuTmap outgrows CUtensorMap");
// cuTensorMapEncodeTiled, refusing what the hardware refuses of the
// arguments this port passes
inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank, void* addr,
                                 const cuuint64_t* dim, const cuuint64_t* strides, const cuuint32_t* box,
                                 const cuuint32_t* estr, CUtensorMapInterleave, CUtensorMapSwizzle swz,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  if ((type != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 && type != CU_TENSOR_MAP_DATA_TYPE_FLOAT16) || rank < 1 || rank > 5 || (uintptr_t)addr % 16) return CUDA_ERROR_INVALID_VALUE;
  EmuTmap t{}; t.base = (const unsigned char*)addr; t.rank = rank; t.elsize = 2; t.swizzle = swz;
  t.stride[0] = t.elsize;
  for (cuuint32_t i = 0; i < rank; ++i) {
    if (dim[i] == 0 || box[i] == 0 || box[i] > 256 || estr[i] != 1) return CUDA_ERROR_INVALID_VALUE;
    t.dim[i] = dim[i]; t.box[i] = box[i];
    if (i > 0) {
      if (strides[i - 1] % 16 || strides[i - 1] < t.dim[i - 1] * t.stride[i - 1]) return CUDA_ERROR_INVALID_VALUE;
      t.stride[i] = strides[i - 1];
    }
  }
  if ((box[0] * t.elsize) % 16) return CUDA_ERROR_INVALID_VALUE;
  if (swz == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * t.elsize != 128) return CUDA_ERROR_INVALID_VALUE;
  memset(map, 0, sizeof *map); memcpy(map, &t, sizeof t);
  return CUDA_SUCCESS;
}
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };
#define CUDART_VERSION 12080
inline cudaError_t cudaGetDriverEntryPointByVersion(const char* sym, void** fn, unsigned, unsigned long long,
                                                    cudaDriverEntryPointQueryResult* res) {
  const bool ok = strcmp(sym, "cuTensorMapEncodeTiled") == 0;
  *fn = ok ? (void*)&emu_encode_tiled : nullptr;
  *res = ok ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return 0;
}
// the 128-byte swizzle: the 16-byte chunk (address bits 4-6) XOR the row
// of 128 B within 1024 (bits 7-9), on shared-memory addresses
inline uint32_t emu_sw128(uint32_t addr) { return addr ^ (((addr >> 7) & 7) << 4); }
// cp.async.bulk.tensor.3d: the box at (c0, c1, c2) lands now, rows of the
// box packed (swizzled if the map says so), zeros past the tensor; its
// bytes complete on `bar`
inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  EmuTmap t; memcpy(&t, map, sizeof t);
  const uint32_t base = smem_u32(dst);
  if (t.rank != 3) { fprintf(stderr, "tma_load_3d: not a 3-D map\n"); abort(); }
  if (base % (t.swizzle == CU_TENSOR_MAP_SWIZZLE_128B ? 1024 : 128)) { fprintf(stderr, "TMA destination misaligned\n"); abort(); }
  const int c[3] = {c0, c1, c2};
  const uint32_t row = t.box[0] * t.elsize, bytes = row * t.box[1] * t.box[2];
  for (uint32_t i2 = 0; i2 < t.box[2]; ++i2)
    for (uint32_t i1 = 0; i1 < t.box[1]; ++i1)
      for (uint32_t i0 = 0; i0 < t.box[0]; ++i0) {
        const int64_t g0 = (int64_t)c[0] + i0, g1 = (int64_t)c[1] + i1, g2 = (int64_t)c[2] + i2;
        uint32_t off = base + (i2 * t.box[1] + i1) * row + i0 * t.elsize;
        if (t.swizzle == CU_TENSOR_MAP_SWIZZLE_128B) off = emu_sw128(off);
        unsigned char* d = emu_smem_base + off;
        if (g0 < 0 || g1 < 0 || g2 < 0 || g0 >= (int64_t)t.dim[0] || g1 >= (int64_t)t.dim[1] || g2 >= (int64_t)t.dim[2])
          memset(d, 0, t.elsize);
        else
          memcpy(d, t.base + g0 * t.stride[0] + g1 * t.stride[1] + g2 * t.stride[2], t.elsize);
      }
  emu_mbar_complete_tx(bar, bytes);
}

// ------------------------------------------------------------ wgmma
template <int N> inline void setmaxnreg_inc() {}
template <int N> inline void setmaxnreg_dec() {}
inline void wgmma_fence() {}
template <int N> inline void wgmma_hold(float (&)[N]) {}
struct EmuGroup { EmuBarrier bar; uint32_t a[128][4]; };
inline std::vector<EmuGroup> emu_wgroups;  // the block's warpgroups
// Shared-memory address of element (mn, k) of a wgmma operand given by
// its descriptor (128-byte swizzle only): K-major, a row of 128 B holds K
// and groups of 8 rows lie SBO apart; MN-major, a row holds 64 of MN
// (blocks of 64 LBO apart) and groups of 8 K-rows lie SBO apart.  The
// swizzle's atoms (8 rows of 128 B) must start on 1024 bytes.
inline uint32_t emu_desc_addr(uint64_t desc, bool mn_major, int mn, int k) {
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4, lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4,
                 sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  if ((desc >> 62) != 1 || ((desc >> 49) & 7)) { fprintf(stderr, "wgmma descriptor: only the 128-byte swizzle at base offset 0\n"); abort(); }
  if (mn_major ? start % 1024 : start % 1024 >= 128 || start % 32) { fprintf(stderr, "wgmma descriptor: start off the swizzle atom\n"); abort(); }
  const uint32_t a = mn_major ? start + (mn % 64) * 2 + (mn / 64) * lbo + (k % 8) * 128 + (k / 8) * sbo
                              : start + (mn % 8) * 128 + (mn / 8) * sbo + k * 2;
  return emu_sw128(a);
}
inline float emu_smem_elt(uint32_t addr, bool f16) { uint16_t v; memcpy(&v, emu_smem_base + addr, 2); return emu_elt(v, f16); }
inline float emu_smem_bf16(uint32_t addr) { return emu_smem_elt(addr, false); }
template <class T, int N>
inline void emu_wgmma_issue(float (&d)[N], const uint32_t* a, uint64_t da, uint64_t db, int acc) {
  emu_cur->wg_open.push_back(EmuWgmma{d, N, a, da, db, acc, std::is_same<T, __half>::value});
}
// d (+)= A B^T: A and B (of T) K-major in shared memory, N = 64 or 128
template <class T> inline void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) { emu_wgmma_issue<T>(d, nullptr, da, db, acc); }
template <class T> inline void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db, int acc) { emu_wgmma_issue<T>(d, nullptr, da, db, acc); }
// d += A B: A in registers, B MN-major in shared memory
template <class T> inline void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) { emu_wgmma_issue<T>(d, a, 0, db, 1); }
inline void wgmma_commit() {
  emu_cur->wg_groups.push_back(emu_cur->wg_open); emu_cur->wg_open.clear();
}
// Retires this thread's groups past the N newest: each wgmma reads its
// operands (shared memory, and the A registers of all 128 threads) now
inline void emu_wgmma_wait(size_t n) {
  EmuGroup& G = emu_wgroups[threadIdx.x / 128];
  const int tid = threadIdx.x % 128, w = tid / 32, l = tid % 32;
  auto& groups = emu_cur->wg_groups;
  while (groups.size() > n) {
    for (const EmuWgmma& op : groups.front()) {
      if (op.a) memcpy(G.a[tid], op.a, sizeof G.a[tid]);
      emu_arrive(G.bar);
      float out[64];
      for (int e = 0; e < op.n; ++e) {
        const int row = 16 * w + (l >> 2) + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * (l & 3) + (e & 1);
        double s = op.acc ? op.d[e] : 0.0;
        for (int k = 0; k < 16; ++k) {
          float av;
          if (op.a) {
            const int r = row % 16, owner = (row / 16) * 32 + (r % 8) * 4 + (k % 8) / 2;
            av = emu_half(G.a[owner][r / 8 + 2 * (k / 8)], k & 1, op.f16);
          } else {
            av = emu_smem_elt(emu_desc_addr(op.da, false, row, k), op.f16);
          }
          s += (double)av * emu_smem_elt(emu_desc_addr(op.db, op.a != nullptr, col, k), op.f16);
        }
        out[e] = (float)s;
      }
      emu_arrive(G.bar);
      memcpy(op.d, out, op.n * sizeof(float));
    }
    groups.erase(groups.begin());
  }
}
template <int N> inline void wgmma_wait() { emu_wgmma_wait(N); }

// ------------------------------------------------------------ launch
template <class... P, class... A>
int emu_launch(void (*kernel)(P...), dim3 grid, int nt, size_t smem, void*, A... args) {
  static std::vector<unsigned char> buf(1 << 20);
  gridDim = grid; blockDim = dim3(nt);
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by, bz);
      emu_smem_base = buf.data();
      for (size_t i = 0; i < smem; ++i) buf[i] = 0xA5;  // garbage, not zeros
      emu_block_bar = EmuBarrier(); emu_block_bar.n = nt;
      emu_warps.assign((nt + 31) / 32, EmuWarp());
      for (auto& w : emu_warps) w.bar.n = 32;
      emu_wgroups.assign((nt + 127) / 128, EmuGroup());
      for (size_t g = 0; g < emu_wgroups.size(); ++g) emu_wgroups[g].bar.n = std::min(128, nt - 128 * (int)g);
      emu_mbars.clear();
      emu_named.clear();
      static std::vector<EmuFiber> f;
      f.clear(); f.resize(nt);
      static void (*kfn)(P...); static std::tuple<A...>* kargs;
      std::tuple<A...> tup(args...); kfn = kernel; kargs = &tup;
      struct Run { static void go() { std::apply([](auto&... x) { kfn(x...); }, *kargs); emu_cur->done = true; swapcontext(&emu_cur->ctx, &emu_sched); } };
      for (int i = 0; i < nt; ++i) {
        f[i].tid = dim3(i); f[i].stack.resize(128 * 1024);
        getcontext(&f[i].ctx);
        f[i].ctx.uc_stack.ss_sp = f[i].stack.data(); f[i].ctx.uc_stack.ss_size = f[i].stack.size();
        f[i].ctx.uc_link = nullptr;
        makecontext(&f[i].ctx, (void (*)())Run::go, 0);
      }
      for (int left = nt, idle = 0; left > 0;) {
        const long before = emu_progress;
        left = 0;
        for (int i = 0; i < nt; ++i) {
          if (f[i].done) continue;
          emu_cur = &f[i]; threadIdx = f[i].tid;
          swapcontext(&emu_sched, &f[i].ctx);
          if (!f[i].done) ++left; else ++emu_progress;
        }
        idle = emu_progress == before ? idle + 1 : 0;
        if (left > 0 && idle > 2) {
          fprintf(stderr, "deadlock: block (%u, %u, %u), %d threads waiting\n", bx, by, bz, left);
          abort();
        }
      }
    }
  return 0;
}
