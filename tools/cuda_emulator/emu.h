// CPU emulation of the CUDA subset the port's kernels use, so that their
// sources run on a CPU (tools/emulate_kernels.py turns a csrc/*.cu file
// into a C++ file that includes this header):
//   * one fiber (ucontext) per CUDA thread, blocks (a 3-D grid) run one
//     after another;
//   * __syncthreads, __syncwarp and the warp collectives are barriers over
//     the block's or the warp's fibers;
//   * ldmatrix (.x4, .trans), mma.sync.m16n8k16 (bf16, exact products summed
//     in double: the tensor cores' truncation of a running sum is NOT
//     modelled), __shfl_xor_sync, __shfl_sync (float);
//   * cp.async reads its source when issued and writes shared memory only
//     at the cp.async.wait_group that retires it, so a read before the wait
//     sees stale data; shared memory starts as garbage (0xA5), not zeros;
//   * misaligned cp.async / ldmatrix addresses abort.
#pragma once
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

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
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

// ------------------------------------------------------------ fibers
struct EmuCopy { void* dst; unsigned char data[16]; int n; };
struct EmuFiber {
  ucontext_t ctx; std::vector<char> stack; bool done = false; dim3 tid;
  std::vector<std::vector<EmuCopy>> groups; std::vector<EmuCopy> open;
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

inline void emu_yield() { swapcontext(&emu_cur->ctx, &emu_sched); }
inline void emu_arrive(EmuBarrier& b) {
  long g = b.gen;
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

inline float emu_half(uint32_t v, int hi) { return __bfloat162float({(uint16_t)(hi ? v >> 16 : v & 0xffff)}); }
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
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
      s += (double)emu_half(w.a[al][ar], k & 1) * emu_half(w.b[bl][br], k & 1);
    }
    d[e] = (float)s;
  }
  emu_arrive(w.bar);
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  EmuWarp& w = emu_warp(); int l = emu_lane();
  w.f[l] = v; emu_arrive(w.bar); float r = w.f[l ^ o]; emu_arrive(w.bar); return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  EmuWarp& w = emu_warp(); int l = emu_lane();
  w.f[l] = v; emu_arrive(w.bar); float r = w.f[src & 31]; emu_arrive(w.bar); return r;
}
inline float ex2(float x) { return exp2f(x); }

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
      for (int left = nt; left > 0;) {
        left = 0;
        for (int i = 0; i < nt; ++i) {
          if (f[i].done) continue;
          emu_cur = &f[i]; threadIdx = f[i].tid;
          swapcontext(&emu_sched, &f[i].ctx);
          if (!f[i].done) ++left;
        }
      }
    }
  return 0;
}
