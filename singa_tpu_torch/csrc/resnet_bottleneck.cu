// ResNet-50 conv2_x bottleneck forward for Hopper (sm_90a), BN folded.
//
// Replaces the Pallas TPU kernel experiments/resnet_megakernel.py:40
// megakernel_block (pallas_call at :84) and computes what it computes,
// channels-last, with every product summed in float32:
//   y1  = bf16(relu(x . w1 * s1 + b1))                 1x1, C -> CM
//   y2  = bf16(relu(conv3x3_SAME(y1, w2) * s2 + b2))   CM -> CM
//   out = bf16(relu(y2 . w3 * s3 + b3 + x))            1x1, CM -> C
// x, out (B, H, W, C) bf16; w1 (C, CM), w2 (3, 3, CM, CM) HWIO, w3 (CM, C)
// bf16; s1, b1, s2, b2 (CM) and s3, b3 (C) float32.  y1 and y2 never go
// to device memory.
//
// Design for the GPU (not the TPU's schedule, which holds a whole
// 56x56x256 image in a 16 MB VMEM stack):
//   * grid (band of R output rows, image); 256 threads a block;
//   * y1 for the R+2 rows around the band (a one-row halo on each side,
//     recomputed by the neighbouring bands) goes into shared memory as
//     bf16, W+2 wide; the ring outside the image is ZERO, the 3x3 conv's
//     SAME padding of y1, not relu(b1);
//   * the R x W x CM y2 tile goes into shared memory as bf16;
//   * the 64->256 1x1 conv, the skip and the ReLU run from registers and
//     write bf16 straight to `out`;
//   * each thread owns PT pixels x 8 channels (32 float32 accumulators):
//     per 8-deep slice of the reduction it loads PT 16-byte activation
//     vectors and eight 16-byte weight vectors for 256 FMAs.  Weights
//     are read through the read-only cache and L2 (136 KB for C=256,
//     CM=64, shared by every block).
//   With R = 2 and W = 56, CM = 64 the two tiles take 44 KB.
//
// What bounds it on the H100: at ResNet-50's shape (B=128, 56x56, 256 ->
// 64 -> 64 -> 256) the block moves 411 MB (x in, out back) = 0.123 ms at
// 3.35 TB/s, against 5.6e10 FLOP = 0.057 ms at 989 TFLOP/s bf16: it is
// bytes-bound.  This first version does its products with float32 FMAs
// on the CUDA cores (67 TFLOP/s peak, and it recomputes the halo rows:
// 1.5x the 1x1 work of stage 1), so it is compute-limited far above that
// bound; mma.sync / wgmma tiles and TMA loads are the next step.
//
// The kernel allocates nothing; the entry point launches on the stream
// it is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NTHREADS 256
#define R 2   // output rows per block
#define PT 4  // pixels per thread
#define VT 8  // channels per thread: one 16-byte vector of bf16

namespace {

typedef __nv_bfloat16 bf16;

// 8 bf16 packed in 16 bytes, as floats.
__device__ __forceinline__ void unpack8(uint4 raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8_global(const bf16* p, float* out) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

__device__ __forceinline__ void load8_shared(const bf16* p, float* out) {
  unpack8(*reinterpret_cast<const uint4*>(p), out);
}

// 8 floats rounded to bf16 (nearest even) and stored at p as 16 bytes.
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void load8_f32(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < VT; ++i) out[i] = __ldg(p + i);
}

// acc[i][m] += a[i][k] * w_k[m] over one 8-deep slice, with the weight
// row k read from w + k * ldw (global memory).
__device__ __forceinline__ void fma_slice(float (&acc)[PT][VT],
                                          const float (&a)[PT][VT],
                                          const bf16* w, int ldw) {
#pragma unroll
  for (int k = 0; k < VT; ++k) {
    float wv[VT];
    load8_global(w + (size_t)k * ldw, wv);
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int m = 0; m < VT; ++m) acc[i][m] = fmaf(a[i][k], wv[m], acc[i][m]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[PT][VT]) {
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int m = 0; m < VT; ++m) acc[i][m] = 0.f;
}

__global__ void __launch_bounds__(NTHREADS)
bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ s2,
                  const float* __restrict__ b2, const bf16* __restrict__ w3,
                  const float* __restrict__ s3, const float* __restrict__ b3,
                  bf16* __restrict__ out, int H, int W, int C, int CM) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* y1s = reinterpret_cast<bf16*>(smem_raw);  // (R+2) x (W+2) x CM
  bf16* y2s = y1s + (size_t)(R + 2) * (W + 2) * CM;  // (R x W) x CM

  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * R;  // first output row of the band
  const size_t img = (size_t)blockIdx.y * H * W * C;
  const bf16* xb = x + img;
  bf16* ob = out + img;
  const int W2 = W + 2;
  const int gm = CM / VT;  // channel groups of y1 / y2
  const int gc = C / VT;   // channel groups of x / out

  // -- ring columns j = 0 and j = W+1 of every y1 row: zero ----------------
  for (int idx = tid; idx < (R + 2) * 2 * gm; idx += NTHREADS) {
    const int g = idx % gm, side = (idx / gm) % 2, r = idx / (2 * gm);
    const int j = side ? W + 1 : 0;
    *reinterpret_cast<uint4*>(y1s + ((size_t)r * W2 + j) * CM + g * VT) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // -- stage 1: y1 for image rows h0-1 .. h0+R (zero outside the image) ---
  const int P1 = (R + 2) * W;
  for (int task = tid; task < ((P1 + PT - 1) / PT) * gm; task += NTHREADS) {
    const int g = task % gm, p0 = (task / gm) * PT;
    const bf16* xp[PT];
    bool live[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = p0 + i, r = p / W, w = p % W, h = h0 - 1 + r;
      live[i] = p < P1 && h >= 0 && h < H;
      xp[i] = xb + (live[i] ? ((size_t)h * W + w) * C : 0);
    }
    float acc[PT][VT];
    zero_acc(acc);
    for (int c0 = 0; c0 < C; c0 += VT) {
      float a[PT][VT];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        if (live[i]) {
          load8_global(xp[i] + c0, a[i]);
        } else {
#pragma unroll
          for (int k = 0; k < VT; ++k) a[i][k] = 0.f;
        }
      }
      fma_slice(acc, a, w1 + (size_t)c0 * CM + g * VT, CM);
    }
    float sc[VT], bi[VT];
    load8_f32(s1 + g * VT, sc);
    load8_f32(b1 + g * VT, bi);
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = p0 + i;
      if (p >= P1) continue;
      float y[VT];
#pragma unroll
      for (int m = 0; m < VT; ++m)
        y[m] = live[i] ? fmaxf(fmaf(acc[i][m], sc[m], bi[m]), 0.f) : 0.f;
      store8(y1s + ((size_t)(p / W) * W2 + p % W + 1) * CM + g * VT, y);
    }
  }
  __syncthreads();

  // -- stage 2: y2 = relu(conv3x3(y1) * s2 + b2) for the R band rows ------
  const int P2 = R * W;
  for (int task = tid; task < ((P2 + PT - 1) / PT) * gm; task += NTHREADS) {
    const int g = task % gm, p0 = (task / gm) * PT;
    int base[PT];  // y1 tile offset of each pixel's top-left tap
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = min(p0 + i, P2 - 1);
      base[i] = ((p / W) * W2 + p % W) * CM;
    }
    float acc[PT][VT];
    zero_acc(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int di = tap / 3, dj = tap % 3, off = (di * W2 + dj) * CM;
      const bf16* wt = w2 + (size_t)tap * CM * CM + g * VT;
      for (int k0 = 0; k0 < CM; k0 += VT) {
        float a[PT][VT];
#pragma unroll
        for (int i = 0; i < PT; ++i) load8_shared(y1s + base[i] + off + k0, a[i]);
        fma_slice(acc, a, wt + (size_t)k0 * CM, CM);
      }
    }
    float sc[VT], bi[VT];
    load8_f32(s2 + g * VT, sc);
    load8_f32(b2 + g * VT, bi);
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = p0 + i;
      if (p >= P2) continue;
      float y[VT];
#pragma unroll
      for (int m = 0; m < VT; ++m) y[m] = fmaxf(fmaf(acc[i][m], sc[m], bi[m]), 0.f);
      store8(y2s + (size_t)p * CM + g * VT, y);
    }
  }
  __syncthreads();

  // -- stage 3: out = relu(y2 . w3 * s3 + b3 + x), rows inside the image --
  for (int task = tid; task < ((P2 + PT - 1) / PT) * gc; task += NTHREADS) {
    const int g = task % gc, p0 = (task / gc) * PT;
    float acc[PT][VT];
    zero_acc(acc);
    for (int k0 = 0; k0 < CM; k0 += VT) {
      float a[PT][VT];
#pragma unroll
      for (int i = 0; i < PT; ++i)
        load8_shared(y2s + (size_t)min(p0 + i, P2 - 1) * CM + k0, a[i]);
      fma_slice(acc, a, w3 + (size_t)k0 * C + g * VT, C);
    }
    float sc[VT], bi[VT];
    load8_f32(s3 + g * VT, sc);
    load8_f32(b3 + g * VT, bi);
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = p0 + i, h = h0 + p / W;
      if (p >= P2 || h >= H) continue;
      const size_t at = ((size_t)h * W + p % W) * C + g * VT;
      float res[VT], y[VT];
      load8_global(xb + at, res);
#pragma unroll
      for (int m = 0; m < VT; ++m)
        y[m] = fmaxf(fmaf(acc[i][m], sc[m], bi[m]) + res[m], 0.f);
      store8(ob + at, y);
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for image rows W wide and CM
// bottleneck channels: the bf16 y1 tile with its halo, (R+2) x (W+2) x CM,
// and the y2 tile, R x W x CM.
size_t resnet_bottleneck_smem(int W, int CM) {
  return ((size_t)(R + 2) * (W + 2) + (size_t)R * W) * CM * sizeof(bf16);
}

// Shapes come from the caller, which has checked them: C and CM multiples
// of 8, every pointer 16-byte aligned, the shared memory within 227 KB.
int resnet_bottleneck(const void* x, const void* w1, const void* s1,
                      const void* b1, const void* w2, const void* s2,
                      const void* b2, const void* w3, const void* s3,
                      const void* b3, void* out, int B, int H, int W, int C,
                      int CM, void* stream) {
  const size_t smem = resnet_bottleneck_smem(W, CM);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + R - 1) / R, B);
  bottleneck_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)s1, (const float*)b1,
      (const bf16*)w2, (const float*)s2, (const float*)b2, (const bf16*)w3,
      (const float*)s3, (const float*)b3, (bf16*)out, H, W, C, CM);
  return (int)cudaGetLastError();
}

}  // extern "C"
