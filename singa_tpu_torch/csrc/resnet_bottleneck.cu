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
// What bounds it on the H100: at ResNet-50's shape (B=128, 56x56, 256 ->
// 64 -> 64 -> 256) the block moves 411 MB (x in, out back) = 0.123 ms at
// 3.35 TB/s, against 5.6e10 FLOP = 0.057 ms at 989 TFLOP/s bf16: it is
// bytes-bound.
//
// Design for the GPU (not the TPU's schedule, which holds a whole
// 56x56x256 image in a 16 MB VMEM stack): one block of 8 warps per (band
// of R output rows, image), three implicit GEMMs on mma.sync.m16n8k16
// bf16 tiles with float32 sums:
//
//   stage  M (pixels)          K            N    A              B
//   1      (R+2) W: the band   C, chunks    CM   x, cp.async    w1 chunk
//          and a halo row on   of 64                            (64, CM)
//          each side
//   2      R W                 9 taps x CM  CM   y1, shifted    w2 tap
//                                                per tap        (CM, CM)
//   3      R W                 CM           C,   y2             w3 chunk
//                                           64 at a time        (CM, 64)
//
//   * M is cut into passes of 128 pixels, one 16-pixel M tile per warp,
//     each warp holding its tile's whole N (CM) in registers in stages 1
//     and 2, and 64 columns in stage 3.  A lane gives ldmatrix the address
//     of its own pixel's row, so M tiles may cross image rows (W = 7, 28,
//     56) and the 9 taps of stage 2 are 9 shifted pixel addresses into y1.
//   * The chunks (x and w1 in stage 1, a tap of w2 in stage 2, 64 columns
//     of w3 in stage 3) arrive by 16-byte cp.async into two stages: the
//     next chunk loads while this one computes, one __syncthreads a
//     chunk.  Weights come from L2 (136 KB at CM = 64, shared by every
//     block).  B operands are the (K, N) row-major weights read by
//     ldmatrix.trans, as dq_tc_kernel reads K.
//   * Every shared-memory row is padded by 16 bytes to an odd number of
//     16-byte chunks, so the 8 rows an ldmatrix matrix reads lie in 8
//     bank groups, for any CM (a XOR swizzle would need a power of two).
//   * CM is zero-filled to CMP = CM rounded up to 16 (weights and y1 / y2
//     columns past CM are 0), C to a multiple of 64 in the chunks, pixels
//     past the band's end to 0; nothing past them is written.
//   * y1 is (R+2) x (W+2) x CMP bf16 with a ZERO ring: the 3x3 conv's SAME
//     padding of y1, never relu(b1); halo rows outside the image are 0
//     too.  A last band with fewer than R rows computes and writes only
//     its own.  y2 is R x W x CMP bf16.
//   * The epilogue of stage 3 adds s3, b3 and the skip x (read again from
//     L2, where stage 1 left it), applies the ReLU and stores bf16 pairs.
//   * Sums: the tensor cores add an mma's products to its C operand with
//     truncation, not rounding, so a running sum fed back as C drifts by
//     about one float32 ulp of itself at each of stage 2's 36 steps.  y1
//     and y2 are rounded to bf16 and then summed again, so that drift made
//     y2 roundings differ from exact sums several times as often as the
//     plain version's (5 of the 8 edge cases failed the gate on an H100).
//     Each mma therefore starts from zero and is added to the float32 sum
//     in registers by a rounded add: the outputs then differ from float64
//     sums less often than the plain version's (chip_smoke.py's float64
//     witness; PERF.md), at some 11% more time.
//   * R (band rows, resnet_bottleneck_band_rows) = max(1, PASS_PIX / W),
//     so stages 2 and 3 fill one pass; R = 2 at W = 56.  Stage 1
//     recomputes the two halo rows of each band: (R+2)/R of its work, +24%
//     of the block's products at R = 2.
//   * Shared memory (bytes), LY = CMP + 8, LX = 64 + 8:
//       2 ((R+2)(W+2) LY + R W LY
//          + max(2 (128 LX + 64 LY), 2 CMP LY, 2 CMP LX))
//     = 104,832 B at W = 56, CM = 64 (two blocks on an SM, 16 warps),
//     165,248 B at CM = 128 (one).  bottleneck_tc_kernel<64> (CMP <= 64)
//     is held to 128 registers for two blocks an SM (it takes 128, no
//     spill); <128> takes 200.
//     (Registers and spills: chip_smoke.py's build phase; times: PERF.md.)
//
// The kernel allocates nothing; the entry point launches on the stream
// it is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NW 8                // warps a block
#define NT (NW * 32)        // threads a block
#define PASS_PIX (16 * NW)  // pixels a pass: one 16-pixel M tile a warp
#define KC 64               // channels of x in a stage-1 chunk
#define NC 64               // output channels in a stage-3 chunk
#define LX (KC + 8)         // row stride of the staged x and w3 chunks

namespace {

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* x;
  const bf16* w1;
  const float* s1;
  const float* b1;
  const bf16* w2;
  const float* s2;
  const float* b2;
  const bf16* w3;
  const float* s3;
  const float* b3;
  bf16* out;
  int H, W, C, CM, R;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros when !in (nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// d += a b on the tensor cores: a 16x16 bf16, b 16x8 bf16, d 16x8 float32.
// With g = lane / 4 and t = lane % 4, d[0..1] sit at (row g, columns 2t,
// 2t+1) and d[2..3] at row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[0 .. 2 nj16) += A B for one 16-deep slice k0: A is the 16 x 16
// tile whose row for this lane (row lane % 16) starts at `arow`; B is
// rows k0 .. k0+15, columns [0, 16 nj16) of a (K, N) row-major matrix in
// shared memory with row stride ld.  Each mma starts from zero and its
// 16-term sum is added to acc by a rounded float32 add: fed back as the
// mma's C, the running sum is truncated at every step (see the note).
template <int MAXJ16>
__device__ __forceinline__ void mma_slice(float (&acc)[2 * MAXJ16][4],
                                          const bf16* arow, const bf16* w,
                                          int ld, int k0, int nj16,
                                          int lane) {
  uint32_t a[4];
  ldsm_x4(a, smem_u32(arow + k0 + (lane >> 4) * 8));
  const bf16* wk =
      w + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < MAXJ16; ++j) {
    if (j < nj16) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(wk + 16 * j));
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d0, a, b[0], b[1]);
      mma_bf16(d1, a, b[2], b[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * j][e] += d0[e];
        acc[2 * j + 1][e] += d1[e];
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// A rows x cols bf16 matrix (global row stride gld) into shared memory
// with row stride ld; zeros at rows >= rows_in or columns >= cols_in.
// cols, cols_in and gld are multiples of 8.
__device__ __forceinline__ void load_chunk(bf16* dst, int ld, const bf16* src,
                                           int gld, int rows, int cols,
                                           int rows_in, int cols_in) {
  const int cch = cols / 8;
  for (int i = threadIdx.x; i < rows * cch; i += NT) {
    const int r = i / cch, c = (i % cch) * 8;
    const bool in = r < rows_in && c < cols_in;
    cp_async16(dst + r * ld + c, in ? src + (size_t)r * gld + c : src, in);
  }
}

// Pixels [p0, p0 + PASS_PIX) of the band's stage-1 rows (image rows h0-1
// .. h0+Rb, contiguous in x), channels [c0, c0 + KC); zeros for pixels
// past m1, rows outside the image and channels past C.
__device__ __forceinline__ void load_x_chunk(bf16* dst, const bf16* ximg,
                                             int p0, int m1, int h0, int H,
                                             int W, int C, int c0) {
  constexpr int cch = KC / 8;
  for (int i = threadIdx.x; i < PASS_PIX * cch; i += NT) {
    const int r = i / cch, c = (i % cch) * 8, p = p0 + r, h = h0 - 1 + p / W;
    const bool in = p < m1 && h >= 0 && h < H && c0 + c < C;
    const long long at = ((long long)(h0 - 1) * W + p) * C + c0 + c;
    cp_async16(dst + r * LX + c, in ? ximg + at : ximg, in);
  }
}

// Two floats rounded to bf16 and stored as one pair.
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// CMT: the widest CMP the instantiation takes (64 or 128).
template <int CMT>
__global__ void __launch_bounds__(NT, CMT == 64 ? 2 : 1)
    bottleneck_tc_kernel(Params p) {
  constexpr int J16 = CMT / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = p.H, W = p.W, C = p.C, CM = p.CM, R = p.R;
  const int CMP = (CM + 15) & ~15, LY = CMP + 8, nj16 = CMP / 16;
  const int h0 = blockIdx.x * R, Rb = min(R, H - h0);
  const int W2 = W + 2, m1 = (Rb + 2) * W, m2 = Rb * W;
  bf16* y1s = reinterpret_cast<bf16*>(smem_raw);   // (R+2) x (W+2) x LY
  bf16* y2s = y1s + (size_t)(R + 2) * W2 * LY;      // R W x LY
  bf16* stg = y2s + (size_t)R * W * LY;             // two chunk stages
  const size_t img = (size_t)blockIdx.y * H * W * C;
  const bf16* xb = p.x + img;
  bf16* ob = p.out + img;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ring columns 0 and W+1 of every y1 row: zero
  for (int i = threadIdx.x; i < (Rb + 2) * 2 * (CMP / 8); i += NT) {
    const int c = (i % (CMP / 8)) * 8, side = (i / (CMP / 8)) & 1;
    const int r = i / (2 * (CMP / 8));
    *reinterpret_cast<uint4*>(y1s + ((size_t)r * W2 + (side ? W + 1 : 0)) * LY +
                              c) = make_uint4(0u, 0u, 0u, 0u);
  }

  float acc[2 * J16][4];
  zero_acc(acc);

  // -- stage 1: y1 for image rows h0-1 .. h0+Rb (zero outside the image)
  {
    const int nk = (C + KC - 1) / KC, n = nk * ((m1 + PASS_PIX - 1) / PASS_PIX);
    const int sz = PASS_PIX * LX + KC * LY;
    auto load = [&](int it, bf16* sx) {
      const int c0 = (it % nk) * KC;
      load_x_chunk(sx, xb, (it / nk) * PASS_PIX, m1, h0, H, W, C, c0);
      load_chunk(sx + PASS_PIX * LX, LY, p.w1 + (size_t)c0 * CM, CM, KC, CMP,
                 C - c0, CM);
      cp_async_commit();
    };
    load(0, stg);
    for (int it = 0; it < n; ++it) {
      const bf16* sx = stg + (it & 1) * sz;
      cp_async_wait_all();
      __syncthreads();  // chunk it landed; every warp is done with it-1
      if (it + 1 < n) load(it + 1, stg + ((it + 1) & 1) * sz);
      const int pm = (it / nk) * PASS_PIX + warp * 16;
      if (pm >= m1) continue;
      const bf16* arow = sx + (warp * 16 + (lane & 15)) * LX;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
        mma_slice<J16>(acc, arow, sx + PASS_PIX * LX, LY, ks * 16, nj16, lane);
      if (it % nk != nk - 1) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pp = pm + g + 8 * hh, r = pp / W, h = h0 - 1 + r;
        const bool live = h >= 0 && h < H;
        bf16* dst = y1s + ((size_t)r * W2 + pp % W + 1) * LY;
#pragma unroll
        for (int jn = 0; jn < 2 * J16; ++jn) {
          const int c = jn * 8 + 2 * t;
          if (pp >= m1 || jn >= 2 * nj16) continue;
          float v0 = 0.f, v1 = 0.f;
          if (live && c < CM) {
            v0 = fmaxf(fmaf(acc[jn][2 * hh], p.s1[c], p.b1[c]), 0.f);
            v1 = fmaxf(fmaf(acc[jn][2 * hh + 1], p.s1[c + 1], p.b1[c + 1]), 0.f);
          }
          store2(dst + c, v0, v1);
        }
      }
      zero_acc(acc);
    }
  }
  __syncthreads();  // y1 complete; the chunk stages are free

  // -- stage 2: y2 = relu(conv3x3(y1) * s2 + b2) for the band's rows
  {
    const int n = 9 * ((m2 + PASS_PIX - 1) / PASS_PIX), sz = CMP * LY;
    auto load = [&](int it, bf16* sw) {
      load_chunk(sw, LY, p.w2 + (size_t)(it % 9) * CM * CM, CM, CMP, CMP, CM,
                 CM);
      cp_async_commit();
    };
    load(0, stg);
    for (int it = 0; it < n; ++it) {
      const bf16* sw = stg + (it & 1) * sz;
      cp_async_wait_all();
      __syncthreads();
      if (it + 1 < n) load(it + 1, stg + ((it + 1) & 1) * sz);
      const int pm = (it / 9) * PASS_PIX + warp * 16, tap = it % 9;
      if (pm >= m2) continue;
      const int pa = min(pm + (lane & 15), m2 - 1);  // this lane's A row
      const bf16* arow =
          y1s + ((size_t)(pa / W + tap / 3) * W2 + pa % W + tap % 3) * LY;
#pragma unroll
      for (int ks = 0; ks < J16; ++ks)
        if (ks < nj16) mma_slice<J16>(acc, arow, sw, LY, ks * 16, nj16, lane);
      if (tap != 8) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pp = pm + g + 8 * hh;
#pragma unroll
        for (int jn = 0; jn < 2 * J16; ++jn) {
          const int c = jn * 8 + 2 * t;
          if (pp >= m2 || jn >= 2 * nj16) continue;
          float v0 = 0.f, v1 = 0.f;
          if (c < CM) {
            v0 = fmaxf(fmaf(acc[jn][2 * hh], p.s2[c], p.b2[c]), 0.f);
            v1 = fmaxf(fmaf(acc[jn][2 * hh + 1], p.s2[c + 1], p.b2[c + 1]), 0.f);
          }
          store2(y2s + (size_t)pp * LY + c, v0, v1);
        }
      }
      zero_acc(acc);
    }
  }
  __syncthreads();  // y2 complete; the chunk stages are free

  // -- stage 3: out = relu(y2 . w3 * s3 + b3 + x), NC channels at a time
  {
    const int nn = (C + NC - 1) / NC, n = nn * ((m2 + PASS_PIX - 1) / PASS_PIX);
    const int sz = CMP * LX;
    auto load = [&](int it, bf16* sw) {
      const int c0 = (it % nn) * NC;
      load_chunk(sw, LX, p.w3 + c0, C, CMP, NC, CM, C - c0);
      cp_async_commit();
    };
    load(0, stg);
    for (int it = 0; it < n; ++it) {
      const bf16* sw = stg + (it & 1) * sz;
      cp_async_wait_all();
      __syncthreads();
      if (it + 1 < n) load(it + 1, stg + ((it + 1) & 1) * sz);
      const int pm = (it / nn) * PASS_PIX + warp * 16, c0 = (it % nn) * NC;
      if (pm >= m2) continue;
      const bf16* arow = y2s + (size_t)min(pm + (lane & 15), m2 - 1) * LY;
      float o[NC / 8][4];
      zero_acc(o);
#pragma unroll
      for (int ks = 0; ks < J16; ++ks)
        if (ks < nj16) mma_slice<NC / 16>(o, arow, sw, LX, ks * 16, NC / 16, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pp = pm + g + 8 * hh;
        if (pp >= m2) continue;
        const size_t at = ((size_t)(h0 + pp / W) * W + pp % W) * C;
#pragma unroll
        for (int jn = 0; jn < NC / 8; ++jn) {
          const int c = c0 + jn * 8 + 2 * t;
          if (c >= C) continue;
          const float2 skip = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xb + at + c));
          store2(ob + at + c,
                 fmaxf(fmaf(o[jn][2 * hh], p.s3[c], p.b3[c]) + skip.x, 0.f),
                 fmaxf(fmaf(o[jn][2 * hh + 1], p.s3[c + 1], p.b3[c + 1]) +
                           skip.y, 0.f));
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Output rows of one band (one block): as many whole rows of width W as fill
// a pass of PASS_PIX pixels, at least one.  The last band may be shorter.
int resnet_bottleneck_band_rows(int W) {
  return W >= PASS_PIX ? 1 : PASS_PIX / W;
}

// Dynamic shared memory of one block for image rows W wide and CM
// bottleneck channels (the formula in the note above).
size_t resnet_bottleneck_smem(int W, int CM) {
  const size_t R = resnet_bottleneck_band_rows(W);
  const size_t CMP = (size_t)(CM + 15) / 16 * 16, LY = CMP + 8;
  size_t stages = 2 * ((size_t)PASS_PIX * LX + (size_t)KC * LY);
  if (2 * CMP * LY > stages) stages = 2 * CMP * LY;
  if (2 * CMP * LX > stages) stages = 2 * CMP * LX;
  return sizeof(bf16) *
         ((R + 2) * (W + 2) * LY + R * W * LY + stages);
}

// Shapes come from the caller, which has checked them: C and CM multiples
// of 8, CM <= 128, every pointer 16-byte aligned, the shared memory within
// 227 KB.
int resnet_bottleneck(const void* x, const void* w1, const void* s1,
                      const void* b1, const void* w2, const void* s2,
                      const void* b2, const void* w3, const void* s3,
                      const void* b3, void* out, int B, int H, int W, int C,
                      int CM, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;  // nothing to do
  const int R = resnet_bottleneck_band_rows(W);
  const Params p = {(const bf16*)x,  (const bf16*)w1, (const float*)s1,
                    (const float*)b1, (const bf16*)w2, (const float*)s2,
                    (const float*)b2, (const bf16*)w3, (const float*)s3,
                    (const float*)b3, (bf16*)out,       H, W, C, CM, R};
  void (*kernel)(Params) =
      CM <= 64 ? bottleneck_tc_kernel<64> : bottleneck_tc_kernel<128>;
  const size_t smem = resnet_bottleneck_smem(W, CM);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((H + R - 1) / R, B);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
