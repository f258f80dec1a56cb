// Implicit-GEMM quantized convolution for Hopper (sm_90a): the level conv
// without an im2col tensor.
//
// Replaces: src/repro/kernels/conv_implicit.py, conv_implicit_pallas (_kernel).
//
//   out[b, oh, ow, co] = s * f32(acc) - t * f32(rowsum)
//   acc    = sum_{dy,dx,ci} X[b, oh*st+dy-pt, ow*st+dx-pl, ci] W[(dy,dx,ci), co]
//   rowsum = sum_{dy,dx,ci} X[b, oh*st+dy-pt, ow*st+dx-pl, ci]
//
// X is (B, H, W, Cin) unsigned 8-bit activation levels (NHWC), W is
// (kh*kw*Cin, Cout) unsigned 8-bit weight levels, K (kh, kw, cin)-major;
// out is (B, OH, OW, Cout) float32.  Pixels outside the image read as
// level 0 at the SAME-split offsets (pt, pl) the host computes with
// core/conv_lowering.pad_split — no padded copy is made in device memory.
//
// What bounds it on an H100: at batch 8 the card's bound for svhn conv1-5
// is bytes (their float32 outputs) and for AlexNet conv1-4 int8 tensor-core
// operations (K = 2304..3456 multiply-adds per output), a few microseconds
// either way.  This first kernel issues __dp4a on the CUDA cores, whose
// int8 rate is far below the tensor-core peak, so its time is set by dp4a
// issue, not by either bound.
//
// Design: the TPU kernel kept one whole padded image resident in VMEM per
// batch index.  A Hopper block has 227 KB of shared memory, so each block
// (64 output pixels of one image x 64 output channels) stages only the
// halo'd row span its pixels need: ((rows - 1) * stride + kh) input rows x
// ((OW - 1) * stride + kw) columns x Cin levels, with the channel pitch
// padded to an odd number of words so neighbouring pixels fall in
// different banks.  It then sweeps the kh*kw taps; for each tap the
// (Cin, 64) weight slab streams through shared memory in 128-channel
// chunks, stored transposed so four channels of one output channel form a
// word, and each __dp4a folds four channels of every bit-plane pair.
// The rowsum is summed once per pixel from the staged levels.  The
// epilogue uses __fmul_rn/__fsub_rn (no FMA contraction), so the result
// equals the plain PyTorch version bit for bit.  Later work: tensor-core
// mma on u8, TMA staging, and more blocks per image at small batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;       // output pixels per block
constexpr int TN = 64;       // output channels per block
constexpr int KC = 128;      // input channels per weight chunk
constexpr int WP = KC + 4;   // weight-chunk pitch in bytes (33 words)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
conv_implicit_kernel(const uint8_t* __restrict__ x,
                     const uint8_t* __restrict__ w,
                     float* __restrict__ out, int H, int W, int Cin,
                     int Cout, int kh, int kw, int stride, int OH, int OW,
                     int pad_top, int pad_left, int cpitch, int xs_bytes,
                     float s, float t) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Xs = smem;                       // staged rows x SW x cpitch
  uint8_t* Ws = smem + xs_bytes;            // TN x WP
  unsigned* rs_s = reinterpret_cast<unsigned*>(Ws + TN * WP);

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // output channels n0 + tx + 16*j
  const int ty = tid / 16;          // pixels p0 + ty*4 + i
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * TN;
  const int npix = OH * OW;
  const int p0 = blockIdx.x * TM;
  const int p_last = min(p0 + TM, npix) - 1;
  const int r0 = p0 / OW;
  const int nrows = (p_last / OW - r0) * stride + kh;
  const int SW = (OW - 1) * stride + kw;
  const int in_row0 = r0 * stride - pad_top;
  const int cw = cpitch / 4;
  const uint8_t* xb = x + (size_t)b * H * W * Cin;

  // ---- stage the halo'd row span; out-of-image pixels are level 0
  if ((Cin % 4) == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0) {
    const int total = nrows * SW * cw;
    for (int e = tid; e < total; e += THREADS) {
      const int c4 = e % cw, pix = e / cw;
      const int ir = in_row0 + pix / SW, ic = pix % SW - pad_left;
      uint32_t v = 0;
      if (c4 * 4 < Cin && ir >= 0 && ir < H && ic >= 0 && ic < W)
        v = *reinterpret_cast<const uint32_t*>(
            xb + ((size_t)ir * W + ic) * Cin + c4 * 4);
      reinterpret_cast<uint32_t*>(Xs)[e] = v;
    }
  } else {
    const int total = nrows * SW * cpitch;
    for (int e = tid; e < total; e += THREADS) {
      const int ci = e % cpitch, pix = e / cpitch;
      const int ir = in_row0 + pix / SW, ic = pix % SW - pad_left;
      uint8_t v = 0;
      if (ci < Cin && ir >= 0 && ir < H && ic >= 0 && ic < W)
        v = xb[((size_t)ir * W + ic) * Cin + ci];
      Xs[e] = v;
    }
  }
  __syncthreads();

  // ---- rowsum of each of the block's pixels
  if (tid < TM) {
    const int p = p0 + tid;
    unsigned rs = 0u;
    if (p < npix) {
      const int lr = p / OW - r0, oc = p % OW;
      for (int dy = 0; dy < kh; ++dy)
        for (int dx = 0; dx < kw; ++dx) {
          const uint32_t* px = reinterpret_cast<const uint32_t*>(
              Xs + ((lr * stride + dy) * SW + oc * stride + dx) * cpitch);
          for (int j = 0; j < cw; ++j) rs = __dp4a(px[j], 0x01010101u, rs);
        }
    }
    rs_s[tid] = rs;
  }

  int xoff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    xoff[i] = p < npix
                  ? (((p / OW - r0) * stride) * SW + (p % OW) * stride) * cpitch
                  : 0;
  }
  unsigned acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0u;

  const bool n_vec =
      (Cout % 16) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  for (int dy = 0; dy < kh; ++dy) {
    for (int dx = 0; dx < kw; ++dx) {
      const int tap = dy * kw + dx;
      const int tapoff = (dy * SW + dx) * cpitch;
      for (int c0 = 0; c0 < Cin; c0 += KC) {
        // weight chunk, transposed: Ws[n][kk] = W[tap*Cin + c0 + kk, n0 + n]
        {
          const int kk = tid >> 1, nn = (tid & 1) * 32;
          const bool krow = c0 + kk < Cin;
          const uint8_t* src = w + (size_t)(tap * Cin + c0 + kk) * Cout + n0 + nn;
          if (n_vec && krow && n0 + nn + 32 <= Cout) {
            uint4 v0 = reinterpret_cast<const uint4*>(src)[0];
            uint4 v1 = reinterpret_cast<const uint4*>(src)[1];
            const uint8_t* b0 = reinterpret_cast<const uint8_t*>(&v0);
            const uint8_t* b1 = reinterpret_cast<const uint8_t*>(&v1);
#pragma unroll
            for (int q = 0; q < 16; ++q) {
              Ws[(nn + q) * WP + kk] = b0[q];
              Ws[(nn + 16 + q) * WP + kk] = b1[q];
            }
          } else {
#pragma unroll
            for (int q = 0; q < 32; ++q)
              Ws[(nn + q) * WP + kk] =
                  (krow && n0 + nn + q < Cout) ? src[q] : 0;
          }
        }
        __syncthreads();
        const int nw = (min(KC, Cin - c0) + 3) / 4;
        const uint8_t* xt = Xs + tapoff + c0;
        for (int j = 0; j < nw; ++j) {
          uint32_t av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            av[i] = *reinterpret_cast<const uint32_t*>(xt + xoff[i] + 4 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            bv[i] = *reinterpret_cast<const uint32_t*>(Ws + (tx + 16 * i) * WP + 4 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[i][jj] = __dp4a(av[i], bv[jj], acc[i][jj]);
        }
        __syncthreads();
      }
    }
  }

  float* ob = out + (size_t)b * npix * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= npix) continue;
    const float corr = __fmul_rn(t, __uint2float_rn(rs_s[ty * 4 + i]));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int co = n0 + tx + 16 * jj;
      if (co < Cout)
        ob[(size_t)p * Cout + co] =
            __fsub_rn(__fmul_rn(s, __uint2float_rn(acc[i][jj])), corr);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The host
// computes cpitch, xs_bytes and smem_bytes with the same function that the
// plan's feasibility bound uses (kernels/conv_implicit.py, smem_layout).
extern "C" int conv_implicit_launch(const void* x, const void* w, void* out,
                                    int B, int H, int W, int Cin, int Cout,
                                    int kh, int kw, int stride, int OH,
                                    int OW, int pad_top, int pad_left,
                                    int cpitch, int xs_bytes, int smem_bytes,
                                    float s, float t, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_implicit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((OH * OW + TM - 1) / TM, (Cout + TN - 1) / TN, B);
  conv_implicit_kernel<<<grid, THREADS, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<float*>(out), H, W, Cin, Cout, kh, kw, stride, OH, OW,
      pad_top, pad_left, cpitch, xs_bytes, s, t);
  return static_cast<int>(cudaGetLastError());
}
