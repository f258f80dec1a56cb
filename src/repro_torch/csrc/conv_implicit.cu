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
// is bytes (their float32 outputs, up to 6.6 MB) and for AlexNet conv1-4
// int8 tensor-core operations (K = 2304..3456 multiply-adds an output), a
// few microseconds either way.  The first kernel issued __dp4a on the
// CUDA cores and staged synchronously, 20-45x over those bounds, and gave
// svhn conv5 (a 10x10 map) only 64 blocks.
//
// Design.
//  * Tensor cores on u8: mma.sync m16n8k32 .u8.u8.s32, exact int32 sums,
//    so the output equals the plain version bit for bit.
//  * Implicit im2col from shared memory: each block stages the halo'd row
//    span its output pixels need once, ((rows - 1) * stride + kh) input
//    rows x ((OW - 1) * stride + kw) columns, each pixel's channels at a
//    pitch of an odd number of 16-byte chunks (Cin zero-padded to 16), so
//    the 8 pixels of an ldmatrix phase fall in 8 distinct bank groups.  K
//    is walked as 16-channel chunks q = (tap, channel chunk); ldmatrix
//    takes one row address a lane, so each lane points straight at its
//    (pixel, tap)'s 16 channel bytes; a k32 mma step is two chunks.
//    Chunks past the last one read a zeroed 16 bytes.
//  * W stays (K, N) in device memory: the B fragments are transposed in
//    registers (ldmatrix.x4.trans of 2x2 byte blocks + __byte_perm,
//    u8_mma.cuh, as in fused_qgemm.cu), and a lane owns 4 consecutive
//    output channels.
//  * cp.async staging: the span goes with the first weight stage; weight
//    slabs of 8 chunks (128 K rows x 64 channels) stream through a ring
//    of NST = 4 stages, three in flight while the tensor cores work.  Rows
//    of W past Cin within a chunk are zero-filled.  Images with Cin not a
//    multiple of 16, or W with Cout not a multiple of 16, are staged
//    through registers instead.
//  * The pixel tile TM (128, 64, 32 or 16 output pixels x 64 channels) is
//    the largest that gives the grid at least one block a SM, within the
//    shared memory: svhn conv5 at batch 8 runs 224 blocks of 16 pixels.
//    The host picks it with the same function that bounds the plan's
//    feasibility (kernels/conv_implicit.py, smem_layout), and the
//    launcher checks the shared memory it is given against its own sum
//    (span, weight ring, per-chunk tables, a zero chunk, the row sums:
//    all dynamic, so the whole 227 KB is the bound).
//  * Index arithmetic off the main loop: each block tabulates, per chunk,
//    its span offset and its first W row and real-channel count, so the
//    ring loads and the ldmatrix addresses are table reads; the span's
//    staging divides by multiply-high.
//  * The rowsum is summed from the A fragments (__dp4a against ones) by
//    the warps of the first channel group.  The epilogue uses
//    __fmul_rn/__fsub_rn (no FMA contraction).
//  * cudaFuncSetAttribute (the full 227 KB) once a process per tile.
//
// Later work: wgmma with a TMA producer warp for the 64-row tiles of
// svhn conv1-2 and AlexNet conv1; u4 mma (m16n8k64) at W1A4; a cluster
// that shares one weight slab between the pixel tiles of a map.

#include <cuda_runtime.h>
#include <stdint.h>

#include "u8_mma.cuh"
#include "smem_optin.cuh"

namespace {

using namespace u8mma;

constexpr int TN = W_ROW;           // output channels per block
constexpr int CH = 8;               // 16-channel chunks a pipeline stage
constexpr int BK = CH * 16;         // K rows a stage
constexpr int NST = 4;              // stages of the cp.async ring
constexpr int W_STAGE = BK * TN;    // bytes of one weight stage
constexpr int SMEM_LIMIT = 232448;  // an H100 block's shared memory

// Block of WARPS_M x WARPS_N warps, each FM 16-pixel rows x 64 / WARPS_N
// channels.  x_async / w_async: stage X / W by cp.async (Cin / Cout a
// multiple of 16, 16-byte aligned), else through registers.
template <int WARPS_M, int FM, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
conv_implicit_kernel(const uint8_t* __restrict__ x,
                     const uint8_t* __restrict__ w,
                     float* __restrict__ out, int H, int W, int Cin,
                     int Cout, int kh, int kw, int stride, int OH, int OW,
                     int pad_top, int pad_left, int cpitch, int xs_bytes,
                     int x_async, int w_async, float s, float t) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = FM * 16, TM = WARPS_M * WM;
  constexpr int WN = TN / WARPS_N, FN = WN / 16;
  extern __shared__ __align__(128) uint8_t smem[];

  const int cpt = (Cin + 15) / 16;   // 16-channel chunks of one tap
  const int nq = kh * kw * cpt;      // chunks of the zero-padded K
  const int nkt = (nq + CH - 1) / CH;
  const int nqp = nkt * CH;          // ... padded to whole stages
  uint8_t* Xs = smem;
  uint8_t* Ws = smem + xs_bytes;
  // per chunk q: its span offset (-1 past the last chunk), and its first
  // K row of W with the rows that are real channels (0 past the last)
  int* qx = reinterpret_cast<int*>(Ws + NST * W_STAGE);
  int2* qw = reinterpret_cast<int2*>(qx + nqp);
  uint8_t* zero = reinterpret_cast<uint8_t*>(qw + nqp);
  unsigned* rs_s = reinterpret_cast<unsigned*>(zero + 16);  // TM rowsums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, n0 = blockIdx.y * TN;
  const int npix = OH * OW, p0 = blockIdx.x * TM;
  const int p_last = min(p0 + TM, npix) - 1;
  const int r0 = p0 / OW;
  const int nrows = (p_last / OW - r0) * stride + kh;
  const int SW = (OW - 1) * stride + kw;
  const int in_row0 = r0 * stride - pad_top;
  const uint8_t* xb = x + static_cast<size_t>(b) * H * W * Cin;

  for (int q = tid; q < nqp; q += THREADS) {
    if (q < nq) {
      const int tap = q / cpt, c16 = q - tap * cpt;
      qx[q] = ((tap / kw) * SW + tap % kw) * cpitch + c16 * 16;
      qw[q] = make_int2(tap * Cin + c16 * 16, min(16, Cin - c16 * 16));
    } else {
      qx[q] = -1;
      qw[q] = make_int2(0, 0);
    }
  }
  if (tid == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // weight stage st <- chunks kt*CH .. kt*CH + CH - 1 of the padded K
  auto load_w = [&](int st, int kt) {
    uint8_t* ws = Ws + st * W_STAGE;
#pragma unroll
    for (int i = 0; i < BK * 4 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 2, ch = c & 3, rr = r & 15;
      const int2 qc = qw[kt * CH + (r >> 4)];
      const int gn = n0 + ch * 16;
      const bool krow = rr < qc.y;
      const uint8_t* src = w + static_cast<size_t>(qc.x + rr) * Cout + gn;
      uint8_t* dst = ws + w_off(r, ch);
      if (w_async) {
        const bool ok = krow && gn < Cout;
        cp_async16(dst, ok ? src : w, ok);
      } else {
        unsigned v[4] = {0u, 0u, 0u, 0u};
        if (krow) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (gn + j < Cout)
              v[j >> 2] |= static_cast<unsigned>(src[j]) << (8 * (j & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  // ---- the halo'd row span (out-of-image pixels are level 0) and the
  // first weight stage: cp.async group 0.  n / d as a multiply-high by
  // ceil(2^32 / d): exact while n * d < 2^32.
  {
    const unsigned long long m_cpt = ((1ull << 32) + cpt - 1) / cpt;
    const unsigned long long m_sw = ((1ull << 32) + SW - 1) / SW;
    const unsigned total = nrows * SW * cpt;
    for (unsigned e = tid; e < total; e += THREADS) {
      const unsigned pix = static_cast<unsigned>((e * m_cpt) >> 32);
      const unsigned row = static_cast<unsigned>((pix * m_sw) >> 32);
      const int ch = e - pix * cpt;
      const int ir = in_row0 + static_cast<int>(row);
      const int ic = static_cast<int>(pix - row * SW) - pad_left;
      const bool in = ir >= 0 && ir < H && ic >= 0 && ic < W;
      const uint8_t* src =
          in ? xb + (static_cast<size_t>(ir) * W + ic) * Cin + ch * 16 : x;
      uint8_t* dst = Xs + pix * cpitch + ch * 16;
      if (x_async) {
        cp_async16(dst, src, in);
      } else {
        unsigned v[4] = {0u, 0u, 0u, 0u};
        if (in) {
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (ch * 16 + i < Cin)
              v[i >> 2] |= static_cast<unsigned>(src[i]) << (8 * (i & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  load_w(0, 0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < NST - 1; ++st) {
    if (st < nkt) load_w(st, st);
    cp_async_commit();
  }

  // this lane's ldmatrix pixel in each of its 16-pixel tiles
  int pixoff[FM];
#pragma unroll
  for (int fm = 0; fm < FM; ++fm) {
    const int p = p0 + wm * WM + fm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    pixoff[fm] = p < npix ? (((p / OW - r0) * stride) * SW + (p % OW) * stride)
                                * cpitch
                          : 0;
  }
  const int achunk = lane >> 4, bkrow = b_krow(lane);

  int acc[FM][FN][2][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][0][e] = acc[i][j][1][e] = 0;
  unsigned rs[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i) rs[i][0] = rs[i][1] = 0u;

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage `it` (and, at it = 0, the span) has landed
    if (it + NST - 1 < nkt) load_w((it + NST - 1) % NST, it + NST - 1);
    cp_async_commit();
    const uint8_t* ws = Ws + (it % NST) * W_STAGE;
    const int q0 = it * CH;
#pragma unroll
    for (int kk = 0; kk < CH / 2; ++kk) {
      // chunks past the last read zeros against zero-filled weight rows
      const int qoff = qx[q0 + 2 * kk + achunk];
      unsigned afr[FM][4];
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
        ldsm_x4(afr[fm], qoff >= 0 ? Xs + pixoff[fm] + qoff : zero);
      if (wn == 0) {
#pragma unroll
        for (int fm = 0; fm < FM; ++fm) {
          rs[fm][0] = __dp4a(afr[fm][0], 0x01010101u, rs[fm][0]);
          rs[fm][0] = __dp4a(afr[fm][2], 0x01010101u, rs[fm][0]);
          rs[fm][1] = __dp4a(afr[fm][1], 0x01010101u, rs[fm][1]);
          rs[fm][1] = __dp4a(afr[fm][3], 0x01010101u, rs[fm][1]);
        }
      }
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) {
        unsigned ev[2], od[2];
        b_frags(ws, kk * 32 + bkrow, (wn * WN) / 16 + fn, ev, od);
#pragma unroll
        for (int fm = 0; fm < FM; ++fm) {
          mma_u8(acc[fm][fn][0], afr[fm], ev[0], ev[1]);
          mma_u8(acc[fm][fn][1], afr[fm], od[0], od[1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (wn == 0) {
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned v = rs[fm][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tg == 0) rs_s[wm * WM + fm * 16 + h * 8 + g] = v;
      }
  }
  __syncthreads();

  float* ob = out + static_cast<size_t>(b) * npix * Cout;
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lp = wm * WM + fm * 16 + h * 8 + g, p = p0 + lp;
      if (p >= npix) continue;
      const float corr = __fmul_rn(t, __uint2float_rn(rs_s[lp]));
      float* orow = ob + static_cast<size_t>(p) * Cout;
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) {
        const int co = n0 + wn * WN + fn * 16 + 4 * tg;
        const float v[4] = {dequant(s, acc[fm][fn][0][2 * h], corr),
                            dequant(s, acc[fm][fn][1][2 * h], corr),
                            dequant(s, acc[fm][fn][0][2 * h + 1], corr),
                            dequant(s, acc[fm][fn][1][2 * h + 1], corr)};
        store4(orow, co, Cout, v);
      }
    }
}

template <int WARPS_M, int FM, int WARPS_N>
cudaError_t launch(const uint8_t* x, const uint8_t* w, float* out, int B,
                   int H, int W, int Cin, int Cout, int kh, int kw,
                   int stride, int OH, int OW, int pad_top, int pad_left,
                   int cpitch, int xs_bytes, int smem_bytes, int x_async,
                   int w_async, float s, float t, cudaStream_t st) {
  constexpr int TM = WARPS_M * FM * 16;
  auto* kern = conv_implicit_kernel<WARPS_M, FM, WARPS_N>;
  static int opted_in[smem_optin::MAX_DEVICES] = {};  // the whole 227 KB
  const cudaError_t e = smem_optin::ensure(kern, SMEM_LIMIT, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid((OH * OW + TM - 1) / TM, (Cout + TN - 1) / TN, B);
  kern<<<grid, WARPS_M * WARPS_N * 32, smem_bytes, st>>>(
      x, w, out, H, W, Cin, Cout, kh, kw, stride, OH, OW, pad_top, pad_left,
      cpitch, xs_bytes, x_async, w_async, s, t);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the launch's error (0 on success).  The host
// computes the pixel tile tm, cpitch, xs_bytes and smem_bytes with the
// same function that the plan's feasibility bound uses
// (kernels/conv_implicit.py, smem_layout); a shared memory size other than
// this kernel's own sum for that layout is refused (cudaErrorInvalidValue).
extern "C" int conv_implicit_launch(const void* x, const void* w, void* out,
                                    int B, int H, int W, int Cin, int Cout,
                                    int kh, int kw, int stride, int OH,
                                    int OW, int pad_top, int pad_left,
                                    int tm, int cpitch, int xs_bytes,
                                    int smem_bytes, float s, float t,
                                    void* stream) {
  const int nqp = (kh * kw * ((Cin + 15) / 16) + CH - 1) / CH * CH;
  if (smem_bytes != xs_bytes + NST * W_STAGE + 12 * nqp + 16 + 4 * tm
      || smem_bytes > SMEM_LIMIT || cpitch % 32 != 16 || cpitch < Cin)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* x8 = static_cast<const uint8_t*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(w);
  const int x_async =
      (Cin & 15) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int w_async =
      (Cout & 15) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (tm) {
    case 128:
      e = launch<4, 2, 2>(x8, w8, o, B, H, W, Cin, Cout, kh, kw, stride, OH,
                          OW, pad_top, pad_left, cpitch, xs_bytes,
                          smem_bytes, x_async, w_async, s, t, st);
      break;
    case 64:
      e = launch<2, 2, 2>(x8, w8, o, B, H, W, Cin, Cout, kh, kw, stride, OH,
                          OW, pad_top, pad_left, cpitch, xs_bytes,
                          smem_bytes, x_async, w_async, s, t, st);
      break;
    case 32:
      e = launch<2, 1, 2>(x8, w8, o, B, H, W, Cin, Cout, kh, kw, stride, OH,
                          OW, pad_top, pad_left, cpitch, xs_bytes,
                          smem_bytes, x_async, w_async, s, t, st);
      break;
    case 16:
      e = launch<1, 1, 4>(x8, w8, o, B, H, W, Cin, Cout, kh, kw, stride, OH,
                          OW, pad_top, pad_left, cpitch, xs_bytes,
                          smem_bytes, x_async, w_async, s, t, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
