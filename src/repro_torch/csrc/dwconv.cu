// Depthwise 3x3 quantized convolution for Hopper (sm_90a): the level conv
// of a MobileNet block's depthwise layer, each channel against its own
// nine weights.
//
// Replaces: no TPU kernel.  The JAX package has no grouped convolution;
// every engine of the port computes a dense GEMM over kh*kw*Cin, so a
// depthwise layer through im2col would do C times the work on a
// block-diagonal weight matrix.  This kernel was added for MobileNet-v1
// (models/cnn.py, mobilenet_v1_spec), the ``depthwise`` engine.
//
//   out[b, oh, ow, c] = f32(acc2) * s_half
//   acc2 = sum_{dy,dx} X[b, oh*S+dy-pt, ow*S+dx-pl, c] * (2 W[(dy,dx), c] - z2)
//
// X is (B, H, W, C) unsigned 8-bit activation levels (NHWC), W is (9, C)
// unsigned 8-bit weight levels (tap-major, the HWIO weight with I = 1
// flattened), out is (B, OH, OW, C) float32.  acc2 is twice the exact sum
// of a * (w - z) (z2 = 2 z is an integer for every DoReFa zero point), an
// int32 below 2^24, so its float is exact and the output is the one
// rounding of acc2 * s_half, s_half = s / 2 exactly (s the epilogue's
// scale, s_a * s_w): the plain version (kernels/dwconv.py, dwconv_plain)
// computes the same integers and the same product, bit for bit.  Pixels
// outside the image read as level 0 at the SAME-split offsets (pt, pl)
// the host computes with core/conv_lowering.pad_split.
//
// What bounds it on an H100: bytes.  Nine multiply-adds an output against
// one byte in (four at stride 2) and four bytes out: MobileNet-v1's 13
// depthwise layers at batch 256 move 2.8 GB, 0.83 ms at 3.35 TB/s, while
// their 4.6 G multiply-adds take the CUDA cores' integer units ~0.1 ms.
// The float32 output is 80% of the bytes at stride 1.
//
// Design.
//  * A thread owns 4 consecutive channels (one 4-byte load of X per
//    pixel, one 16-byte store a pixel) of PIX = 4 consecutive output
//    pixels of a row: it reads the (PIX - 1) * S + 3 input columns of
//    each of the 3 rows once, 18 loads at stride 1 for 36 outputs'
//    taps, and keeps its 9 x 4 weights in registers.
//  * Threads of a warp take consecutive channel groups first, then the
//    next pixels of the row, so a warp's loads and stores are contiguous
//    runs of C bytes and 4 C bytes: every 32-byte sector it stores is
//    written whole.  The inputs' reuse across the 3 rows and neighbouring
//    threads is left to L1 and L2 (each row is read by 3 output rows).
//  * Integer multiply-adds on the CUDA cores, int32 exact; the epilogue
//    is __fmul_rn (no contraction) of the exact float.
//  * One launch a call, a 1-D grid of 256-thread blocks over (batch,
//    output row, pixel group, channel group); 64-bit offsets.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PIX = 4;       // output pixels a thread, along a row
constexpr int THREADS = 256;
constexpr int K = 3;         // the kernel's side

template <int S>
__global__ void __launch_bounds__(THREADS)
dwconv_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
              float* __restrict__ out, int H, int W, int C, int OH, int OW,
              int pad_top, int pad_left, int z2, float s_half,
              long long items) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS
                      + threadIdx.x;
  if (t >= items) return;
  const int c4 = C >> 2;
  const int groups = (OW + PIX - 1) / PIX;
  const int cq = static_cast<int>(t % c4);
  long long r = t / c4;
  const int ox0 = static_cast<int>(r % groups) * PIX;
  r /= groups;
  const int oy = static_cast<int>(r % OH);
  const long long n = r / OH;

  int wk[K * K][4];
  const uchar4* w4 = reinterpret_cast<const uchar4*>(w);
#pragma unroll
  for (int tap = 0; tap < K * K; ++tap) {
    const uchar4 v = __ldg(w4 + tap * c4 + cq);
    wk[tap][0] = 2 * v.x - z2;
    wk[tap][1] = 2 * v.y - z2;
    wk[tap][2] = 2 * v.z - z2;
    wk[tap][3] = 2 * v.w - z2;
  }

  int acc[PIX][4];
#pragma unroll
  for (int p = 0; p < PIX; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0;

  constexpr int COLS = (PIX - 1) * S + K;
  const uchar4* x4 = reinterpret_cast<const uchar4*>(x);
  const int ix0 = ox0 * S - pad_left;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int iy = oy * S - pad_top + dy;
    if (iy < 0 || iy >= H) continue;
    const uchar4* row = x4 + ((n * H + iy) * W) * c4 + cq;
#pragma unroll
    for (int col = 0; col < COLS; ++col) {
      const int ix = ix0 + col;
      const uchar4 a = (ix >= 0 && ix < W)
                           ? __ldg(row + static_cast<long long>(ix) * c4)
                           : make_uchar4(0, 0, 0, 0);
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        const int dx = col - p * S;
        if (dx < 0 || dx >= K) continue;
        const int tap = dy * K + dx;
        acc[p][0] += static_cast<int>(a.x) * wk[tap][0];
        acc[p][1] += static_cast<int>(a.y) * wk[tap][1];
        acc[p][2] += static_cast<int>(a.z) * wk[tap][2];
        acc[p][3] += static_cast<int>(a.w) * wk[tap][3];
      }
    }
  }

  float4* o4 = reinterpret_cast<float4*>(out);
  const long long base = ((n * OH + oy) * OW + ox0) * c4 + cq;
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    if (ox0 + p >= OW) break;
    o4[base + static_cast<long long>(p) * c4] =
        make_float4(__fmul_rn(__int2float_rn(acc[p][0]), s_half),
                    __fmul_rn(__int2float_rn(acc[p][1]), s_half),
                    __fmul_rn(__int2float_rn(acc[p][2]), s_half),
                    __fmul_rn(__int2float_rn(acc[p][3]), s_half));
  }
}

}  // namespace

// x: (B, H, W, C) u8 levels, w: (9, C) u8 levels, out: (B, OH, OW, C)
// float32; C a multiple of 4, x and w 4-byte aligned, out 16-byte
// aligned; stride 1 or 2.  Returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int dwconv_launch(const void* x, const void* w, void* out, int B,
                             int H, int W, int C, int stride, int OH, int OW,
                             int pad_top, int pad_left, int z2, float s_half,
                             void* stream) {
  if (C <= 0 || (C & 3) != 0 || (stride != 1 && stride != 2)
      || (reinterpret_cast<uintptr_t>(x) & 3) != 0
      || (reinterpret_cast<uintptr_t>(w) & 3) != 0
      || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(B) * OH
                          * ((OW + PIX - 1) / PIX) * (C / 4);
  if (items == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((items + THREADS - 1) / THREADS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* x8 = static_cast<const uint8_t*>(x);
  const uint8_t* w8 = static_cast<const uint8_t*>(w);
  float* o = static_cast<float*>(out);
  if (stride == 1)
    dwconv_kernel<1><<<grid, THREADS, 0, st>>>(x8, w8, o, H, W, C, OH, OW,
                                              pad_top, pad_left, z2, s_half,
                                              items);
  else
    dwconv_kernel<2><<<grid, THREADS, 0, st>>>(x8, w8, o, H, W, C, OH, OW,
                                              pad_top, pad_left, z2, s_half,
                                              items);
  return static_cast<int>(cudaGetLastError());
}
