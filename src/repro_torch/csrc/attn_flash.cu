// Quantized flash attention (contiguous prefill), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/attn_flash.py, attn_flash_pallas
// (_flash_kernel).  Oracle: attn_flash_xla (its port attn_flash_plain).
//
//   out[b,i,h,:] = sum_j softmax_j(scale * (qc[b,i,h,:] . kc[b,j,h,:]))
//                  * v[b,j,h,:]
//
// over the keys j that the causal and window masks leave to row i.  q, k,
// v and out are float32 or bfloat16 (one type), in the reference's
// (B, S, H, hd) layout with KV already expanded for GQA.  qc, kc are the
// centred per-tensor levels clip(rint(x / s) + z, 0, 2^bits - 1) - z with
// s = max|x| / z + 1e-12, and scale = s_q * s_k * (1/sqrt(hd)), each step
// rounded as PyTorch rounds it on the card, so the levels and the logits
// equal the plain version's bit for bit.
//
// What bounds it on an H100: operations.  At the main path's prefill
// (B=2, S=2048, H=15, hd=64, causal) the score dots are ~2.1e6 per head
// and batch row, 2 * hd int8 operations each (~8 G at 1,979 TOP/s), and
// P @ V the same count of bf16 multiply-adds (~8 GFLOP at 989 TFLOP/s);
// the inputs are ~24 MB (~7 us at 3.35 TB/s).
//
// Design (three launches, no other device operation):
// 1. attn_flash_absmax_kernel: per-block partial max|q| and max|k|.
// 2. attn_flash_klevels_kernel: each block reduces the partials to s_k and
//    writes its share of K's int8 levels (K is read by every query tile,
//    so it is quantized once).
// 3. attn_flash_kernel, FlashAttention-2 in shape: a block owns 64 query
//    rows of one (batch, head), 16 per row group of warps; it reduces the
//    partials to the scales itself and quantizes its Q tile on load into
//    int8 A fragments held in registers.  K-level and V tiles of BK keys
//    come into shared memory by double-buffered cp.async (zero-filled past
//    Skv).  Up to hd 128 a row group is one warp (4 warps, 64 keys a
//    tile).  At hd 256 the 16 x 256 output accumulator would be 128 float
//    registers a thread, so a row group is two warps that each own half
//    of the output columns (8 warps); both compute the same scores and
//    softmax (the score dot is the cheap int8 half), and a float32 V at hd
//    256 takes tiles of 32 keys so its three bf16 parts fit shared memory.
//    hd 96 is 3 k-steps of the score mma and 12 output column tiles, with
//    112- and 208-byte row pitches that keep ldmatrix rows 16-byte
//    aligned and conflict-free.  hd 80 (hubert-xlarge) is 3 k-steps too,
//    the last half of the third on Q fragments zeroed in registers (the
//    level rows are padded to 96 columns, pitch 112), and 10 output
//    column tiles with a 176-byte V pitch.  S = Q K^T runs on mma.sync m16n8k32
//    s8 x s8 -> s32: exact, the plain version's integer, then __fmul_rn by
//    scale.  Masks apply only
//    on tiles that need them (the causal diagonal, the window's trailing
//    edge, a ragged last tile); a masked logit is NEG_INF and its weight
//    is 0, as the plain version multiplies by the mask.  The online
//    softmax stays in registers (row max and sums over the quad by
//    shuffle), its weights exp2f((s - m) * log2 e): within 3e-6 of expf,
//    relative, a weight, which the float32 tolerance (1e-5 x max|v|)
//    holds.  P @ V runs on mma.sync m16n8k16 bf16 -> f32 with V read by
//    ldmatrix.trans: P is split into bf16 parts, hi + lo (relative error
//    <= 2^-16 a weight), so bf16 V gives float32-accurate sums; a float32
//    V is split too, into three bf16 parts like P, and the six products
//    above 2^-24 are summed (the float32 instantiation serves the tests).
//    The grid puts the heaviest causal query tiles first.  The epilogue
//    divides by max(l, 1e-30) with IEEE division.  No -use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block (4 row groups of 16)
constexpr int RED_THREADS = 256;
constexpr int NPART = 2 * 132;  // blocks of the max|q|, max|k| reduction
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float absmax16(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}
__device__ __forceinline__ float absmax16(const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(__bfloat162float(e[i])));
  return m;
}

// max over the block of nonnegative values; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i)
    r = fmaxf(r, red[i]);
  return r;
}

// s = max|x| / z + 1e-12 as PyTorch computes it on the card (a division by
// a Python scalar is a multiply by its float reciprocal; 1/z is exact)
__device__ __forceinline__ float scale_of(float mx, int bits) {
  const float zf = static_cast<float>(1 << (bits - 1));
  return __fadd_rn(__fmul_rn(mx, __fdiv_rn(1.f, zf)), 1e-12f);
}

__device__ __forceinline__ int level(float x, float s, int bits) {
  const int zi = 1 << (bits - 1);
  float lv = rintf(__fdiv_rn(x, s)) + static_cast<float>(zi);
  lv = fminf(fmaxf(lv, 0.f), static_cast<float>((1 << bits) - 1));
  return static_cast<int>(lv) - zi;
}

// the scales from the reduction's partials (npart of q, then npart of k)
__device__ __forceinline__ void partial_scales(const float* part, int npart,
                                               int q_bits, int k_bits,
                                               float* red, float* s_q,
                                               float* s_k) {
  float mq = 0.f, mk = 0.f;
  for (int i = threadIdx.x; i < npart; i += blockDim.x) {
    mq = fmaxf(mq, part[i]);
    mk = fmaxf(mk, part[npart + i]);
  }
  *s_q = scale_of(block_max(mq, red), q_bits);
  *s_k = scale_of(block_max(mk, red), k_bits);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill ? 16 : 0;  // 0: zero-fill the destination
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// x ~ sum of N bf16 parts (low half of each word: x, high half: y)
template <int N>
__device__ __forceinline__ void split_bf16(float x, float y,
                                           unsigned (&parts)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    parts[i] = *reinterpret_cast<const unsigned*>(&h);
    x = __fsub_rn(x, __low2float(h));
    y = __fsub_rn(y, __high2float(h));
  }
}

// tiling and shared memory of attn_flash_kernel<HD, T>
template <int HD, typename T>
struct Tile {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int WN = HD > 128 ? 2 : 1;        // warps a row group
  static constexpr int THREADS = 128 * WN;
  static constexpr int DN = HD / WN;                 // output columns a warp
  static constexpr int BK = HD > 128 && F32 ? 32 : 64;  // keys per tile
  static constexpr int KS = (HD + 31) / 32;          // k-steps of the score
  static constexpr int KP = KS * 32 + 16;            // K-level row pitch
  static constexpr int VP = HD * sizeof(T) + 16;     // V row pitch, bytes
  static constexpr int BP = HD * 2 + 16;             // bf16 part row pitch
  static constexpr int NVP = F32 ? 3 : 0;            // bf16 parts of f32 V
  static constexpr int K_OFF = 0;                    // 2 x BK x KP
  static constexpr int V_OFF = K_OFF + 2 * BK * KP;  // 2 x BK x VP
  static constexpr int P_OFF = V_OFF + 2 * BK * VP;  // NVP x BK x BP
  static constexpr int Q_OFF = P_OFF + NVP * BK * BP;  // BQ x KP
  static constexpr int BYTES = Q_OFF + BQ * KP;
  // A k-step reads 32 level columns a row.  At hd % 32 == 16 (hd 80) the
  // last one reads 16 past hd: its Q fragments' upper half is zeroed in
  // registers, so those columns add nothing (the centred levels need no
  // other correction), and the reads stay inside the row pitch.  No other
  // head dim may be instantiated: a k-step that stopped short of hd would
  // drop columns of Q K^T.
  static_assert(HD % 32 == 0 || HD % 32 == 16,
                "the score k-steps must cover hd exactly or with one "
                "zeroed half step");
  static_assert(KS * 32 >= HD && KS * 32 <= KP,
                "k-steps must cover hd within the row pitch");
  static_assert(DN % 16 == 0, "P @ V takes 16 output columns at a time");
};

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
attn_flash_absmax_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         size_t nq, size_t nk, float* __restrict__ part) {
  __shared__ float red[RED_THREADS / 32];
  constexpr int VEC = 16 / sizeof(T);
  const size_t stride = static_cast<size_t>(gridDim.x) * RED_THREADS;
  const size_t i0 = static_cast<size_t>(blockIdx.x) * RED_THREADS + threadIdx.x;
  float mq = 0.f, mk = 0.f;
#pragma unroll 4
  for (size_t i = i0; i < nq / VEC; i += stride)
    mq = fmaxf(mq, absmax16(q + i * VEC));
#pragma unroll 4
  for (size_t i = i0; i < nk / VEC; i += stride)
    mk = fmaxf(mk, absmax16(k + i * VEC));
  mq = block_max(mq, red);
  mk = block_max(mk, red);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = mq;
    part[gridDim.x + blockIdx.x] = mk;
  }
}

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
attn_flash_klevels_kernel(const T* __restrict__ k, int8_t* __restrict__ kc,
                          size_t nk, const float* __restrict__ part, int npart,
                          int q_bits, int k_bits) {
  __shared__ float red[RED_THREADS / 32];
  float s_q, s_k;
  partial_scales(part, npart, q_bits, k_bits, red, &s_q, &s_k);
  constexpr int VEC = 16 / sizeof(T);
  const size_t stride = static_cast<size_t>(gridDim.x) * RED_THREADS;
  for (size_t i = static_cast<size_t>(blockIdx.x) * RED_THREADS + threadIdx.x;
       i < nk / VEC; i += stride) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + i * VEC);
    const T* e = reinterpret_cast<const T*>(&raw);
    if constexpr (VEC == 4) {
      char4 o;
      o.x = static_cast<char>(level(to_f32(e[0]), s_k, k_bits));
      o.y = static_cast<char>(level(to_f32(e[1]), s_k, k_bits));
      o.z = static_cast<char>(level(to_f32(e[2]), s_k, k_bits));
      o.w = static_cast<char>(level(to_f32(e[3]), s_k, k_bits));
      *reinterpret_cast<char4*>(kc + i * VEC) = o;
    } else {
      unsigned w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j / 4] |= (static_cast<unsigned>(level(to_f32(e[j]), s_k, k_bits))
                     & 0xffu) << (8 * (j % 4));
      *reinterpret_cast<uint2*>(kc + i * VEC) = make_uint2(w[0], w[1]);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(Tile<HD, T>::THREADS)
attn_flash_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                  const T* __restrict__ v, T* __restrict__ out,
                  const float* __restrict__ part, int npart, int Sq, int Skv,
                  int H, int causal, int window, int q_bits, int k_bits,
                  float inv_sqrt_hd) {
  using L = Tile<HD, T>;
  constexpr int BK = L::BK, THREADS = L::THREADS, DN = L::DN;
  constexpr int NPP = L::F32 ? 3 : 2;   // bf16 parts of P
  constexpr int KS = L::KS;              // k-steps of the score mma
  constexpr int ND = DN / 8;             // this warp's 8-column output tiles
  constexpr int NJ = BK / 8;             // 8-key score tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[THREADS / 32];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % 4, cn = warp / 4;  // row group, column group
  const int g = lane >> 2, tg = lane & 3;

  int kv_hi = Skv - 1;
  if (causal) kv_hi = min(kv_hi, q0 + BQ - 1);
  const int kv_lo = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int ntiles = kv_hi >= kv_lo ? (kv_hi - kv_lo) / BK + 1 : 0;

  auto issue = [&](int k0, int buf) {
    int8_t* kd = reinterpret_cast<int8_t*>(smem + L::K_OFF) + buf * BK * L::KP;
    unsigned char* vd = smem + L::V_OFF + buf * BK * L::VP;
    constexpr int KCH = HD / 16;
    constexpr int VCH = HD * static_cast<int>(sizeof(T)) / 16;
    for (int c = tid; c < BK * KCH; c += THREADS) {
      const int t = c / KCH, cc = c % KCH, j = k0 + t;
      const bool ok = j < Skv;
      cp_async16(kd + t * L::KP + cc * 16,
                 kc + ((static_cast<size_t>(b) * Skv + (ok ? j : 0)) * H + h)
                      * HD + cc * 16, ok);
    }
    for (int c = tid; c < BK * VCH; c += THREADS) {
      const int t = c / VCH, cc = c % VCH, j = k0 + t;
      const bool ok = j < Skv;
      cp_async16(vd + t * L::VP + cc * 16,
                 reinterpret_cast<const unsigned char*>(
                     v + ((static_cast<size_t>(b) * Skv + (ok ? j : 0)) * H + h)
                         * HD) + cc * 16, ok);
    }
    cp_async_commit();
  };
  if (ntiles > 0) issue(kv_lo, 0);

  float s_q, s_k;
  partial_scales(part, npart, q_bits, k_bits, red, &s_q, &s_k);
  const float scale = __fmul_rn(__fmul_rn(s_q, s_k), inv_sqrt_hd);

  int8_t* qs = reinterpret_cast<int8_t*>(smem + L::Q_OFF);
  {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int QCH = HD / VEC;  // 16 bytes of q at a time
#pragma unroll
    for (int c = tid; c < BQ * QCH; c += THREADS) {
      const int r = c / QCH, cc = c % QCH, i = q0 + r;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // rows past Sq: level 0
      if (i < Sq)
        raw = *reinterpret_cast<const uint4*>(
            q + ((static_cast<size_t>(b) * Sq + i) * H + h) * HD + cc * VEC);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        qs[r * L::KP + cc * VEC + j] = static_cast<int8_t>(
            i < Sq ? level(to_f32(e[j]), s_q, q_bits) : 0);
    }
  }
  __syncthreads();
  unsigned qa[KS][4];
  {
    const int8_t* qw = qs + rw * 16 * L::KP;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 32 + tg * 4;
      qa[kk][0] = *reinterpret_cast<const unsigned*>(qw + g * L::KP + c);
      qa[kk][1] = *reinterpret_cast<const unsigned*>(qw + (g + 8) * L::KP + c);
      qa[kk][2] = *reinterpret_cast<const unsigned*>(qw + g * L::KP + c + 16);
      qa[kk][3] =
          *reinterpret_cast<const unsigned*>(qw + (g + 8) * L::KP + c + 16);
    }
    if constexpr (HD % 32 == 16) {  // columns hd..hd+15: not part of q
      qa[KS - 1][2] = 0u;
      qa[KS - 1][3] = 0u;
    }
  }

  const int r0 = q0 + rw * 16 + g, r1 = r0 + 8;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kv_lo + it * BK, buf = it & 1;
    if (it + 1 < ntiles) {
      issue(k0 + BK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` has landed for every thread
    const unsigned char* vbase = smem + L::V_OFF + buf * BK * L::VP;
    if constexpr (L::F32) {
      // split the float32 V tile into three bf16 parts for the mma
      for (int idx = tid; idx < BK * HD / 2; idx += THREADS) {
        const int t = idx / (HD / 2), d = (idx % (HD / 2)) * 2;
        const float2 x =
            *reinterpret_cast<const float2*>(vbase + t * L::VP + d * 4);
        unsigned w[3];
        split_bf16<3>(x.x, x.y, w);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<unsigned*>(smem + L::P_OFF + p * BK * L::BP
                                       + t * L::BP + d * 2) = w[p];
      }
      __syncthreads();
    }

    // S = Q K^T on the int8 tensor cores: exact int32
    const int8_t* kd =
        reinterpret_cast<const int8_t*>(smem + L::K_OFF) + buf * BK * L::KP;
    int sacc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int8_t* kr = kd + (j * 8 + g) * L::KP + kk * 32 + tg * 4;
        mma_s8(sacc[j], qa[kk], *reinterpret_cast<const unsigned*>(kr),
               *reinterpret_cast<const unsigned*>(kr + 16));
      }
    }

    const bool need_mask = (causal && k0 + BK - 1 > q0)
                           || (window > 0 && k0 <= q0 + BQ - 1 - window)
                           || k0 + BK > Skv;
    float s[NJ][4];
    unsigned masked = 0u;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(__int2float_rn(sacc[j][e]), scale);
        if (need_mask) {
          const int key = k0 + j * 8 + tg * 2 + (e & 1);
          const int row = e < 2 ? r0 : r1;
          bool ok = key < Skv;
          if (causal) ok = ok && key <= row;
          if (window > 0) ok = ok && key > row - window;
          if (!ok) {
            x = NEG_INF;
            masked |= 1u << (j * 4 + e);
          }
        }
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(__fmul_rn(m0 - mn0, LOG2E));
    const float c1 = exp2f(__fmul_rn(m1 - mn1, LOG2E));
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (masked >> (j * 4 + e)) & 1u
                ? 0.f
                : exp2f(__fmul_rn(s[j][e] - (e < 2 ? mn0 : mn1), LOG2E));
        s[j][e] = p;
        if (e < 2) l0 += p;
        else l1 += p;
      }
    }

    // O += P V on the bf16 tensor cores, P (and a float32 V) in bf16 parts
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned pa[NPP][4];
      {
        unsigned w0[NPP], w1[NPP], w2[NPP], w3[NPP];
        split_bf16<NPP>(s[2 * kk][0], s[2 * kk][1], w0);
        split_bf16<NPP>(s[2 * kk][2], s[2 * kk][3], w1);
        split_bf16<NPP>(s[2 * kk + 1][0], s[2 * kk + 1][1], w2);
        split_bf16<NPP>(s[2 * kk + 1][2], s[2 * kk + 1][3], w3);
#pragma unroll
        for (int i = 0; i < NPP; ++i) {
          pa[i][0] = w0[i];
          pa[i][1] = w1[i];
          pa[i][2] = w2[i];
          pa[i][3] = w3[i];
        }
      }
      const int mi = lane >> 3;
      const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int nd = 0; nd < DN / 16; ++nd) {
        const int d = cn * DN + nd * 16 + (mi >> 1) * 8;
        if constexpr (L::F32) {
#pragma unroll
          for (int pv = 0; pv < 3; ++pv) {
            unsigned vb[4];
            ldsm_x4_trans(vb, smem + L::P_OFF + pv * BK * L::BP + key * L::BP
                                  + d * 2);
#pragma unroll
            for (int i = 0; i + pv < 3; ++i) {
              mma_bf16(o[2 * nd], pa[i], vb[0], vb[1]);
              mma_bf16(o[2 * nd + 1], pa[i], vb[2], vb[3]);
            }
          }
        } else {
          unsigned vb[4];
          ldsm_x4_trans(vb, vbase + key * L::VP + d * 2);
#pragma unroll
          for (int i = 0; i < NPP; ++i) {
            mma_bf16(o[2 * nd], pa[i], vb[0], vb[1]);
            mma_bf16(o[2 * nd + 1], pa[i], vb[2], vb[3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (r0 < Sq) {
    T* orow = out + ((static_cast<size_t>(b) * Sq + r0) * H + h) * HD + cn * DN
              + tg * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(orow + n * 8, __fdiv_rn(o[n][0], d0), __fdiv_rn(o[n][1], d0));
  }
  if (r1 < Sq) {
    T* orow = out + ((static_cast<size_t>(b) * Sq + r1) * H + h) * HD + cn * DN
              + tg * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(orow + n * 8, __fdiv_rn(o[n][2], d1), __fdiv_rn(o[n][3], d1));
  }
}

// scratch: 2 * NPART float32 partial maxima (q, then k), padded to 16
// bytes, then K's int8 levels
constexpr int PART_WORDS = (2 * NPART + 3) & ~3;
size_t scratch_bytes(size_t nk) { return 4 * PART_WORDS + nk; }

int grid_for(size_t nvec, int cap) {
  const size_t blocks = (nvec + RED_THREADS - 1) / RED_THREADS;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > static_cast<size_t>(cap)
                                                ? cap : blocks));
}

template <int HD, typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 void* scratch, int B, int Sq, int Skv, int H,
                 int causal, int window, int q_bits, int k_bits,
                 float inv_sqrt_hd, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  float* part = static_cast<float*>(scratch);
  int8_t* kc = reinterpret_cast<int8_t*>(part + PART_WORDS);
  const size_t nq = static_cast<size_t>(B) * Sq * H * HD;
  const size_t nk = static_cast<size_t>(B) * Skv * H * HD;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  attn_flash_absmax_kernel<T><<<NPART, RED_THREADS, 0, st>>>(tq, tk, nq, nk,
                                                             part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_flash_klevels_kernel<T><<<grid_for(nk / VEC, 132 * 8), RED_THREADS, 0,
                                 st>>>(tk, kc, nk, part, NPART, q_bits,
                                       k_bits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kern = attn_flash_kernel<HD, T>;
  constexpr int smem = Tile<HD, T>::BYTES;
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  kern<<<dim3(B * H, (Sq + BQ - 1) / BQ), Tile<HD, T>::THREADS, smem, st>>>(
      tq, kc, static_cast<const T*>(v), static_cast<T*>(out), part, NPART, Sq,
      Skv, H, causal, window, q_bits, k_bits, inv_sqrt_hd);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              void* out, void* scratch, int B, int Sq, int Skv,
              int H, int causal, int window, int q_bits, int k_bits,
              float inv_sqrt_hd, cudaStream_t st) {
  if (dtype == 0)
    return launch_typed<HD, float>(q, k, v, out, scratch, B, Sq, Skv, H,
                                   causal, window, q_bits, k_bits, inv_sqrt_hd,
                                   st);
  if (dtype == 1)
    return launch_typed<HD, __nv_bfloat16>(q, k, v, out, scratch, B, Sq,
                                           Skv, H, causal, window, q_bits,
                                           k_bits, inv_sqrt_hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch the three kernels on `stream`; returns cudaGetLastError() (0 on
// success).  dtype: 0 float32, 1 bfloat16 (q, k, v, out).  window <= 0: no
// window.  scratch: attn_flash_scratch_bytes(k's element count) bytes.
extern "C" int attn_flash_launch(const void* q, const void* k, const void* v,
                                 void* out, void* scratch, int B,
                                 int Sq, int Skv, int H, int hd, int causal,
                                 int window, int q_bits, int k_bits,
                                 float inv_sqrt_hd, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_hd<32>(dtype, q, k, v, out, scratch, B, Sq, Skv, H,
                           causal, window, q_bits, k_bits, inv_sqrt_hd, st);
    case 64:
      return launch_hd<64>(dtype, q, k, v, out, scratch, B, Sq, Skv, H,
                           causal, window, q_bits, k_bits, inv_sqrt_hd, st);
    case 80:
      return launch_hd<80>(dtype, q, k, v, out, scratch, B, Sq, Skv, H,
                           causal, window, q_bits, k_bits, inv_sqrt_hd, st);
    case 96:
      return launch_hd<96>(dtype, q, k, v, out, scratch, B, Sq, Skv, H,
                           causal, window, q_bits, k_bits, inv_sqrt_hd, st);
    case 128:
      return launch_hd<128>(dtype, q, k, v, out, scratch, B, Sq, Skv, H,
                            causal, window, q_bits, k_bits, inv_sqrt_hd, st);
    case 256:
      return launch_hd<256>(dtype, q, k, v, out, scratch, B, Sq, Skv, H,
                            causal, window, q_bits, k_bits, inv_sqrt_hd, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of the scratch one attn_flash_launch needs for K of `k_numel`
// elements.
extern "C" long long attn_flash_scratch_bytes(long long k_numel) {
  return static_cast<long long>(scratch_bytes(static_cast<size_t>(k_numel)));
}
