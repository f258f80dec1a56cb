// Fused DoReFa quantize + bit-plane pack, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quantpack.py, quantize_pack_pallas (_kernel).
//
//   levels[m, k]        = clip(rintf(clip(a[m,k], 0, 1) * (2^bits - 1)), 0, 2^bits - 1)
//   planes[b, m, k/32]  bit (k % 32) = bit b of levels[m, k]
//
// a is (M, K) float32 and levels (M, K) unsigned 8-bit; or, in the
// levels-in form, a is already (M, K) unsigned 8-bit levels and only the
// planes are written (the faithful engine packs its activation levels
// this way).  planes is (bits, M, ceil(K/32)) 32-bit words, LSB first
// along K, the layout of the reference's pack_bits; the tail of the last
// word of a row is zero.
//
// What bounds it on an H100: bytes.  It reads every input element once
// and writes 1 byte of level plus bits/8 bytes of planes per element;
// there is no arithmetic to speak of.  At svhn conv2's patches at batch 8
// (M=12800, K=576) the float-in form reads 29.5 MB and writes 7.4 MB of
// levels, about 11 us at 3.35 TB/s; the levels-in form reads the 7.4 MB.
// To approach that, a SM needs tens of KB of loads in flight, and every
// load and store wide and coalesced.
//
// Design.  Two kernels, one launch a call either way, no memset (every
// word of every plane is written):
//  * The tile kernel, for the main path's layout (K % 32 == 0: word w is
//    elements 32w .. 32w+31 of the flattened input; 16-byte aligned
//    bases).  A block of TILE_THREADS stages TILE_THREADS * EPT elements
//    (a uint4 of 16 levels, or two float4, a thread) with lane-contiguous
//    16-byte loads, all issued before any is used: a warp reads 512
//    contiguous bytes an instruction, and at 2048 threads a SM keeps 32 to
//    64 KB of loads in flight.  The float-in form quantizes each float4 as
//    it lands and stores its 4 levels (128 contiguous bytes a warp).  The
//    levels sit in shared memory; each thread then packs one (plane,
//    word) from there, so every thread of the block packs.
//  * The word kernel, for any other layout (K % 32 != 0, or a base off 16
//    bytes): a thread owns one packed word, the n <= 32 elements of a row
//    it covers, loaded at the widest of 16, 8, 4 or 1 byte(s) (levels) or
//    16, 8 or 4 (floats) that divides the row length in bytes and the
//    base, a template parameter; the levels' store width likewise, at run
//    time.  So any contiguous input is taken, at any offset into its
//    storage.  Elements past K read as zero and are not stored: the last
//    word's tail bits are zero.
//  * Packing in registers, no ballot: 8 levels sit in one 64-bit register
//    (byte i = element i), and bit b of the 8 bytes gathers LSB first as
//    (((x >> b) & 0x0101010101010101) * 0x0102040810204080) >> 56 (the
//    product puts bit 8i of its left factor at bit 56 + i, and no two
//    partial products overlap, so nothing carries).  Four such bytes are
//    plane b's word.
//  * Stores: thread w owns word w of the M * Kw words of every plane (row
//    after row), so a warp's store of one plane is 128 contiguous bytes
//    whatever Kw is.
//
// Rounding: rintf rounds half to even, as jnp.round and torch.round do;
// __fmul_rn keeps the product from fusing into anything.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORD = 32;   // elements of a packed word
// the tile kernel (the main path's layout): threads a block, and elements
// a thread of each form.  Below SMALL_WORDS words (AlexNet fc5/fc6, svhn
// conv6 at batch 8) the float-in form is bound by latency, not bytes, and
// takes one float4 a thread, for twice the blocks: two were up to 3%
// slower there (NVIDIA H100 80GB HBM3, 700 W).
constexpr int TILE_THREADS = 128;
constexpr int FLOAT_EPT = 8;
constexpr int FLOAT_EPT_SMALL = 4;
constexpr long long SMALL_WORDS = 16384;
constexpr int LEVELS_EPT = 16;
// the word kernel (any layout): threads a block, resident blocks a SM
constexpr int THREADS = 64;
constexpr int MIN_BLOCKS = 16;

// bit b of each of the 8 bytes of x, LSB first: byte i -> bit i
__device__ __forceinline__ uint32_t gather_bit(uint64_t x, int b) {
  return static_cast<uint32_t>(
      (((x >> b) & 0x0101010101010101ull) * 0x0102040810204080ull) >> 56);
}

// The n (<= 32, a multiple of W) levels at p into lv, 4 a 32-bit word,
// little-endian; the rest zero.  p is W-byte aligned.
template <int W>
__device__ __forceinline__ void load_levels(const uint8_t* __restrict__ p,
                                            int n, uint32_t (&lv)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) lv[i] = 0u;
#pragma unroll
  for (int i = 0; i < WORD; i += W) {
    if (i < n) {
      if constexpr (W == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + i));
        lv[i / 4] = v.x, lv[i / 4 + 1] = v.y, lv[i / 4 + 2] = v.z,
        lv[i / 4 + 3] = v.w;
      } else if constexpr (W == 8) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + i));
        lv[i / 4] = v.x, lv[i / 4 + 1] = v.y;
      } else if constexpr (W == 4) {
        lv[i / 4] = __ldg(reinterpret_cast<const uint32_t*>(p + i));
      } else {
        lv[i / 4] |= static_cast<uint32_t>(__ldg(p + i)) << (8 * (i % 4));
      }
    }
  }
}

// The n (<= 32, a multiple of W / 4) floats at p into f; the rest zero
// (level 0).  p is W-byte aligned.
template <int W>
__device__ __forceinline__ void load_floats(const float* __restrict__ p,
                                            int n, float (&f)[WORD]) {
  constexpr int F = W / 4;
#pragma unroll
  for (int i = 0; i < WORD; i += F) {
    if constexpr (F == 4) {
      const float4 v = i < n ? __ldg(reinterpret_cast<const float4*>(p + i))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      f[i] = v.x, f[i + 1] = v.y, f[i + 2] = v.z, f[i + 3] = v.w;
    } else if constexpr (F == 2) {
      const float2 v = i < n ? __ldg(reinterpret_cast<const float2*>(p + i))
                             : make_float2(0.f, 0.f);
      f[i] = v.x, f[i + 1] = v.y;
    } else {
      f[i] = i < n ? __ldg(p + i) : 0.f;
    }
  }
}

// The first n (<= 32, a multiple of W) levels of lv to p, W-byte aligned.
template <int W>
__device__ __forceinline__ void store_levels(uint8_t* __restrict__ p, int n,
                                             const uint32_t (&lv)[8]) {
#pragma unroll
  for (int i = 0; i < WORD; i += W) {
    if (i < n) {
      if constexpr (W == 16) {
        *reinterpret_cast<uint4*>(p + i) =
            make_uint4(lv[i / 4], lv[i / 4 + 1], lv[i / 4 + 2], lv[i / 4 + 3]);
      } else if constexpr (W == 8) {
        *reinterpret_cast<uint2*>(p + i) = make_uint2(lv[i / 4], lv[i / 4 + 1]);
      } else if constexpr (W == 4) {
        *reinterpret_cast<uint32_t*>(p + i) = lv[i / 4];
      } else {
        p[i] = static_cast<uint8_t>(lv[i / 4] >> (8 * (i % 4)));
      }
    }
  }
}

// The level of one float: clip, scale (unfused), round half to even, clip.
__device__ __forceinline__ uint32_t level(float v, float n_levels) {
  const float x = fminf(fmaxf(v, 0.0f), 1.0f);
  const float r = fminf(fmaxf(rintf(__fmul_rn(x, n_levels)), 0.0f), n_levels);
  return __float2uint_rn(r);
}

// The levels of 4 consecutive floats, byte i = element i.
__device__ __forceinline__ uint32_t quantize4(float4 v, float n_levels) {
  return level(v.x, n_levels) | level(v.y, n_levels) << 8 |
         level(v.z, n_levels) << 16 | level(v.w, n_levels) << 24;
}

// The `bits` plane words of one packed word's 32 levels (4 a 32-bit lv,
// little-endian) to out[b * stride].
__device__ __forceinline__ void store_planes(const uint32_t (&lv)[8],
                                             uint32_t* __restrict__ out,
                                             long long stride, int bits) {
  const uint64_t x0 = lv[0] | (uint64_t)lv[1] << 32;
  const uint64_t x1 = lv[2] | (uint64_t)lv[3] << 32;
  const uint64_t x2 = lv[4] | (uint64_t)lv[5] << 32;
  const uint64_t x3 = lv[6] | (uint64_t)lv[7] << 32;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b >= bits) break;
    out[b * stride] = gather_bit(x0, b) | gather_bit(x1, b) << 8 |
                      gather_bit(x2, b) << 16 | gather_bit(x3, b) << 24;
  }
}

// The main path's layout (K % 32 == 0, 16-byte aligned bases): a block
// stages TW words, quantized as they land, and packs them from shared
// memory (the note at the top).
template <bool LEVELS_IN, int EPT>
__global__ void __launch_bounds__(TILE_THREADS)
quantize_pack_tile_kernel(const void* __restrict__ a_ptr,
                          uint8_t* __restrict__ levels,
                          uint32_t* __restrict__ planes, long long words,
                          int bits, float n_levels) {
  constexpr int TW = TILE_THREADS * EPT / WORD;   // words a block
  constexpr int CHUNK = LEVELS_IN ? 16 : 4;       // elements in 16 bytes
  constexpr int R = EPT / CHUNK;                  // chunks a thread
  __shared__ __align__(16) uint32_t tile[TW * WORD / 4];
  const long long w0 = (long long)blockIdx.x * TW;
  const int tw = static_cast<int>(min((long long)TW, words - w0));
  const int chunks = tw * (WORD / CHUNK);
  const int tid = threadIdx.x;
  if constexpr (LEVELS_IN) {
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(a_ptr) + w0 * WORD);
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = r * TILE_THREADS + tid;
      if (c < chunks) v[r] = __ldg(src + c);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = r * TILE_THREADS + tid;
      if (c < chunks) reinterpret_cast<uint4*>(tile)[c] = v[r];
    }
  } else {
    const float4* src = reinterpret_cast<const float4*>(
        static_cast<const float*>(a_ptr) + w0 * WORD);
    uint32_t* lv_out = reinterpret_cast<uint32_t*>(levels + w0 * WORD);
    float4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = r * TILE_THREADS + tid;
      if (c < chunks) v[r] = __ldg(src + c);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = r * TILE_THREADS + tid;
      if (c < chunks) {
        const uint32_t q = quantize4(v[r], n_levels);
        tile[c] = q;
        lv_out[c] = q;
      }
    }
  }
  __syncthreads();
  // one (plane, word) a thread: all the block's threads pack, and a warp
  // stores consecutive words of one plane
  for (int i = tid; i < TW * bits; i += TILE_THREADS) {
    const int t = i % TW, b = i / TW;
    if (t >= tw) continue;
    const uint4 lo = reinterpret_cast<const uint4*>(tile)[2 * t];
    const uint4 hi = reinterpret_cast<const uint4*>(tile)[2 * t + 1];
    planes[b * words + w0 + t] =
        gather_bit(lo.x | (uint64_t)lo.y << 32, b) |
        gather_bit(lo.z | (uint64_t)lo.w << 32, b) << 8 |
        gather_bit(hi.x | (uint64_t)hi.y << 32, b) << 16 |
        gather_bit(hi.z | (uint64_t)hi.w << 32, b) << 24;
  }
}

// Any other layout: a thread per packed word, loading its n <= 32
// elements at IN_W bytes a load.  IN_W: the input's load width in bytes.
// LEVELS_IN: a holds uint8 levels (planes only); else float32 (levels
// stored lv_w bytes at a time, too).
template <bool LEVELS_IN, int IN_W>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
quantize_pack_kernel(const void* __restrict__ a_ptr,
                     uint8_t* __restrict__ levels,
                     uint32_t* __restrict__ planes, int M, int K, int Kw,
                     int bits, float n_levels, int lv_w) {
  const long long words = (long long)M * Kw;
  const long long w = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (w >= words) return;
  long long m;
  int kw;
  if (words <= 0xffffffffll) {   // 32-bit division where it fits
    const unsigned wu = static_cast<unsigned>(w);
    m = wu / static_cast<unsigned>(Kw);
    kw = static_cast<int>(wu - static_cast<unsigned>(m) * Kw);
  } else {
    m = w / Kw;
    kw = static_cast<int>(w - m * Kw);
  }
  const int k0 = kw * WORD;
  const int n = min(WORD, K - k0);
  const size_t base = (size_t)m * K + k0;

  uint32_t lv[8];
  if constexpr (LEVELS_IN) {
    load_levels<IN_W>(static_cast<const uint8_t*>(a_ptr) + base, n, lv);
  } else {
    float f[WORD];
    load_floats<IN_W>(static_cast<const float*>(a_ptr) + base, n, f);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      lv[i] = quantize4(make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2],
                                    f[4 * i + 3]), n_levels);
    uint8_t* out = levels + base;
    switch (lv_w) {
      case 16: store_levels<16>(out, n, lv); break;
      case 8: store_levels<8>(out, n, lv); break;
      case 4: store_levels<4>(out, n, lv); break;
      default: store_levels<1>(out, n, lv); break;
    }
  }
  store_planes(lv, planes + w, words, bits);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest of 16, 8 and 4 bytes that divides both the row length in
// bytes and the base address, else `least`.
int width(long long row_bytes, const void* p, int least) {
  const int widths[3] = {16, 8, 4};
  for (int w : widths)
    if (w > least && row_bytes % w == 0 && aligned(p, w)) return w;
  return least;
}

template <bool LEVELS_IN, int IN_W>
void launch(cudaStream_t st, const void* a, uint8_t* levels,
            uint32_t* planes, int M, int K, int Kw, int bits, float n_levels,
            int lv_w) {
  const long long words = (long long)M * Kw;
  const unsigned blocks =
      static_cast<unsigned>((words + THREADS - 1) / THREADS);
  quantize_pack_kernel<LEVELS_IN, IN_W><<<blocks, THREADS, 0, st>>>(
      a, levels, planes, M, K, Kw, bits, n_levels, lv_w);
}

template <bool LEVELS_IN, int EPT>
void launch_tile(cudaStream_t st, const void* a, uint8_t* levels,
                 uint32_t* planes, long long words, int bits,
                 float n_levels) {
  constexpr int TW = TILE_THREADS * EPT / WORD;
  const unsigned blocks = static_cast<unsigned>((words + TW - 1) / TW);
  quantize_pack_tile_kernel<LEVELS_IN, EPT><<<blocks, TILE_THREADS, 0, st>>>(
      a, levels, planes, words, bits, n_levels);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `levels` is written only when a_is_levels is 0.  M * ceil(K/32) must be
// > 0 (the wrapper returns empty outputs without a launch).
extern "C" int quantize_pack_launch(const void* a, void* levels,
                                    void* planes, int M, int K,
                                    int a_is_levels, int bits,
                                    void* stream) {
  const int Kw = (K + WORD - 1) / WORD;
  const long long words = (long long)M * Kw;
  const float n_levels = static_cast<float>((1 << bits) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* lv = static_cast<uint8_t*>(levels);
  uint32_t* pl = static_cast<uint32_t*>(planes);
  const bool tile = K % WORD == 0 && aligned(a, 16) &&
                    (a_is_levels || aligned(levels, 16));
  if (tile && a_is_levels) {
    launch_tile<true, LEVELS_EPT>(st, a, lv, pl, words, bits, n_levels);
  } else if (tile && words < SMALL_WORDS) {
    launch_tile<false, FLOAT_EPT_SMALL>(st, a, lv, pl, words, bits, n_levels);
  } else if (tile) {
    launch_tile<false, FLOAT_EPT>(st, a, lv, pl, words, bits, n_levels);
  } else if (a_is_levels) {
    switch (width(K, a, 1)) {
      case 16: launch<true, 16>(st, a, lv, pl, M, K, Kw, bits, n_levels, 0); break;
      case 8: launch<true, 8>(st, a, lv, pl, M, K, Kw, bits, n_levels, 0); break;
      case 4: launch<true, 4>(st, a, lv, pl, M, K, Kw, bits, n_levels, 0); break;
      default: launch<true, 1>(st, a, lv, pl, M, K, Kw, bits, n_levels, 0); break;
    }
  } else {
    const int lv_w = width(K, levels, 1);
    switch (width(4ll * K, a, 4)) {
      case 16: launch<false, 16>(st, a, lv, pl, M, K, Kw, bits, n_levels, lv_w); break;
      case 8: launch<false, 8>(st, a, lv, pl, M, K, Kw, bits, n_levels, lv_w); break;
      default: launch<false, 4>(st, a, lv, pl, M, K, Kw, bits, n_levels, lv_w); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
