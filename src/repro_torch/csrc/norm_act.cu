// The served CNN's per-sample norm and bounded activation, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's norm-act
// (src/repro/models/cnn.py, _norm_act) is jnp code that XLA fuses.  The
// port ran it as ~16 eager PyTorch ops a hidden layer (the bias add, mean,
// var, the four broadcast ops, two clamps, the quantizer's four ops), each
// a full float32 pass over the layer's output.  This kernel is that call's
// serve-mode body (kernels/norm_act.py, norm_act_plain):
//
//   t  = x + bias                                  (per channel; optional)
//   mu = mean over the sample's H x W of t         (per channel)
//   v  = mean of (t - mu)^2                        (population variance)
//   y  = clip(((t - mu) * rsqrt(v + 1e-5)) * g + beta, 0, 1)
//   q  = rint(y * n) / n                           (n = 2^bits - 1; or y)
//
// The eager ops ran on the card, where `/ n` by a Python number multiplies
// by the float32 reciprocal (PyTorch's true division by a CPU scalar), so
// q = rint(y * n) * fl(1 / n) here too; the CPU's eager ops divide.  The
// levels are the same either way, but not always the bits of q, and a 2x2
// average pool of four levels lands on a rounding tie of the next layer's
// quantizer often enough (a quarter of the windows) that the bits matter.
//
// x and out are (B, H, W, C) float32, contiguous; bias, g, beta (C,).
//
// What bounds it on an H100: bytes, 4 read and 4 written an element; the
// arithmetic is a few operations an element against ~295 a byte at the
// card's balance point.  The svhn net's seven hidden outputs at batch 1024
// are 205 M elements a forward: 1.64 GB, 0.49 ms at 3.35 TB/s.
//
// Design: a sample's slab stays on chip.
//  * Resident path.  A sample is one block, or a thread-block cluster of
//    up to 8 (the portable size) when its slab does not fit one block's
//    227 KB: the host (kernels/norm_act.py, plan_for) takes the fewest
//    blocks whose slice and reduction scratch fit.  The grid holds no
//    more clusters than fit the card at once (norm_act_fit), the samples
//    spread evenly over them, and each walks the batch (samples g, g + G,
//    ...): a block's copy of its next sample goes out as soon as its
//    stores of this one have, while the other blocks on its SM work.
//    A block copies its slice into shared memory with 16-byte cp.async,
//    neighbouring threads on neighbouring addresses, every copy in flight
//    before a thread waits and none held in a register.  Each thread
//    adds the bias to its own vectors and sums them; the per-channel sums
//    meet across the cluster through distributed shared memory; then
//    Sum (t - mu)^2 is a second pass over shared memory, not device
//    memory, and meets the same way; then each thread normalizes,
//    quantizes and stores its own vectors with 16-byte stores.  One read
//    and one write of device memory an element.
//  * Fixed channels a thread.  The threads of a block, and each slice,
//    span a multiple of lcm(VEC, C) floats, so thread t always meets
//    channels (VEC t + j) mod C: its partial sums live in VEC registers,
//    its channel constants are loaded once, and it only ever touches its
//    own vectors of the slice (no barrier guards the next copy into it).
//    The partials (VEC T floats, element i of channel i mod C) reduce to
//    C sums by a tree of halvings in shared memory.
//  * Two-pass path, where a slab outgrows a cluster of 8: one kernel gives
//    each (sample, chunk) its chunk's per-channel mean and M2 (the chunk
//    resident, as above), a second merges a sample's chunks by Chan's rule
//    and applies, reading the input again.
//  * Rounding as the eager ops round: __fadd_rn / __fmul_rn / __fdiv_rn in
//    the eager order, so nothing contracts to an FMA; rsqrtf, which
//    torch.rsqrt calls on the card; a NaN-keeping clamp (max.NaN, min.NaN)
//    as torch.clamp's; rintf, half to even as torch.round; the reciprocal
//    of n as PyTorch takes it, 1.0f / n on the host.  With the same mu and
//    v the output is the eager ops' bit for bit; only the statistics'
//    summation order differs.  The quantizer's x + (q - x) is q exactly
//    for x in [0, 1] (core/quant.py, quantize_k), so q is stored.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_optin.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;
constexpr int BATCH = 4;      // loads a thread has in flight (two-pass apply)
constexpr float EPS = 1e-5f;

struct Args {
  const float* x;
  const float* bias;   // or null
  const float* g;
  const float* beta;
  float* out;
  float2* stats;       // two-pass: (mean, M2) a (sample, chunk, channel)
  long long samples;   // B
  long long slab;      // floats a sample: H * W * C
  long long groups;    // resident: the grid's clusters (samples a stride)
  int C;
  int chunk_vec;       // vectors a slice (a multiple of lcm(VEC, C) / VEC)
  int chunks;          // slices a sample: the cluster, resident
  float n_levels;      // 2^bits - 1, or 0: clip only
  float inv_levels;    // 1.0f / n_levels
};

template <int VEC>
__device__ __forceinline__ void load_global(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_shared(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

// One VEC-float copy from device to shared memory (cp.async: no register
// holds it); copies_commit closes this thread's group of copies, and
// copies_wait waits for all of them.
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// torch.clamp(y, 0, 1): a NaN stays NaN
__device__ __forceinline__ float clip01(float y) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(y));
  asm("min.NaN.f32 %0, %0, 0f3F800000;" : "+f"(r));
  return r;
}

// one normalized, clipped, quantized element, in the eager ops' order
__device__ __forceinline__ float norm_act1(float t, float mu, float rstd,
                                           float g, float beta,
                                           const Args& a) {
  float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(t, mu), rstd), g), beta);
  y = clip01(y);
  if (a.n_levels == 0.0f) return y;
  return __fmul_rn(rintf(__fmul_rn(y, a.n_levels)), a.inv_levels);
}

__device__ __forceinline__ float rstd_of(float m2, float n) {
  return rsqrtf(__fadd_rn(__fdiv_rn(m2, n), EPS));
}

// red[0, rows * C): element i holds a partial of channel i % C.  Sums the
// rows into red[0, C) by halving, in a fixed order.
__device__ __forceinline__ void reduce_rows(float* red, int rows, int C) {
  __syncthreads();
  for (int r = rows; r > 1;) {
    const int h = (r + 1) >> 1;
    for (int i = threadIdx.x; i < (r - h) * C; i += blockDim.x)
      red[i] = __fadd_rn(red[i], red[i + h * C]);
    __syncthreads();
    r = h;
  }
}

// The VEC partials of each thread into red, reduced to C sums.
template <int VEC>
__device__ __forceinline__ void reduce_partials(float* red,
                                                const float (&acc)[VEC],
                                                int C) {
  store<VEC>(red + VEC * threadIdx.x, acc);
  reduce_rows(red, VEC * static_cast<int>(blockDim.x) / C, C);
}

// A block's slice of every sample it serves (vectors [v0, v0 + nv) of
// the slab) and the VEC channels of each thread, with their constants.
template <int VEC>
struct Slice {
  long long v0;
  int nv;
  float n_pos;        // H * W: a channel's elements in a sample
  bool has_bias;
  int ch[VEC];
  float bias[VEC], gam[VEC], bet[VEC];

  __device__ __forceinline__ Slice(const Args& a, int k) {
    const long long n_vec = a.slab / VEC;
    v0 = static_cast<long long>(k) * a.chunk_vec;
    nv = static_cast<int>(
        max(0ll, min(static_cast<long long>(a.chunk_vec), n_vec - v0)));
    n_pos = static_cast<float>(a.slab / a.C);
    has_bias = a.bias != nullptr;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      ch[j] = (VEC * static_cast<int>(threadIdx.x) + j) % a.C;
      bias[j] = has_bias ? __ldg(a.bias + ch[j]) : 0.0f;
      gam[j] = __ldg(a.g + ch[j]);
      bet[j] = __ldg(a.beta + ch[j]);
    }
  }

  // the slice's first float in sample s
  __device__ __forceinline__ long long offset(long long s,
                                              const Args& a) const {
    return s * a.slab + v0 * VEC;
  }
};

// This thread's copies of sample s's slice into buf, one group.
template <int VEC>
__device__ __forceinline__ void copy_slice(float* buf, const Args& a,
                                           const Slice<VEC>& sl,
                                           long long s) {
  const float* src = a.x + sl.offset(s, a);
  for (int i = threadIdx.x; i < sl.nv; i += blockDim.x)
    copy_async<VEC>(buf + i * VEC, src + static_cast<long long>(i) * VEC);
  copies_commit();
}

// This thread's vectors of buf, plus the bias (written back), summed.
template <int VEC>
__device__ __forceinline__ void sum_pass(float* buf, const Slice<VEC>& sl,
                                         float (&acc)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  for (int i = threadIdx.x; i < sl.nv; i += blockDim.x) {
    float v[VEC];
    load_shared<VEC>(buf + i * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (sl.has_bias) v[j] = __fadd_rn(v[j], sl.bias[j]);
      acc[j] = __fadd_rn(acc[j], v[j]);
    }
    if (sl.has_bias) store<VEC>(buf + i * VEC, v);
  }
}

// Sum (t - mu)^2 over this thread's vectors of buf.
template <int VEC>
__device__ __forceinline__ void m2_pass(const float* buf, const Slice<VEC>& sl,
                                        const float (&mu)[VEC],
                                        float (&acc)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  for (int i = threadIdx.x; i < sl.nv; i += blockDim.x) {
    float v[VEC];
    load_shared<VEC>(buf + i * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = __fsub_rn(v[j], mu[j]);
      acc[j] = __fmaf_rn(d, d, acc[j]);
    }
  }
}

// RESIDENT.  Cluster g of the grid serves samples g, g + G, ...; its block
// of rank k holds slice k of each in shared memory.
template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
norm_act_resident_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, t = threadIdx.x, C = a.C;
  float* slab = smem;
  float* red = slab + a.chunk_vec * VEC;
  float* red2 = red + VEC * T;
  float* mean_s = red2 + VEC * T;
  float* rstd_s = mean_s + C;
  cg::cluster_group cluster = cg::this_cluster();
  const Slice<VEC> sl(a, static_cast<int>(blockIdx.x % a.chunks));

  long long s = blockIdx.x / a.chunks;
  if (s < a.samples) copy_slice<VEC>(slab, a, sl, s);
  for (; s < a.samples; s += a.groups) {
    copies_wait();
    float acc[VEC];
    sum_pass<VEC>(slab, sl, acc);
    reduce_partials<VEC>(red, acc, C);
    cluster_arrive();
    cluster_wait();
    for (int c = t; c < C; c += T) {
      float sum = cluster.map_shared_rank(red, 0)[c];
      for (int r = 1; r < a.chunks; ++r)
        sum = __fadd_rn(sum, cluster.map_shared_rank(red, r)[c]);
      mean_s[c] = __fdiv_rn(sum, sl.n_pos);
    }
    __syncthreads();

    float mu[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) mu[j] = mean_s[sl.ch[j]];
    m2_pass<VEC>(slab, sl, mu, acc);
    reduce_partials<VEC>(red2, acc, C);
    cluster_arrive();
    cluster_wait();
    for (int c = t; c < C; c += T) {
      float sum = cluster.map_shared_rank(red2, 0)[c];
      for (int r = 1; r < a.chunks; ++r)
        sum = __fadd_rn(sum, cluster.map_shared_rank(red2, r)[c]);
      rstd_s[c] = rstd_of(sum, sl.n_pos);
    }
    // done reading the other blocks' partials; none writes its partials
    // again, or leaves, before every block is (the wait below)
    cluster_arrive();
    __syncthreads();

    float rs[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) rs[j] = rstd_s[sl.ch[j]];
    float* dst = a.out + sl.offset(s, a);
    for (int i = t; i < sl.nv; i += T) {
      float v[VEC];
      load_shared<VEC>(slab + i * VEC, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        v[j] = norm_act1(v[j], mu[j], rs[j], sl.gam[j], sl.bet[j], a);
      store<VEC>(dst + static_cast<long long>(i) * VEC, v);
    }
    // this thread's next copies overwrite only its own vectors
    if (s + a.groups < a.samples)
      copy_slice<VEC>(slab, a, sl, s + a.groups);
    cluster_wait();
  }
}

// STATS (two-pass, first kernel): block (sample, k) writes chunk k's
// per-channel (mean, M2) to a.stats.
template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
norm_act_stats_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, t = threadIdx.x, C = a.C;
  float* red = smem + a.chunk_vec * VEC;
  float* red2 = red + VEC * T;
  float* mean_s = red2 + VEC * T;
  const long long blk = blockIdx.x;
  const long long s = blk / a.chunks;
  const Slice<VEC> sl(a, static_cast<int>(blk - s * a.chunks));
  copy_slice<VEC>(smem, a, sl, s);
  copies_wait();
  float acc[VEC];
  sum_pass<VEC>(smem, sl, acc);
  reduce_partials<VEC>(red, acc, C);
  const float n_chunk = static_cast<float>(sl.nv * VEC / C);
  for (int c = t; c < C; c += T) mean_s[c] = __fdiv_rn(red[c], n_chunk);
  __syncthreads();
  float mu[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) mu[j] = mean_s[sl.ch[j]];
  m2_pass<VEC>(smem, sl, mu, acc);
  reduce_partials<VEC>(red2, acc, C);
  float2* out = a.stats + blk * C;
  for (int c = t; c < C; c += T) out[c] = make_float2(mean_s[c], red2[c]);
}

// APPLY (two-pass, second kernel): block (sample, k) merges the sample's
// chunk statistics (Chan's rule, in chunk order), then normalizes chunk k
// from device memory.
template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
norm_act_apply_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, t = threadIdx.x, C = a.C;
  float* mean_s = smem;
  float* rstd_s = smem + C;
  const long long blk = blockIdx.x;
  const long long s = blk / a.chunks;
  const Slice<VEC> sl(a, static_cast<int>(blk - s * a.chunks));
  const long long n_vec = a.slab / VEC;
  const float2* st = a.stats + s * a.chunks * C;
  for (int c = t; c < C; c += T) {
    float n = 0.0f, mean = 0.0f, m2 = 0.0f;
    for (int q = 0; q < a.chunks; ++q) {
      const long long rest = n_vec - static_cast<long long>(q) * a.chunk_vec;
      const float nb = static_cast<float>(
          min(static_cast<long long>(a.chunk_vec), rest) * VEC / C);
      const float2 p = st[static_cast<long long>(q) * C + c];
      if (q == 0) {
        n = nb, mean = p.x, m2 = p.y;
        continue;
      }
      const float nn = __fadd_rn(n, nb);
      const float d = __fsub_rn(p.x, mean);
      mean = __fadd_rn(mean, __fmul_rn(d, __fdiv_rn(nb, nn)));
      m2 = __fadd_rn(__fadd_rn(m2, p.y),
                     __fmul_rn(__fmul_rn(d, d),
                               __fdiv_rn(__fmul_rn(n, nb), nn)));
      n = nn;
    }
    mean_s[c] = mean;
    rstd_s[c] = rstd_of(m2, sl.n_pos);
  }
  __syncthreads();
  float mu[VEC], rs[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    mu[j] = mean_s[sl.ch[j]], rs[j] = rstd_s[sl.ch[j]];
  const float* src = a.x + sl.offset(s, a);
  float* dst = a.out + sl.offset(s, a);
  for (int i0 = t; i0 < sl.nv; i0 += BATCH * T) {
    float v[BATCH][VEC];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * T;
      if (i < sl.nv)
        load_global<VEC>(src + static_cast<long long>(i) * VEC, v[u]);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * T;
      if (i < sl.nv) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float x =
              sl.has_bias ? __fadd_rn(v[u][j], sl.bias[j]) : v[u][j];
          v[u][j] = norm_act1(x, mu[j], rs[j], sl.gam[j], sl.bet[j], a);
        }
        store<VEC>(dst + static_cast<long long>(i) * VEC, v[u]);
      }
    }
  }
}

// One launch of `kern` (a cluster of `cluster` blocks where > 1), its
// dynamic shared memory opted in on this device first.
template <typename K>
cudaError_t launch(K kern, int (&optin)[smem_optin::MAX_DEVICES],
                   long long blocks, int threads, int cluster, int smem,
                   const Args& a, cudaStream_t st) {
  cudaError_t e = smem_optin::ensure(kern, smem, optin);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

// Each kernel's shared-memory opt-in, a device at a time.
template <int VEC>
struct Optin {
  static int resident[smem_optin::MAX_DEVICES];
  static int stats[smem_optin::MAX_DEVICES];
  static int apply[smem_optin::MAX_DEVICES];
};
template <int VEC>
int Optin<VEC>::resident[smem_optin::MAX_DEVICES] = {};
template <int VEC>
int Optin<VEC>::stats[smem_optin::MAX_DEVICES] = {};
template <int VEC>
int Optin<VEC>::apply[smem_optin::MAX_DEVICES] = {};

// The resident launch's clusters that fit the current device at once.
template <int VEC>
cudaError_t resident_fit(int threads, int cluster, int smem, int* fit) {
  auto kern = norm_act_resident_kernel<VEC>;
  cudaError_t e = smem_optin::ensure(kern, smem, Optin<VEC>::resident);
  if (e != cudaSuccess) return e;
  if (cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(fit, kern, &cfg);
  }
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  *fit = sms * per_sm;
  return e;
}

template <int VEC>
cudaError_t launch_path(const Args& a, int threads, int two_pass, int smem,
                        cudaStream_t st) {
  if (!two_pass)
    return launch(norm_act_resident_kernel<VEC>, Optin<VEC>::resident,
                  a.groups * a.chunks, threads, a.chunks, smem, a, st);
  const long long blocks = a.samples * a.chunks;
  const int apply_smem = static_cast<int>(sizeof(float)) * 2 * a.C;
  cudaError_t e = launch(norm_act_stats_kernel<VEC>, Optin<VEC>::stats,
                         blocks, threads, 1, smem, a, st);
  if (e == cudaSuccess)
    e = launch(norm_act_apply_kernel<VEC>, Optin<VEC>::apply, blocks,
               threads, 1, apply_smem, a, st);
  return e;
}

}  // namespace

// The resident path's clusters (of `chunks` blocks of `threads`, `smem`
// bytes of dynamic shared memory each) that fit the current device at once,
// into *fit.  Returns the error of the query (0 on success).
extern "C" int norm_act_fit(int vec, int threads, int chunks, int smem,
                            int* fit) {
  if ((vec != 4 && vec != 1) || threads < 1 || threads > MAX_THREADS ||
      chunks < 1 || chunks > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  *fit = 0;
  const cudaError_t e = vec == 4 ? resident_fit<4>(threads, chunks, smem, fit)
                                 : resident_fit<1>(threads, chunks, smem, fit);
  return static_cast<int>(e);
}

// Launch on `stream` with the host's plan (kernels/norm_act.py, plan_for):
// vec (4 or 1) floats a copy, threads a block, chunks slices a sample of
// chunk_vec vectors each (a cluster on the resident path), the blocks'
// dynamic shared memory; on the resident path `groups` clusters, each
// serving every groups-th sample (at most what norm_act_fit reports).
// `stats` holds batch * chunks * C float2 on the two-pass path.  Returns
// the first error of a launch or cudaGetLastError() (0 on success);
// refuses a plan whose threads or slices do not span whole multiples of
// lcm(vec, C) floats, or whose shared memory is not the sum the kernel
// lays out.
extern "C" int norm_act_launch(const void* x, const void* bias,
                               const void* g, const void* beta, void* out,
                               void* stats, long long batch, long long slab,
                               long long groups, int C, int vec, int threads,
                               int chunks, int chunk_vec, int two_pass,
                               int smem, float n_levels, void* stream) {
  const long long span = static_cast<long long>(vec) * chunk_vec;
  const long long want = 4ll * (span + 2ll * vec * threads + 2ll * C);
  if ((vec != 4 && vec != 1) || C < 1 || batch < 1 || slab % C != 0 ||
      slab % vec != 0 || threads < 1 || threads > MAX_THREADS ||
      (vec * threads) % C != 0 || chunk_vec < 1 || span % C != 0 ||
      chunks < 1 || (!two_pass && chunks > MAX_CLUSTER) ||
      static_cast<long long>(chunks) * chunk_vec < slab / vec ||
      static_cast<long long>(chunks - 1) * chunk_vec >= slab / vec ||
      smem != want || (two_pass && stats == nullptr) ||
      (!two_pass && (groups < 1 || groups > batch)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.bias = static_cast<const float*>(bias);
  a.g = static_cast<const float*>(g);
  a.beta = static_cast<const float*>(beta);
  a.out = static_cast<float*>(out);
  a.stats = static_cast<float2*>(stats);
  a.samples = batch;
  a.slab = slab;
  a.groups = groups;
  a.C = C;
  a.chunk_vec = chunk_vec;
  a.chunks = chunks;
  a.n_levels = n_levels;
  a.inv_levels = n_levels != 0.0f ? 1.0f / n_levels : 0.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = vec == 4 ? launch_path<4>(a, threads, two_pass, smem, st)
                           : launch_path<1>(a, threads, two_pass, smem, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
