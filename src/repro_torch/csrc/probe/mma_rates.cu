// Issue-rate probe of the integer mma.sync shapes the bit-plane kernels
// can use on sm_90a: m16n8k256 .b1 .and.popc (bitgemm.cu) and m16n8k32
// .u8 / .s8 (fused_qgemm.cu, conv_implicit.cu, int8_matmul.cu).  Every
// warp issues `iters` x CHAINS mma instructions into CHAINS independent
// accumulators (enough to cover the mma latency), from registers only: no
// memory traffic inside the loop.  Run by kernels/mma_rates.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 8;

template <int KIND>
__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  if (KIND == 0)
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else if (KIND == 1)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KIND>
__global__ void mma_loop(int* out, int iters) {
  const unsigned t = threadIdx.x + 1u;
  const unsigned a[4] = {t * 0x9e3779b9u, t * 0x85ebca6bu, t * 0xc2b2ae35u,
                         t * 0x27d4eb2fu};
  const unsigned b0 = t * 0x165667b1u, b1 = t * 0xd3a2646cu;
  int c[CHAINS][4];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma<KIND>(c[j], a, b0, b1);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// kind 0: b1 and.popc m16n8k256, 1: u8 m16n8k32, 2: s8 m16n8k32.  `out`
// holds blocks x threads ints.  Returns the launch's error.
extern "C" int mma_rate_launch(int kind, int blocks, int threads, int iters,
                               void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (kind == 0)
    mma_loop<0><<<blocks, threads, 0, st>>>(o, iters);
  else if (kind == 1)
    mma_loop<1><<<blocks, threads, 0, st>>>(o, iters);
  else
    mma_loop<2><<<blocks, threads, 0, st>>>(o, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mma_rate_chains() { return CHAINS; }
