// K16: the HyperLogLog registers of a masked column.
//
// Replaces oceanbase_tpu/ops/hll.py:37 _two_hashes and :55 hll_registers
// (the estimate, :79 hll_estimate, stays torch code on the 16384
// registers): per live row, f = fold32 of the value (a float is first
// widened to float64 and its bits taken as int64, so 0.1 and 0.2 do not
// fold alike), h1 = mix32(f + GOLDEN32), h2 = mix32(h1 ^ f ^ 0x85EBCA6B),
// bucket = h1 & 16383, rank = clz(h2) + 1 (33 for h2 = 0, which equals
// the reference's 32 - floor(log2(h2))); register j = the largest rank of
// the rows in bucket j, 0 where there is none.
//
// Bound on an H100 (3.35 TB/s): it reads each value and mask once and
// writes 64 KB; the hashing is a few dozen integer operations a row, far
// below the integer rate: bytes bound.
//
// Design: every block keeps the 16384 registers in 64 KB of shared
// memory, folds its rows into them with shared atomicMax, and merges its
// nonzero registers into the output with global atomicMax. A max does
// not depend on the order, so the registers equal the reference's bit
// for bit on every run.
#include "ob_common.cuh"

#define K16_THREADS 512
#define K16_M 16384
#define K16_SMEM (K16_M * 4)

__device__ __forceinline__ unsigned int k16_fold(const void* p, int dt,
                                                 long long i) {
  if (ob_is_float(dt)) {
    double d = ob_ldg_f64(p, dt, i);
    return ob_fold64((unsigned long long)__double_as_longlong(d));
  }
  return ob_fold32(p, dt, i);
}

__global__ void __launch_bounds__(K16_THREADS)
k16_registers(const void* __restrict__ col, int dt,
              const unsigned char* __restrict__ mask, long long n,
              int* __restrict__ regs) {
  extern __shared__ int sreg[];
  for (int j = threadIdx.x; j < K16_M; j += blockDim.x) sreg[j] = 0;
  __syncthreads();
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    if (!__ldg(mask + i)) continue;
    unsigned int f = k16_fold(col, dt, i);
    unsigned int h1 = ob_mix32(f + OB_GOLDEN32);
    unsigned int h2 = ob_mix32(h1 ^ f ^ OB_MIX32_M1);
    int rank = __clz((int)h2) + 1;
    atomicMax(sreg + (h1 & (K16_M - 1)), rank);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < K16_M; j += blockDim.x) {
    int r = sreg[j];
    if (r > 0) atomicMax(regs + j, r);
  }
}

// col/dt: n values; mask: bool [n]; regs: int32 [16384] (zeroed here).
extern "C" int ob_k16_registers(const void* col, int dt, const void* mask,
                                long long n, void* regs, int nblocks,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(regs, 0, K16_M * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaGetLastError();
  e = cudaFuncSetAttribute(k16_registers,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           K16_SMEM);
  if (e != cudaSuccess) return (int)e;
  k16_registers<<<nblocks, K16_THREADS, K16_SMEM, s>>>(
      col, dt, (const unsigned char*)mask, n, (int*)regs);
  return (int)cudaGetLastError();
}
