// K30: the matched product sum of a unique-build hash join.
//
// Replaces oceanbase_tpu/ops/spill.py:244-256 _device_join_sum, the
// part after its hash-table probe (K14): over the probe rows,
// sum(lv[i] * rv[match[i]]) where match[i] >= 0, and the count of such
// rows, both int64 with the reference's wrapping arithmetic (XLA's int64
// multiply and add wrap modulo 2^64; here they are unsigned 64-bit
// operations, whose overflow is defined and gives the same bits).
//
// Bound on an H100 (3.35 TB/s): lv and match read once (12 bytes a probe
// row for int64 values) plus one rv element per matched row -- memory
// bound; the rv reads are random and cost a 32-byte sector each.
//
// Design: one grid-stride pass, each thread accumulating its rows in
// registers, a warp-shuffle and shared-memory block reduction, then one
// 64-bit atomicAdd per block and value into the two output words, which
// the entry zeroes first on the same stream.
#include "ob_common.cuh"

#define K30_THREADS 256

__global__ void k30_product_sum(const void* __restrict__ lv, int ldt,
                                const void* __restrict__ rv, int rdt,
                                const int* __restrict__ match, long long n,
                                unsigned long long* __restrict__ out) {
  __shared__ unsigned long long s_sum[K30_THREADS / 32];
  __shared__ unsigned long long s_cnt[K30_THREADS / 32];
  unsigned long long sum = 0ull, cnt = 0ull;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    int m = __ldg(match + i);
    if (m < 0) continue;
    unsigned long long a = (unsigned long long)ob_ldg_i64(lv, ldt, i);
    unsigned long long b = (unsigned long long)ob_ldg_i64(rv, rdt, m);
    sum += a * b;
    cnt += 1ull;
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(OB_FULL_MASK, sum, o);
    cnt += __shfl_xor_sync(OB_FULL_MASK, cnt, o);
  }
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sum[warp] = sum;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long bs = 0ull, bc = 0ull;
    for (int w = 0; w < K30_THREADS / 32; w++) {
      bs += s_sum[w];
      bc += s_cnt[w];
    }
    if (bc != 0ull) {
      atomicAdd(out, bs);
      atomicAdd(out + 1, bc);
    }
  }
}

// lv: [n] probe values (type code ldt); rv: build values (type rdt);
// match: int32 [n], the build row of each probe row or -1; out: int64 [2]
// <- (sum of the matched products, matched rows).
extern "C" int ob_k30_product_sum(const void* lv, int ldt, const void* rv,
                                  int rdt, const void* match, long long n,
                                  void* out, int nblocks, void* stream) {
  if (n < 0 || ob_is_float(ldt) || ob_is_float(rdt)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, 2 * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    k30_product_sum<<<nblocks, K30_THREADS, 0, s>>>(
        lv, ldt, rv, rdt, (const int*)match, n, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}
