// K21: the nprobe IVF lists nearest to a query, in lax.top_k's order.
//
// Replaces oceanbase_tpu/engine/executor.py:1572-1573 (_emit_vector_topn's
// round 1):  cdist = |c|^2 - 2 c.q ;  lax.top_k(-cdist, nprobe)
// -- nearest first, the lower list index on ties. torch.topk promises no
// tie order, so it cannot stand in.
//
// Bound on an H100: the (L, d) centroids read once, 0.5 MB at 1024 x 128:
// under a microsecond, so the two launches bound it.
//
// Design: a warp per centroid computes its distance (lane-strided float32
// dot product and norm, reduced by shuffles) and a 64-bit key, the
// distance's order-preserving image above the list index: keys are
// unique and their order is (distance, index). A second pass ranks every
// key by counting the smaller keys, 256 keys of shared memory at a time;
// a key of rank r < nprobe writes its index to slot r. The count is
// O(L^2) but right for any L (L = 8192 is 67M comparisons).
#include "ob_common.cuh"

#define K21_THREADS 256

__global__ void k21_keys(const float* __restrict__ cent,
                         const float* __restrict__ q, int nl, int d,
                         unsigned long long* __restrict__ keys) {
  int warp = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  int lane = threadIdx.x & 31;
  if (warp >= nl) return;  // uniform over the warp
  const float* row = cent + (long long)warp * d;
  float dot = 0.0f, nrm = 0.0f;
  for (int k = lane; k < d; k += 32) {
    float v = row[k];
    dot = fmaf(v, __ldg(q + k), dot);
    nrm = fmaf(v, v, nrm);
  }
  for (int o = 16; o > 0; o >>= 1) {
    dot += __shfl_xor_sync(OB_FULL_MASK, dot, o);
    nrm += __shfl_xor_sync(OB_FULL_MASK, nrm, o);
  }
  if (lane == 0) {
    float cd = fmaf(-2.0f, dot, nrm);
    keys[warp] = ((unsigned long long)ob_f32_image(cd) << 32) |
                 (unsigned long long)(unsigned)warp;
  }
}

__global__ void k21_rank(const unsigned long long* __restrict__ keys, int nl,
                         int nprobe, int* __restrict__ out) {
  __shared__ unsigned long long tile[K21_THREADS];
  int me = blockIdx.x * K21_THREADS + threadIdx.x;
  unsigned long long mine = me < nl ? keys[me] : 0ULL;
  int rank = 0;
  for (int base = 0; base < nl; base += K21_THREADS) {
    __syncthreads();
    int j = base + threadIdx.x;
    if (j < nl) tile[threadIdx.x] = keys[j];
    __syncthreads();
    int m = nl - base < K21_THREADS ? nl - base : K21_THREADS;
    for (int t = 0; t < m; t++) rank += tile[t] < mine;
  }
  if (me < nl && rank < nprobe) out[rank] = (int)(mine & 0xffffffffULL);
}

// cent: (nl, d) float32 row-major, q: float32 [d]; keys: int64 [nl]
// scratch; out: int32 [nprobe], 1 <= nprobe <= nl.
extern "C" int ob_k21_lists(const void* cent, const void* q, int nl, int d,
                            int nprobe, void* keys, void* out, void* stream) {
  if (nl < 1 || d < 1 || nprobe < 1 || nprobe > nl)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int nb = (int)(((long long)nl * 32 + K21_THREADS - 1) / K21_THREADS);
  k21_keys<<<nb, K21_THREADS, 0, s>>>((const float*)cent, (const float*)q,
                                      nl, d, (unsigned long long*)keys);
  int rb = (nl + K21_THREADS - 1) / K21_THREADS;
  k21_rank<<<rb, K21_THREADS, 0, s>>>((const unsigned long long*)keys, nl,
                                      nprobe, (int*)out);
  return (int)cudaGetLastError();
}
