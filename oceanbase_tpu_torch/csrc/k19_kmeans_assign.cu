// K19: the nearest centroid of every row (the k-means assignment), fused.
//
// Replaces oceanbase_tpu/storage/vector_index.py:57 _kmeans_assign:
//   a[i] = argmin_l ( -2 x_i . c_l + |c_l|^2 ),  the lowest l on ties and
// the first NaN first (jnp.argmin). The reference writes the (n, L)
// distance matrix (4 GB at 1M rows x 1024 lists); here it never leaves
// registers.
//
// Bound on an H100: 2 n L d flops at the float32 SIMT rate, 67 TFLOP/s
// (the data stay float32, so no tensor cores: TF32 would change which
// centroid is nearest): 3.9 ms at 1M x 1024 x 128. The bytes (x once, the
// centroids, the int64 result) take 0.15 ms, so it is operation bound.
//
// Design: a block owns 64 rows and walks every tile of 64 centroids. Per
// tile, 32-dimension slices of the rows and the centroids pass through
// shared memory and each of 256 threads accumulates a 4 x 4 register
// block of dot products in float32. After a tile, each thread takes the
// best of its four centroids per row, the 16 threads of a row group reduce
// (distance, index) by shuffles, lower index winning ties, and the
// running best per row stays in registers across tiles. |c|^2 is one
// small pass before (a warp per centroid).
#include "ob_common.cuh"

#define K19_BM 64
#define K19_BN 64
#define K19_BK 32
#define K19_THREADS 256

__global__ void k19_norms(const float* __restrict__ c, int nl, int d,
                          float* __restrict__ cn) {
  int warp = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  int lane = threadIdx.x & 31;
  if (warp >= nl) return;  // uniform over the warp
  const float* row = c + (long long)warp * d;
  float s = 0.0f;
  for (int k = lane; k < d; k += 32) {
    float v = row[k];
    s = fmaf(v, v, s);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(OB_FULL_MASK, s, o);
  if (lane == 0) cn[warp] = s;
}

// (v, i) beats (bv, bi) under argmin's order: NaN first, then the smaller
// value, then the lower index.
__device__ __forceinline__ bool k19_better(float v, int i, float bv, int bi) {
  bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(K19_THREADS)
k19_assign(const float* __restrict__ x, const float* __restrict__ c,
           const float* __restrict__ cn, long long n, int nl, int d,
           long long* __restrict__ out) {
  __shared__ float xs[K19_BK][K19_BM + 1];
  __shared__ float cs[K19_BK][K19_BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // centroid group: centroids tx + 16 j
  const int ty = tid >> 4;  // row group: rows ty + 16 i
  const long long row0 = (long long)blockIdx.x * K19_BM;
  float best[4];
  int bidx[4];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    bidx[i] = 0x7fffffff;
  }
  for (int c0 = 0; c0 < nl; c0 += K19_BN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; i++)
#pragma unroll
      for (int j = 0; j < 4; j++) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += K19_BK) {
      __syncthreads();  // the previous slice is consumed
      for (int e = tid; e < K19_BM * K19_BK; e += K19_THREADS) {
        int r = e / K19_BK, kk = e % K19_BK;
        int k = k0 + kk;
        long long row = row0 + r;
        int cc = c0 + r;
        xs[kk][r] = (row < n && k < d) ? x[row * d + k] : 0.0f;
        cs[kk][r] = (cc < nl && k < d) ? c[(long long)cc * d + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < K19_BK; kk++) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; i++) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; j++) b[j] = cs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; i++)
#pragma unroll
          for (int j = 0; j < 4; j++) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; i++) {
      float bv = __int_as_float(0x7f800000);
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 4; j++) {
        int cc = c0 + tx + 16 * j;
        if (cc < nl) {
          // -2 x.c is exact, so this rounds as -2 (x.c) + |c|^2 does
          float dv = fmaf(-2.0f, acc[i][j], cn[cc]);
          if (k19_better(dv, cc, bv, bi)) {
            bv = dv;
            bi = cc;
          }
        }
      }
      for (int o = 8; o > 0; o >>= 1) {  // the 16 lanes of a row group
        float ov = __shfl_xor_sync(OB_FULL_MASK, bv, o);
        int oi = __shfl_xor_sync(OB_FULL_MASK, bi, o);
        if (k19_better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (k19_better(bv, bi, best[i], bidx[i])) {
        best[i] = bv;
        bidx[i] = bi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; i++) {
      long long row = row0 + ty + 16 * i;
      if (row < n) out[row] = (long long)bidx[i];
    }
  }
}

// x: (n, d) float32, c: (nl, d) float32, both row-major; cn: float32 [nl]
// scratch (|c|^2); out: int64 [n].
extern "C" int ob_k19_assign(const void* x, const void* c, void* cn,
                             long long n, int nl, int d, void* out,
                             void* stream) {
  if (n < 1 || nl < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int nb = (int)(((long long)nl * 32 + 255) / 256);
  k19_norms<<<nb, 256, 0, s>>>((const float*)c, nl, d, (float*)cn);
  long long blocks = (n + K19_BM - 1) / K19_BM;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  k19_assign<<<(unsigned)blocks, K19_THREADS, 0, s>>>(
      (const float*)x, (const float*)c, (const float*)cn, n, nl, d,
      (long long*)out);
  return (int)cudaGetLastError();
}
