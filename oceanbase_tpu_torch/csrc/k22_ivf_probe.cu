// K22: the IVF probe's candidate gather, exact re-rank and top-k, with the
// fused filter and the starvation counter.
//
// Replaces oceanbase_tpu/engine/executor.py:1574-1601 (_emit_vector_topn's
// round 2). Candidate position p * max_list + j (probe order, as the
// reference flattens `rows`) is row perm[clip(offs[probes[p]] + j)]; it is
// live when j < lens[probes[p]] and the row's sel (the fused filter) is
// set. dist = |x|^2 - 2 x.q (no |q|^2, as the reference), +inf when dead;
// the k' = min(k, candidates) smallest in lax.top_k(-dist)'s order
// (smaller distance first, the lower candidate position on ties) give the
// winners' rows and sel = dist < inf; the starvation count is
// max(k' - live candidates, 0), an exact integer sum.
//
// Bound on an H100: each candidate's 512-byte row (d = 128) read once,
// plus its perm entry and sel byte: C (512 + 4 + 1) bytes over 3.35 TB/s.
// Memory bound; at C ~ 100k candidates that is ~16 us, so launches and
// the selection dominate.
//
// Design: a tile pass over a grid of at most two blocks per SM. Each
// thread of a block takes one candidate of a 256-candidate tile: the index
// reads, then the dot product and norm over its row in float32 (16-byte
// loads when d % 4 == 0). A candidate's key is its distance's
// order-preserving image above its position: unique, ordered as
// lax.top_k orders. The block merges each tile into its running k'
// smallest keys in shared memory (a key's new rank = the smaller keys
// counted in both), keys above the running k'-th skipped. A one-block
// merge launch folds the blocks' runs the same way and writes the rows,
// sel and the counter.
#include "ob_common.cuh"

#define K22_TILE 256
#define K22_EMPTY 0xffffffffffffffffULL

// Merge `tile` (m keys in any order; K22_EMPTY = none) into `run`, the
// sorted kk smallest keys so far (K22_EMPTY-padded). Keys other than
// K22_EMPTY are unique. Called by every thread of the block.
__device__ void k22_merge(unsigned long long* run, unsigned long long* nrun,
                          const unsigned long long* tile, int m, int kk) {
  for (int r = threadIdx.x; r < kk; r += blockDim.x) nrun[r] = K22_EMPTY;
  __syncthreads();
  const unsigned long long thr = run[kk - 1];
  for (int e = threadIdx.x; e < kk + m; e += blockDim.x) {
    unsigned long long v = e < kk ? run[e] : tile[e - kk];
    if (v == K22_EMPTY) continue;
    int rank;
    if (e < kk) {
      rank = e;  // the run is sorted and its keys unique
    } else {
      if (v > thr) continue;  // kk smaller keys already held
      int lo = 0, hi = kk;
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (run[mid] < v) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      rank = lo;
    }
    for (int t = 0; t < m && rank < kk; t++) rank += tile[t] < v;
    if (rank < kk) nrun[rank] = v;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kk; r += blockDim.x) run[r] = nrun[r];
  __syncthreads();
}

// The candidate's window slot: its list and its row (perm entry of the
// clipped window index), and whether the window holds a row there.
__device__ __forceinline__ long long k22_slot(
    const int* __restrict__ perm, const int* __restrict__ offs,
    const int* __restrict__ lens, const int* __restrict__ probes,
    int max_list, long long n, long long pos, bool* in_window) {
  int p = (int)(pos / max_list);
  int j = (int)(pos - (long long)p * max_list);
  int list = __ldg(probes + p);
  *in_window = j < __ldg(lens + list);
  long long w = (long long)__ldg(offs + list) + j;
  if (w > n - 1) w = n - 1;
  if (w < 0) w = 0;
  return (long long)__ldg(perm + w);
}

__global__ void __launch_bounds__(K22_TILE)
k22_tiles(const float* __restrict__ x, const unsigned char* __restrict__ sel,
          const int* __restrict__ perm, const int* __restrict__ offs,
          const int* __restrict__ lens, const int* __restrict__ probes,
          const float* __restrict__ q, long long cand, int max_list,
          long long n, int d, int kk,
          unsigned long long* __restrict__ partial,
          unsigned long long* __restrict__ live) {
  extern __shared__ unsigned long long k22_sm[];
  unsigned long long* run = k22_sm;
  unsigned long long* nrun = k22_sm + kk;
  unsigned long long* tkey = k22_sm + 2 * kk;
  __shared__ unsigned long long wlive[K22_TILE / 32];
  for (int r = threadIdx.x; r < kk; r += blockDim.x) run[r] = K22_EMPTY;
  unsigned long long mylive = 0;
  const bool vec4 = (d & 3) == 0 && (((size_t)x | (size_t)q) & 15) == 0;
  const long long ntiles = (cand + K22_TILE - 1) / K22_TILE;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long pos = t * K22_TILE + threadIdx.x;
    unsigned long long key = K22_EMPTY;
    if (pos < cand) {
      bool in_window;
      long long row = k22_slot(perm, offs, lens, probes, max_list, n, pos,
                               &in_window);
      float dist = __int_as_float(0x7f800000);  // +inf: dead
      if (in_window && __ldg(sel + row)) {
        mylive++;
        float dot = 0.0f, nrm = 0.0f;
        const float* xr = x + row * d;
        if (vec4) {
          const float4* x4 = (const float4*)xr;
          const float4* q4 = (const float4*)q;
          for (int k = 0; k < (d >> 2); k++) {
            float4 v = __ldg(x4 + k), w = __ldg(q4 + k);
            dot = fmaf(v.x, w.x, dot);
            nrm = fmaf(v.x, v.x, nrm);
            dot = fmaf(v.y, w.y, dot);
            nrm = fmaf(v.y, v.y, nrm);
            dot = fmaf(v.z, w.z, dot);
            nrm = fmaf(v.z, v.z, nrm);
            dot = fmaf(v.w, w.w, dot);
            nrm = fmaf(v.w, v.w, nrm);
          }
        } else {
          for (int k = 0; k < d; k++) {
            float v = __ldg(xr + k);
            dot = fmaf(v, __ldg(q + k), dot);
            nrm = fmaf(v, v, nrm);
          }
        }
        dist = fmaf(-2.0f, dot, nrm);
      }
      key = ((unsigned long long)ob_f32_image(dist) << 32) |
            (unsigned long long)pos;
    }
    tkey[threadIdx.x] = key;
    __syncthreads();
    k22_merge(run, nrun, tkey, K22_TILE, kk);
  }
  for (int o = 16; o > 0; o >>= 1)
    mylive += __shfl_xor_sync(OB_FULL_MASK, mylive, o);
  if ((threadIdx.x & 31) == 0) wlive[threadIdx.x >> 5] = mylive;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < K22_TILE / 32; w++) s += wlive[w];
    if (s) atomicAdd(live, s);
  }
  for (int r = threadIdx.x; r < kk; r += blockDim.x)
    partial[(long long)blockIdx.x * kk + r] = run[r];
}

__global__ void k22_final(const unsigned long long* __restrict__ partial,
                          int nblocks, int kk, const int* __restrict__ perm,
                          const int* __restrict__ offs,
                          const int* __restrict__ lens,
                          const int* __restrict__ probes, int max_list,
                          long long n,
                          const unsigned long long* __restrict__ live,
                          int* __restrict__ rows,
                          unsigned char* __restrict__ osel,
                          long long* __restrict__ starved) {
  extern __shared__ unsigned long long k22_sm[];
  unsigned long long* run = k22_sm;
  unsigned long long* nrun = k22_sm + kk;
  for (int r = threadIdx.x; r < kk; r += blockDim.x) run[r] = partial[r];
  __syncthreads();
  for (int b = 1; b < nblocks; b++)
    k22_merge(run, nrun, partial + (long long)b * kk, kk, kk);
  for (int r = threadIdx.x; r < kk; r += blockDim.x) {
    unsigned long long key = run[r];
    bool in_window;
    rows[r] = (int)k22_slot(perm, offs, lens, probes, max_list, n,
                            (long long)(key & 0xffffffffULL), &in_window);
    osel[r] = (unsigned)(key >> 32) < OB_F32_INF_IMAGE;
  }
  if (threadIdx.x == 0) {
    long long s = (long long)kk - (long long)*live;
    *starved = s > 0 ? s : 0;
  }
}

// x: (>= n, d) float32 row-major, sel: bool [>= n]; perm: int32 [>= n];
// offs, lens: int32 [L]; probes: int32 [nprobe]; q: float32 [d]. kk =
// min(k, nprobe * max_list) <= 2048. partial: int64 [nblocks * kk]
// scratch; live: int64, zero on entry; rows: int32 [kk]; osel: bool [kk];
// starved: int64.
extern "C" int ob_k22_probe(const void* x, const void* sel, const void* perm,
                            const void* offs, const void* lens,
                            const void* probes, const void* q, int nprobe,
                            int max_list, long long n, int d, int kk,
                            int nblocks, void* partial, void* live,
                            void* rows, void* osel, void* starved,
                            void* stream) {
  long long cand = (long long)nprobe * max_list;
  if (cand < 1 || n < 1 || d < 1 || kk < 1 || kk > 2048 || kk > cand ||
      nblocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem = (size_t)(2 * kk + K22_TILE) * sizeof(unsigned long long);
  k22_tiles<<<nblocks, K22_TILE, smem, s>>>(
      (const float*)x, (const unsigned char*)sel, (const int*)perm,
      (const int*)offs, (const int*)lens, (const int*)probes,
      (const float*)q, cand, max_list, n, d, kk,
      (unsigned long long*)partial, (unsigned long long*)live);
  k22_final<<<1, K22_TILE, (size_t)2 * kk * sizeof(unsigned long long), s>>>(
      (const unsigned long long*)partial, nblocks, kk, (const int*)perm,
      (const int*)offs, (const int*)lens, (const int*)probes, max_list, n,
      (const unsigned long long*)live, (int*)rows, (unsigned char*)osel,
      (long long*)starved);
  return (int)cudaGetLastError();
}

extern "C" int ob_k22_tile() { return K22_TILE; }
