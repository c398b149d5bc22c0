// K31: the mesh-sharded IVF probe's per-shard re-rank and its merge.
//
// Replaces oceanbase_tpu/parallel/ann.py:86 ShardedIvf._compile (its
// shard_map body `local`, :93-122). Every shard runs the same probe over
// replicated centroids (the top-nprobe lists: K21, with the same tie
// order) and re-ranks only the candidates its contiguous block of the
// permuted rows holds:
//   ob_k31_rerank  candidate c = p * max_list + j (probe order, as the
//                  reference flattens `pos`) has window position pos =
//                  offs[probes[p]] + j; it is mine when j < lens[probes[p]]
//                  and lo <= pos < lo + rps. dist = |x|^2 - 2 x.q over the
//                  block's row pos - lo in float32, +inf where not mine;
//                  the kk = min(k, candidates) smallest in lax.top_k(-dist)'s
//                  order (smaller distance first, the lower c on ties)
//                  give (dist, pos) strips of kk.
//   ob_k31_merge   the top-kk of the gathered [nsh * kk] strips (the
//                  reference's all_gather then top_k, :119-121), ties to
//                  the lower gathered index: (dist, pos).
//
// Bound on an H100 (3.35 TB/s): the rows a shard owns among the probed
// windows, read once (d float32 each), plus the windows' list metadata and
// the strips written: bytes bound; the merge moves nsh * kk pairs.
//
// Design: K22's selection. A grid of at most two blocks per SM walks
// 256-candidate tiles; a thread takes one candidate, reads its row only
// when the candidate is mine (q held in shared memory), and keys it as the
// distance's order-preserving image above c: keys are unique and ordered
// as lax.top_k orders. Each block folds its tiles into a running sorted
// run of the kk smallest keys (ob_common.cuh's run merges), in shared
// memory up to K31_SMEM_K keys and in device memory past it, so kk is
// bounded by the candidates alone; a one-block launch merges the blocks'
// sorted runs and writes the strips. The merge entry keys the gathered
// distances by their gathered index and runs the same two launches.
// Non-mine lanes read no row; the pad rows of the last block are zeros
// (never inf), as the reference pads them.
//
// The merge of up to K31_MERGE_ONE gathered pairs (nsh * k: 40 for four
// shards at k 10) is one launch of one block, a thread a pair, with no
// scratch: each pair's key (the distance's image above its gathered
// index, unique) sits in shared memory, and its rank is the count of
// smaller keys; a rank below kk writes the pair to that slot. Its device
// work is a few hundred instructions a thread, so the call's cost is the
// launch and the wrapper's host work. Larger merges take the two launches
// above.
#include "ob_common.cuh"

#define K31_TILE 256
#define K31_SMEM_K 2048
#define K31_SMEM_BYTES (48 * 1024)
#define K31_MERGE_ONE 1024

struct K31Probe {
  const float* xs;     // (rps, d) the shard's block
  const int* offs;     // [L]
  const int* lens;     // [L]
  const int* probes;   // [nprobe]
  const float* q;      // [d]
  long long lo;        // the block's first global position
  long long rps;       // rows per shard
  int max_list;
  int d;
};

// The candidate's window position and whether this shard re-ranks it.
__device__ __forceinline__ long long k31_pos(const K31Probe& a, long long c,
                                             bool* mine) {
  int p = (int)(c / a.max_list);
  int j = (int)(c - (long long)p * a.max_list);
  int list = __ldg(a.probes + p);
  long long pos = (long long)__ldg(a.offs + list) + j;
  *mine = j < __ldg(a.lens + list) && pos >= a.lo && pos < a.lo + a.rps;
  return pos;
}

__device__ __forceinline__ float k31_dist(const K31Probe& a, long long row,
                                          const float* q) {
  const float* xr = a.xs + row * a.d;
  float dot = 0.0f, nrm = 0.0f;
  if ((a.d & 3) == 0 && (((size_t)xr | (size_t)q) & 15) == 0) {
    const float4* x4 = (const float4*)xr;
    const float4* q4 = (const float4*)q;
    for (int k = 0; k < (a.d >> 2); k++) {
      float4 v = __ldg(x4 + k), w = q4[k];
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
    for (int k = 0; k < a.d; k++) {
      float v = __ldg(xr + k);
      dot = fmaf(v, q[k], dot);
      nrm = fmaf(v, v, nrm);
    }
  }
  return fmaf(-2.0f, dot, nrm);
}

// One tile pass. gd null: the re-rank over `cand` candidates of `a`;
// else the merge over `cand` gathered distances gd. Dynamic shared memory:
// the tile's keys, then the run and its buffer (2 kk keys) unless gruns
// holds them, then q (d floats) when q_in_smem.
__global__ void __launch_bounds__(K31_TILE)
k31_tiles(K31Probe a, const float* __restrict__ gd, long long cand, int kk,
          unsigned long long* __restrict__ partial, unsigned long long* gruns,
          int q_in_smem) {
  extern __shared__ unsigned long long k31_sm[];
  unsigned long long* tkey = k31_sm;
  unsigned long long* run =
      gruns ? gruns + (long long)blockIdx.x * 2 * kk : k31_sm + K31_TILE;
  unsigned long long* nrun = run + kk;
  const float* q = a.q;
  if (!gd && q_in_smem) {
    float* qs = (float*)(k31_sm + K31_TILE + (gruns ? 0 : 2 * kk));
    for (int k = threadIdx.x; k < a.d; k += blockDim.x) qs[k] = __ldg(a.q + k);
    q = qs;
  }
  for (int r = threadIdx.x; r < kk; r += blockDim.x) run[r] = OB_RUN_EMPTY;
  __syncthreads();
  const long long ntiles = (cand + K31_TILE - 1) / K31_TILE;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long c = t * K31_TILE + threadIdx.x;
    unsigned long long key = OB_RUN_EMPTY;
    if (c < cand) {
      float dist;
      if (gd) {
        dist = __ldg(gd + c);
      } else {
        bool mine;
        long long pos = k31_pos(a, c, &mine);
        dist = mine ? k31_dist(a, pos - a.lo, q) : __int_as_float(0x7f800000);
      }
      key = ((unsigned long long)ob_f32_image(dist) << 32) |
            (unsigned long long)c;
    }
    tkey[threadIdx.x] = key;
    __syncthreads();
    ob_run_merge_tile(run, nrun, tkey, K31_TILE, kk);
  }
  for (int r = threadIdx.x; r < kk; r += blockDim.x)
    partial[(long long)blockIdx.x * kk + r] = run[r];
}

// One block: the blocks' sorted runs merged; the strip of kk (dist, pos).
// gd null: the re-rank's strip (dist from the key, pos from c); else the
// merge's (gd and gp at the gathered index).
__global__ void k31_final(K31Probe a, const float* __restrict__ gd,
                          const int* __restrict__ gp,
                          const unsigned long long* __restrict__ partial,
                          int nblocks, int kk, unsigned long long* gruns,
                          float* __restrict__ out_dist,
                          int* __restrict__ out_pos) {
  extern __shared__ unsigned long long k31_sm[];
  unsigned long long* run = gruns ? gruns : k31_sm;
  unsigned long long* nrun = run + kk;
  for (int r = threadIdx.x; r < kk; r += blockDim.x) run[r] = partial[r];
  __syncthreads();
  for (int b = 1; b < nblocks; b++)
    ob_run_merge_sorted(run, nrun, partial + (long long)b * kk, kk);
  for (int r = threadIdx.x; r < kk; r += blockDim.x) {
    unsigned long long key = run[r];
    long long c = (long long)(key & 0xffffffffULL);
    if (gd) {
      out_dist[r] = gd[c];
      out_pos[r] = gp[c];
    } else {
      bool mine;
      out_dist[r] = ob_f32_from_image((unsigned int)(key >> 32));
      out_pos[r] = (int)k31_pos(a, c, &mine);
    }
  }
}

static int k31_launch(const K31Probe& a, const float* gd, const int* gp,
                      long long cand, int kk, int nblocks, void* partial,
                      void* gruns, void* out_dist, void* out_pos,
                      void* stream) {
  if (cand < 1 || cand >= (1ll << 32) || kk < 1 || kk > cand ||
      nblocks < 1 || ((kk > K31_SMEM_K) != (gruns != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* g = (unsigned long long*)gruns;
  size_t keys = (size_t)(K31_TILE + (g ? 0 : 2 * kk)) *
                sizeof(unsigned long long);
  size_t qbytes = gd ? 0 : (size_t)a.d * sizeof(float);
  int q_in_smem = !gd && keys + qbytes <= K31_SMEM_BYTES;
  k31_tiles<<<nblocks, K31_TILE, keys + (q_in_smem ? qbytes : 0), s>>>(
      a, gd, cand, kk, (unsigned long long*)partial, g, q_in_smem);
  size_t fsm = g ? 0 : (size_t)2 * kk * sizeof(unsigned long long);
  k31_final<<<1, K31_TILE, fsm, s>>>(
      a, gd, gp, (const unsigned long long*)partial, nblocks, kk,
      g ? g + (long long)nblocks * 2 * kk : nullptr, (float*)out_dist,
      (int*)out_pos);
  return (int)cudaGetLastError();
}

// xs: the shard's (rps, d) float32 block, row-major; offs, lens: int32
// [L]; probes: int32 [nprobe] (K21); q: float32 [d]; lo: the block's
// first global position. kk = min(k, nprobe * max_list). partial: int64
// [nblocks * kk] scratch; gruns: null when kk <= K31_SMEM_K, else int64
// [(nblocks + 1) * 2 kk] scratch; out_dist: float32 [kk]; out_pos: int32
// [kk].
extern "C" int ob_k31_rerank(const void* xs, long long rps, int d,
                             long long lo, const void* offs,
                             const void* lens, const void* probes,
                             int nprobe, int max_list, const void* q, int kk,
                             int nblocks, void* partial, void* gruns,
                             void* out_dist, void* out_pos, void* stream) {
  if (rps < 1 || d < 1 || lo < 0 || nprobe < 1 || max_list < 1) {
    return (int)cudaErrorInvalidValue;
  }
  K31Probe a;
  a.xs = (const float*)xs;
  a.offs = (const int*)offs;
  a.lens = (const int*)lens;
  a.probes = (const int*)probes;
  a.q = (const float*)q;
  a.lo = lo;
  a.rps = rps;
  a.max_list = max_list;
  a.d = d;
  return k31_launch(a, nullptr, nullptr, (long long)nprobe * max_list, kk,
                    nblocks, partial, gruns, out_dist, out_pos, stream);
}

// gd: float32 [m] gathered distances, gp: int32 [m] their positions (m =
// nsh * kk_in); kk <= m; scratch and outputs as ob_k31_rerank.
extern "C" int ob_k31_merge(const void* gd, const void* gp, long long m,
                            int kk, int nblocks, void* partial, void* gruns,
                            void* out_dist, void* out_pos, void* stream) {
  K31Probe a;
  memset(&a, 0, sizeof(a));
  return k31_launch(a, (const float*)gd, (const int*)gp, m, kk, nblocks,
                    partial, gruns, out_dist, out_pos, stream);
}

__global__ void __launch_bounds__(K31_MERGE_ONE)
k31_merge_one(const float* __restrict__ gd, const int* __restrict__ gp,
              int m, int kk, float* __restrict__ out_dist,
              int* __restrict__ out_pos) {
  __shared__ unsigned long long keys[K31_MERGE_ONE];
  const int i = threadIdx.x;
  float d = 0.0f;
  unsigned long long k = OB_RUN_EMPTY;
  if (i < m) {
    d = __ldg(gd + i);
    k = ((unsigned long long)ob_f32_image(d) << 32) | (unsigned int)i;
  }
  keys[i] = k;
  __syncthreads();
  if (i < m) {
    int rank = 0;
    for (int j = 0; j < m; j++) rank += keys[j] < k;
    if (rank < kk) {
      out_dist[rank] = d;
      out_pos[rank] = __ldg(gp + i);
    }
  }
}

// The merge in one launch: gd, gp as ob_k31_merge, 1 <= kk <= m <=
// K31_MERGE_ONE; no scratch.
extern "C" int ob_k31_merge_one(const void* gd, const void* gp, int m, int kk,
                                void* out_dist, void* out_pos, void* stream) {
  if (m < 1 || m > K31_MERGE_ONE || kk < 1 || kk > m) {
    return (int)cudaErrorInvalidValue;
  }
  k31_merge_one<<<1, (m + 31) & ~31, 0, (cudaStream_t)stream>>>(
      (const float*)gd, (const int*)gp, m, kk, (float*)out_dist,
      (int*)out_pos);
  return (int)cudaGetLastError();
}

extern "C" int ob_k31_merge_one_max() { return K31_MERGE_ONE; }

extern "C" int ob_k31_tile() { return K31_TILE; }

extern "C" int ob_k31_smem_k() { return K31_SMEM_K; }
