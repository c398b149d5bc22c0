// K25: the send half of a PX exchange -- a destination shard per row, and
// the rows of every column and validity plane packed into [nsh, cap]
// per-destination lanes, stably.
//
// Replaces oceanbase_tpu/parallel/exchange.py:45 dest_by_hash
// (hash32_combine % nsh), :52 dest_by_range (searchsorted side="right"
// on the n_shards-1 bounds), :59 dest_round_robin ((cumsum(mask) - 1 +
// shard) mod nsh), :231 dest_by_partition (owner[part]), and the send
// half of :65 repartition (:80-99): dead rows go nowhere, the live rows
// sort stably by destination (lax.sort is stable, so a lane holds its
// rows in ascending source order), per-destination counts, overflow =
// sum over destinations of max(count - cap, 0), and every plane gathered
// into the lanes. Slot j of lane d is live when j < min(count[d], cap);
// a dead slot holds zero bytes (the reference's holds whatever row sits
// there in its sorted order: only the sent mask is read).
//
// Bound on an H100 (3.35 TB/s): read the keys (or dest) and the mask
// once, write dest (4 B a row); the pack reads dest and mask once and,
// for the rows it sends, each plane's element, and writes nsh * cap slots
// of every plane and the sent mask. Memory bound; the gather reads are
// random where the rows of a lane are spread.
//
// Design: no sort and no atomics in row order. (1) k25_dest, one thread
// a row: the hash of the key columns (through a device table of column
// addresses and type codes), the range search over the bounds in shared
// memory, or the owner lookup. (2) k25_count: per tile of K25_TILE rows,
// a shared-memory histogram over the destinations. (3) k25_scan: one
// block per destination scans its tiles' counts into tile offsets and the
// destination's total. (4) k25_place: each tile ranks its rows per
// destination in row order (__match_any_sync within a warp, the warps'
// counts in shared memory between them), and a row whose rank in its
// lane is below cap writes its row index into take[d * cap + rank]. (5)
// k25_gather: one thread a slot writes the slot of every plane (through
// a device table, any number of planes) and the sent mask; block 0 sums
// the overflow. Round robin reuses (2)-(3) with one bin and ranks the
// live rows in k25_rr.
#include "ob_common.cuh"

#define K25_THREADS 256
#define K25_TILE 1024
#define K25_MAX_SHARDS 64
#define K25_SCAN_THREADS 1024

#define K25_HASH 0
#define K25_RANGE 1
#define K25_PART 2

// floor modulo (jnp's %, the divisor's sign)
__device__ __forceinline__ long long k25_floor_mod(long long a, long long m) {
  long long r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

__global__ void k25_dest(int mode, int ncols, const long long* __restrict__ cols,
                         const long long* __restrict__ dts, long long n,
                         int nsh, const long long* __restrict__ bounds,
                         int nb, const void* owner, int owner_dt,
                         long long owner_n, int desc, int* __restrict__ dest) {
  __shared__ long long sb[K25_MAX_SHARDS];
  if (mode == K25_RANGE) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = bounds[i];
    __syncthreads();
  }
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int d;
    if (mode == K25_HASH) {
      d = (int)(ob_hash32_row(ncols, cols, dts, i) % (unsigned)nsh);
    } else if (mode == K25_RANGE) {
      long long k = ob_ldg_i64((const void*)cols[0], (int)dts[0], i);
      int lo = 0, hi = nb;  // first bound > k (side="right")
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (sb[mid] <= k) lo = mid + 1; else hi = mid;
      }
      d = desc ? nsh - 1 - lo : lo;
    } else {
      long long p = ob_ldg_i64((const void*)cols[0], (int)dts[0], i);
      if (p < 0) p += owner_n;  // numpy-style negative index
      p = p < 0 ? 0 : (p >= owner_n ? owner_n - 1 : p);  // jnp clamps
      d = (int)ob_ldg_i64(owner, owner_dt, p);
    }
    dest[i] = d;
  }
}

// counts[d * ntiles + t] = live rows of tile t bound for d in [0, nbins);
// dest null = every live row to bin 0.
__global__ void k25_count(const int* __restrict__ dest,
                          const unsigned char* __restrict__ mask, long long n,
                          int nbins, long long ntiles, int* __restrict__ counts) {
  __shared__ int hist[K25_MAX_SHARDS];
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  long long r0 = (long long)blockIdx.x * K25_TILE;
  for (int j = threadIdx.x; j < K25_TILE; j += blockDim.x) {
    long long i = r0 + j;
    if (i < n && mask[i]) {
      int d = dest ? dest[i] : 0;
      if (d >= 0 && d < nbins) atomicAdd(&hist[d], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    counts[(long long)b * ntiles + blockIdx.x] = hist[b];
  }
}

// One block per bin: offs[d * ntiles + t] = rows of bin d in tiles < t,
// totals[d] = all of them.
__global__ void k25_scan(const int* __restrict__ counts, long long ntiles,
                         long long* __restrict__ offs,
                         long long* __restrict__ totals) {
  const int* c = counts + (long long)blockIdx.x * ntiles;
  long long* o = offs + (long long)blockIdx.x * ntiles;
  long long per = (ntiles + blockDim.x - 1) / blockDim.x;
  long long t0 = (long long)threadIdx.x * per;
  long long t1 = t0 + per < ntiles ? t0 + per : ntiles;
  long long s = 0;
  for (long long t = t0; t < t1; t++) s += c[t];
  long long total;
  long long run = ob_block_exscan(s, &total);
  for (long long t = t0; t < t1; t++) {
    o[t] = run;
    run += c[t];
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Stable rank of each live row among the rows of its destination, tile by
// tile (blockDim.x == K25_THREADS): take[d * cap + rank] = row for ranks
// below cap.
__global__ void k25_place(const int* __restrict__ dest,
                          const unsigned char* __restrict__ mask, long long n,
                          int nsh, long long cap, long long ntiles,
                          const long long* __restrict__ offs,
                          long long* __restrict__ take) {
  __shared__ int wcount[K25_THREADS / 32][K25_MAX_SHARDS];
  __shared__ long long run[K25_MAX_SHARDS];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < nsh; b += blockDim.x) {
    run[b] = offs[(long long)b * ntiles + blockIdx.x];
  }
  long long r0 = (long long)blockIdx.x * K25_TILE;
  unsigned lt = (1u << lane) - 1u;
  for (int base = 0; base < K25_TILE; base += K25_THREADS) {
    for (int k = threadIdx.x; k < (K25_THREADS / 32) * nsh; k += blockDim.x) {
      wcount[k / nsh][k % nsh] = 0;
    }
    __syncthreads();
    long long i = r0 + base + threadIdx.x;
    int d = -1;
    if (i < n && mask[i]) {
      d = dest[i];
      if (d < 0 || d >= nsh) d = -1;
    }
    unsigned peers = __match_any_sync(OB_FULL_MASK, d);
    int rank = __popc(peers & lt);
    if (d >= 0 && rank == 0) wcount[warp][d] = __popc(peers);
    __syncthreads();
    if (d >= 0) {
      long long slot = run[d] + rank;
      for (int w = 0; w < warp; w++) slot += wcount[w][d];
      if (slot < cap) take[(long long)d * cap + slot] = i;
    }
    __syncthreads();
    for (int b = threadIdx.x; b < nsh; b += blockDim.x) {
      long long s = 0;
      for (int w = 0; w < K25_THREADS / 32; w++) s += wcount[w][b];
      run[b] += s;
    }
    __syncthreads();
  }
}

// Every slot of every plane: planes[c] the source, planes[np + c] the
// lane buffer, esz[c] the element bytes (a row's bytes for a plane of
// fixed-width rows, a VECTOR column).
__global__ void k25_gather(int np, const long long* __restrict__ planes,
                           const long long* __restrict__ esz, int nsh,
                           long long cap, const long long* __restrict__ take,
                           const long long* __restrict__ totals,
                           unsigned char* __restrict__ sent,
                           long long* __restrict__ overflow) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    long long o = 0;
    for (int d = 0; d < nsh; d++) o += totals[d] > cap ? totals[d] - cap : 0;
    *overflow = o;
  }
  long long total = (long long)nsh * cap;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < total; p += stride) {
    long long d = p / cap, j = p - d * cap;
    long long lim = totals[d] < cap ? totals[d] : cap;
    bool live = j < lim;
    long long row = live ? take[p] : -1;
    sent[p] = live ? 1 : 0;
    for (int c = 0; c < np; c++) {
      ob_copy_elem((const void*)planes[c], (void*)planes[np + c], (int)esz[c],
                   row, p);
    }
  }
}

// Round robin: dest[i] = (live rows of [0, i] - 1 + shard) mod nsh.
__global__ void k25_rr(const unsigned char* __restrict__ mask, long long n,
                       int nsh, int shard, const long long* __restrict__ offs,
                       int* __restrict__ dest) {
  long long r0 = (long long)blockIdx.x * K25_TILE;
  const int per = K25_TILE / K25_THREADS;
  long long i0 = r0 + (long long)threadIdx.x * per;
  long long c = 0;
  for (int j = 0; j < per; j++) c += (i0 + j < n && mask[i0 + j]) ? 1 : 0;
  long long total;
  long long before = offs[blockIdx.x] + ob_block_exscan(c, &total);
  for (int j = 0; j < per; j++) {
    long long i = i0 + j;
    if (i >= n) break;
    if (mask[i]) before++;
    dest[i] = (int)k25_floor_mod(before - 1 + shard, nsh);
  }
}

extern "C" int ob_k25_tile_rows() { return K25_TILE; }

// mode K25_HASH: ncols key columns; K25_RANGE: cols[0] the int key, nb =
// nsh - 1 bounds (int64, ascending); K25_PART: cols[0] the partition ids,
// owner (owner_n entries of type owner_dt). table: int64 device array of
// ncols addresses then ncols type codes. dest: int32 [n].
extern "C" int ob_k25_dest(int mode, int ncols, const void* table,
                           long long n, int nsh, const void* bounds, int nb,
                           const void* owner, int owner_dt, long long owner_n,
                           int desc, void* dest, int blocks, void* stream) {
  if (nsh < 1 || nsh > K25_MAX_SHARDS || n < 0 || ncols < 1 ||
      nb > K25_MAX_SHARDS || (mode == K25_PART && owner_n < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const long long* t = (const long long*)table;
  k25_dest<<<blocks, K25_THREADS, 0, (cudaStream_t)stream>>>(
      mode, ncols, t, t + ncols, n, nsh, (const long long*)bounds, nb, owner,
      owner_dt, owner_n, desc, (int*)dest);
  return (int)cudaGetLastError();
}

// dest int32 [n], mask bool [n]; np planes through table (np source
// addresses, np lane-buffer addresses of nsh * cap elements, np element
// sizes); sent bool [nsh * cap]; overflow int64 [1]; scratch: counts
// int32 [nsh * ntiles], offs int64 [nsh * ntiles], totals int64 [nsh],
// take int64 [nsh * cap], ntiles = ceil(n / K25_TILE).
extern "C" int ob_k25_pack(const void* dest, const void* mask, long long n,
                           int nsh, long long cap, int np, const void* table,
                           void* sent, void* overflow, void* counts,
                           void* offs, void* totals, void* take, int blocks,
                           void* stream) {
  if (nsh < 1 || nsh > K25_MAX_SHARDS || cap < 1 || n < 1 || np < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  long long ntiles = (n + K25_TILE - 1) / K25_TILE;
  k25_count<<<(unsigned)ntiles, K25_THREADS, 0, s>>>(
      (const int*)dest, (const unsigned char*)mask, n, nsh, ntiles,
      (int*)counts);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  k25_scan<<<nsh, K25_SCAN_THREADS, 0, s>>>(
      (const int*)counts, ntiles, (long long*)offs, (long long*)totals);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  k25_place<<<(unsigned)ntiles, K25_THREADS, 0, s>>>(
      (const int*)dest, (const unsigned char*)mask, n, nsh, cap, ntiles,
      (const long long*)offs, (long long*)take);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long* t = (const long long*)table;
  k25_gather<<<blocks, K25_THREADS, 0, s>>>(
      np, t, t + 2 * np, nsh, cap, (const long long*)take,
      (const long long*)totals, (unsigned char*)sent, (long long*)overflow);
  return (int)cudaGetLastError();
}

// Round robin over mask bool [n]: dest int32 [n]; scratch counts int32
// [ntiles], offs int64 [ntiles], totals int64 [1].
extern "C" int ob_k25_round_robin(const void* mask, long long n, int nsh,
                                  int shard, void* dest, void* counts,
                                  void* offs, void* totals, void* stream) {
  if (nsh < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long ntiles = (n + K25_TILE - 1) / K25_TILE;
  k25_count<<<(unsigned)ntiles, K25_THREADS, 0, s>>>(
      nullptr, (const unsigned char*)mask, n, 1, ntiles, (int*)counts);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  k25_scan<<<1, K25_SCAN_THREADS, 0, s>>>(
      (const int*)counts, ntiles, (long long*)offs, (long long*)totals);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  k25_rr<<<(unsigned)ntiles, K25_THREADS, 0, s>>>(
      (const unsigned char*)mask, n, nsh, shard, (const long long*)offs,
      (int*)dest);
  return (int)cudaGetLastError();
}
