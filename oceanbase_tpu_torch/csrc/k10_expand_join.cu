// K10: M:N join expansion against a key-sorted build side.
//
// Replaces oceanbase_tpu/ops/join.py:177 expand_join, and the range search
// that the sorted-range route of oceanbase_tpu/engine/executor.py:2283-2296
// (_emit_semi_anti) runs alone. The build keys arrive sorted ascending with
// the dead rows last (sort_build_side); nlive, the live build count, stays
// on the device. Per probe row p:
//   lo, hi = the [lower, upper) bounds of its int64 key in the sorted
//            keys, clamped to nlive (the dead tail carries int64 max, and
//            a live probe key of int64 max must not match it)
//   cnt    = probe_sel ? hi - lo : 0
//   offs   = inclusive prefix sum of cnt, starts = offs - cnt (int64)
//   total  = offs[np - 1]
// and per output slot t < cap, with p the probe row whose run
// [starts[p], offs[p]) holds t:
//   probe_row = p, build_row = order[lo[p] + t - starts[p]], valid = 1.
// Slots t >= total hold the reference's clip values: probe_row = np - 1,
// build_row = order[clip(int32(lo[np-1] + t - starts[np-1]), 0, nb - 1)],
// valid = 0, so every slot equals the reference's.
//
// Bound on an H100 (3.35 TB/s): it reads each probe key and sel once and
// writes cnt-derived starts/offs (16 bytes a probe row) and 9 bytes an
// output slot; the binary searches read about log2(nlive) random sectors
// of the sorted keys per probe row, and each live slot reads one random
// order entry. Bytes bound, with the searches' sectors on top.
//
// Design: three phases, no searchsorted over offs. (a) One thread per
// live probe row runs both binary searches over [0, nlive) and writes lo
// and cnt; dead rows search nothing (the no-residual semi/anti join stops
// here: has = cnt > 0). (b) The kernel's own scan of cnt: per-tile sums,
// one block scanning the tile sums (and writing total), then each tile's
// scan with its offset. (c) One thread per probe row writes its own run
// [starts, min(offs, cap)), and a grid-stride pass fills the slots from
// total to cap. Slot indices and offsets are int64 throughout (Q21
// expands past 10^8 pairs).
#include "ob_common.cuh"

#define K10_THREADS 256
#define K10_ITEMS 8
#define K10_TILE (K10_THREADS * K10_ITEMS)
#define K10_SCAN_THREADS 1024

// (a) ranges: cnt (int64) for every probe row, and lo (int64) where an
// output reads it: at live rows, and at row np - 1 whatever its sel (the
// dead-slot clip value reads lo[np - 1]); lo_out may be null. A dead row
// searches nothing.
__global__ void k10_ranges(const long long* __restrict__ skeys,
                           const long long* __restrict__ nlive_p,
                           const long long* __restrict__ pkey,
                           const unsigned char* __restrict__ psel,
                           long long np, long long* __restrict__ lo_out,
                           long long* __restrict__ cnt_out) {
  long long nlive = __ldg(nlive_p);
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < np;
       i += step) {
    bool live = __ldg(psel + i) != 0;
    long long lo = 0, cnt = 0;
    if (live || i == np - 1) {
      long long key = __ldg(pkey + i);
      long long a = 0, b = nlive;  // first index with skeys >= key
      while (a < b) {
        long long m = a + ((b - a) >> 1);
        if (__ldg(skeys + m) < key) a = m + 1; else b = m;
      }
      lo = a;
      if (live) {
        b = nlive;  // first index with skeys > key, searched from lo
        while (a < b) {
          long long m = a + ((b - a) >> 1);
          if (__ldg(skeys + m) <= key) a = m + 1; else b = m;
        }
        cnt = a - lo;
      }
    }
    if (lo_out) lo_out[i] = lo;
    cnt_out[i] = cnt;
  }
}

__device__ __forceinline__ long long k10_warp_incl(long long x) {
  int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    long long y = __shfl_up_sync(OB_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive scan of one value per thread over the block (blockDim.x a
// multiple of 32, at most 1024); *block_total gets the block's sum.
__device__ long long k10_block_excl(long long x, long long* block_total) {
  __shared__ long long warp_sum[32];
  __shared__ long long blk_total;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = blockDim.x >> 5;
  long long incl = k10_warp_incl(x);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nwarps ? warp_sum[lane] : 0;
    long long wi = k10_warp_incl(w);
    if (lane < nwarps) warp_sum[lane] = wi - w;  // exclusive per warp
    if (lane == 31) blk_total = wi;  // lanes past nwarps add 0
  }
  __syncthreads();
  long long out = warp_sum[warp] + incl - x;
  *block_total = blk_total;
  __syncthreads();
  return out;
}

// (b1) per-tile sums of cnt
__global__ void k10_tile_sums(const long long* __restrict__ cnt, long long np,
                              long long ntiles, long long* __restrict__ tsum) {
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long base = t * K10_TILE + (long long)threadIdx.x * K10_ITEMS;
    long long s = 0;
    for (int j = 0; j < K10_ITEMS; j++) {
      long long i = base + j;
      if (i < np) s += __ldg(cnt + i);
    }
    long long tot;
    k10_block_excl(s, &tot);
    if (threadIdx.x == 0) tsum[t] = tot;
  }
}

// (b2) one block: exclusive scan of the tile sums in place; total = sum
__global__ void k10_scan_tiles(long long* tsum, long long ntiles,
                               long long* __restrict__ total) {
  long long carry = 0;
  for (long long base = 0; base < ntiles; base += blockDim.x) {
    long long t = base + threadIdx.x;
    long long v = t < ntiles ? tsum[t] : 0;
    long long tot;
    long long ex = k10_block_excl(v, &tot);
    if (t < ntiles) tsum[t] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) total[0] = carry;
}

// (b3) each tile's scan: starts (exclusive) and offs (inclusive)
__global__ void k10_scan_apply(const long long* __restrict__ cnt, long long np,
                               long long ntiles,
                               const long long* __restrict__ tsum,
                               long long* __restrict__ starts,
                               long long* __restrict__ offs) {
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long base = t * K10_TILE + (long long)threadIdx.x * K10_ITEMS;
    long long v[K10_ITEMS];
    long long s = 0;
    for (int j = 0; j < K10_ITEMS; j++) {
      long long i = base + j;
      v[j] = i < np ? __ldg(cnt + i) : 0;
      s += v[j];
    }
    long long tot;
    long long run = __ldg(tsum + t) + k10_block_excl(s, &tot);
    for (int j = 0; j < K10_ITEMS; j++) {
      long long i = base + j;
      if (i < np) {
        starts[i] = run;
        run += v[j];
        offs[i] = run;
      }
    }
  }
}

// (c1) each probe row writes its own run of slots
__global__ void k10_fill_runs(const long long* __restrict__ lo,
                              const long long* __restrict__ cnt,
                              const long long* __restrict__ starts,
                              long long np, const int* __restrict__ order,
                              long long cap, int* __restrict__ out_pr,
                              int* __restrict__ out_br,
                              unsigned char* __restrict__ out_valid) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < np;
       p += step) {
    long long c = __ldg(cnt + p);
    if (c == 0) continue;
    long long s0 = __ldg(starts + p);
    if (s0 >= cap) continue;
    long long end = s0 + c < cap ? s0 + c : cap;
    long long b0 = __ldg(lo + p) - s0;
    for (long long t = s0; t < end; t++) {
      out_pr[t] = (int)p;
      out_br[t] = __ldg(order + (b0 + t));
      out_valid[t] = 1;
    }
  }
}

// (c2) the slots past total carry the reference's clip values
__global__ void k10_fill_tail(const long long* __restrict__ lo,
                              const long long* __restrict__ starts,
                              long long np, const int* __restrict__ order,
                              long long nb, long long cap,
                              const long long* __restrict__ total_p,
                              int* __restrict__ out_pr,
                              int* __restrict__ out_br,
                              unsigned char* __restrict__ out_valid) {
  long long total = __ldg(total_p);
  long long lo_last = __ldg(lo + np - 1);
  long long st_last = __ldg(starts + np - 1);
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = total + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < cap; t += step) {
    // jnp: (lo + k).astype(int32) wraps, then clips to [0, nb - 1]
    long long b = (long long)(int)(unsigned int)(unsigned long long)(
        lo_last + (t - st_last));
    b = b < 0 ? 0 : (b > nb - 1 ? nb - 1 : b);
    out_pr[t] = (int)(np - 1);
    out_br[t] = __ldg(order + b);
    out_valid[t] = 0;
  }
}

// Phase (a) alone. skeys: int64 [nb] sorted (dead tail last); nlive: int64
// [1] on the device; pkey: int64 [np]; psel: bool [np]; cnt: int64 [np].
extern "C" int ob_k10_ranges(const void* skeys, const void* nlive,
                             const void* pkey, const void* psel, long long np,
                             void* cnt, int nblocks, void* stream) {
  if (np <= 0) return (int)cudaGetLastError();
  k10_ranges<<<nblocks, K10_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)skeys, (const long long*)nlive,
      (const long long*)pkey, (const unsigned char*)psel, np, nullptr,
      (long long*)cnt);
  return (int)cudaGetLastError();
}

// The whole expansion. order: int32 [nb] build row per sorted position;
// tsum: int64 scratch of ntiles = ceil(np / tile) entries; total: int64
// [1]; starts, offs: int64 [np]; out_pr, out_br: int32 [cap]; out_valid:
// bool [cap]. lo and cnt are scratch of np int64 each (lo is written only
// where a slot reads it).
extern "C" int ob_k10_expand(const void* skeys, const void* order,
                             long long nb, const void* nlive,
                             const void* pkey, const void* psel, long long np,
                             long long cap, void* lo, void* cnt, void* tsum,
                             long long ntiles, void* total, void* starts,
                             void* offs, void* out_pr, void* out_br,
                             void* out_valid, int nblocks, void* stream) {
  if (np <= 0 || nb <= 0 || cap < 0 || np >= (1ll << 31) ||
      ntiles != (np + K10_TILE - 1) / K10_TILE) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  k10_ranges<<<nblocks, K10_THREADS, 0, s>>>(
      (const long long*)skeys, (const long long*)nlive,
      (const long long*)pkey, (const unsigned char*)psel, np, (long long*)lo,
      (long long*)cnt);
  int tblocks = (int)(ntiles < (long long)nblocks ? ntiles : nblocks);
  k10_tile_sums<<<tblocks, K10_THREADS, 0, s>>>(
      (const long long*)cnt, np, ntiles, (long long*)tsum);
  k10_scan_tiles<<<1, K10_SCAN_THREADS, 0, s>>>((long long*)tsum, ntiles,
                                                (long long*)total);
  k10_scan_apply<<<tblocks, K10_THREADS, 0, s>>>(
      (const long long*)cnt, np, ntiles, (const long long*)tsum,
      (long long*)starts, (long long*)offs);
  if (cap > 0) {
    k10_fill_runs<<<nblocks, K10_THREADS, 0, s>>>(
        (const long long*)lo, (const long long*)cnt,
        (const long long*)starts, np, (const int*)order, cap, (int*)out_pr,
        (int*)out_br, (unsigned char*)out_valid);
    k10_fill_tail<<<nblocks, K10_THREADS, 0, s>>>(
        (const long long*)lo, (const long long*)starts, np,
        (const int*)order, nb, cap, (const long long*)total, (int*)out_pr,
        (int*)out_br, (unsigned char*)out_valid);
  }
  return (int)cudaGetLastError();
}

extern "C" int ob_k10_tile_rows() { return K10_TILE; }
