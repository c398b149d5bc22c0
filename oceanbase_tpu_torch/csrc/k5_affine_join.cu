// K5: affine (direct-address) inner-join probe with its verify gather.
//
// Replaces oceanbase_tpu/engine/executor.py:4227 _affine_candidates and the
// packed verify gather of the merge-joinable affine branch of _emit_join
// (:2199-2208): when the build side's key column is an affine sequence in
// storage order (key[i] = a0 + stride * i), a probe row's only candidate
// build row is cand = (key - a0) // stride; the join keeps the row when
//   probe_sel & in_range & build_key[candc] == probe_key & build_sel[candc]
// with in_range = off >= 0 & off % stride == 0 & cand < nb and
// candc = clip(cand, 0, nb - 1), and gathers every build payload column and
// validity plane at candc.
//
// Bound on an H100 (3.35 TB/s): it reads the probe sel and writes sel and
// the payload for every probe row; the probe key, the build key, the build
// sel and the payload it reads only at live probe rows. Where the probe
// filter keeps few rows (1.2% of lineitem in Q14) those reads are
// scattered, and each costs a 32-byte sector, not its element width:
// sector bound.
//
// Design: one thread per probe row (grid-stride), one launch per join (at
// most K5_MAX_COLS payload columns). Keys of any integer width are widened
// to int64 before the compare, so an int32 probe key meets an int64 build
// key as jnp's promotion does. A dead probe row reads nothing but its sel
// and writes sel 0 and payload 0: no operator reads a dead row's payload,
// and the plain version does the same, so kernel and plain agree bit for
// bit.
//
// A second entry, ob_k5_probe, serves oceanbase_tpu/engine/executor.py:4240
// _affine_probe (the semi/anti joins against an affine build side): the
// same verified candidate with no payload, written as the int32 match row
// (candc where the join keeps the row, else -1).
#include "ob_common.cuh"

#define K5_THREADS 256
#define K5_MAX_COLS 48

struct K5Args {
  const void* src[K5_MAX_COLS];
  void* dst[K5_MAX_COLS];
  int width[K5_MAX_COLS];
  int ncols;
};

template <typename T>
__device__ __forceinline__ void k5_copy(const void* src, void* dst,
                                        long long r, long long s, bool live) {
  ((T*)dst)[r] = live ? __ldg((const T*)src + s) : (T)0;
}

__global__ void k5_probe(const void* __restrict__ pkey, int pdt,
                         const unsigned char* __restrict__ psel, long long n,
                         long long a0, long long stride, long long nb,
                         const void* __restrict__ bkey, int bdt,
                         const unsigned char* __restrict__ bsel,
                         unsigned char* __restrict__ out_sel, K5Args a) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    bool live = psel[i] != 0;
    long long s = 0;
    unsigned char hit = 0;
    if (live) {
      long long key = ob_ldg_i64(pkey, pdt, i);
      // two's-complement difference, as jnp's int64 subtraction wraps
      long long off =
          (long long)((unsigned long long)key - (unsigned long long)a0);
      // for off < 0 the row is out of range and every candidate clips to
      // row 0, whether the quotient is floored or truncated
      long long cand = off >= 0 ? off / stride : -1;
      bool in_range = off >= 0 && off % stride == 0 && cand < nb;
      s = cand < 0 ? 0 : (cand >= nb ? nb - 1 : cand);
      hit = in_range && ob_ldg_i64(bkey, bdt, s) == key &&
            __ldg(bsel + s) != 0;
    }
    out_sel[i] = hit;
    for (int c = 0; c < a.ncols; c++) {
      switch (a.width[c]) {
        case 1: k5_copy<unsigned char>(a.src[c], a.dst[c], i, s, live); break;
        case 2: k5_copy<unsigned short>(a.src[c], a.dst[c], i, s, live); break;
        case 4: k5_copy<unsigned int>(a.src[c], a.dst[c], i, s, live); break;
        default:
          k5_copy<unsigned long long>(a.src[c], a.dst[c], i, s, live);
          break;
      }
    }
  }
}

// pkey/psel: probe key (dtype code pdt) and sel, n rows. bkey/bsel: build
// key (dtype code bdt) and sel, nb rows. out_sel: bool [n].
// src/dst/width: ncols payload columns (build side, nb rows -> probe side,
// n rows).
extern "C" int ob_k5_affine(const void* pkey, int pdt, const void* psel,
                            long long n, long long a0, long long stride,
                            long long nb, const void* bkey, int bdt,
                            const void* bsel, void* out_sel, int ncols,
                            const void* const* src, void* const* dst,
                            const int* width, int nblocks, void* stream) {
  if (ncols < 0 || ncols > K5_MAX_COLS || stride <= 0 || nb < 1) {
    return (int)cudaErrorInvalidValue;
  }
  K5Args a;
  a.ncols = ncols;
  for (int c = 0; c < ncols; c++) {
    a.src[c] = src[c];
    a.dst[c] = dst[c];
    a.width[c] = width[c];
  }
  k5_probe<<<nblocks, K5_THREADS, 0, (cudaStream_t)stream>>>(
      pkey, pdt, (const unsigned char*)psel, n, a0, stride, nb, bkey, bdt,
      (const unsigned char*)bsel, (unsigned char*)out_sel, a);
  return (int)cudaGetLastError();
}

__global__ void k5_match(const void* __restrict__ pkey, int pdt,
                         const unsigned char* __restrict__ psel, long long n,
                         long long a0, long long stride, long long nb,
                         const void* __restrict__ bkey, int bdt,
                         const unsigned char* __restrict__ bsel,
                         int* __restrict__ match) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    int m = -1;
    if (__ldg(psel + i)) {
      long long key = ob_ldg_i64(pkey, pdt, i);
      long long off =
          (long long)((unsigned long long)key - (unsigned long long)a0);
      long long cand = off >= 0 ? off / stride : -1;
      if (off >= 0 && off % stride == 0 && cand < nb &&
          ob_ldg_i64(bkey, bdt, cand) == key && __ldg(bsel + cand) != 0) {
        m = (int)cand;
      }
    }
    match[i] = m;
  }
}

// The no-payload probe: match int32 [n], candc or -1.
extern "C" int ob_k5_probe(const void* pkey, int pdt, const void* psel,
                           long long n, long long a0, long long stride,
                           long long nb, const void* bkey, int bdt,
                           const void* bsel, void* match, int nblocks,
                           void* stream) {
  if (stride <= 0 || nb < 1 || nb >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  k5_match<<<nblocks, K5_THREADS, 0, (cudaStream_t)stream>>>(
      pkey, pdt, (const unsigned char*)psel, n, a0, stride, nb, bkey, bdt,
      (const unsigned char*)bsel, (int*)match);
  return (int)cudaGetLastError();
}
