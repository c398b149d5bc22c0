// K4: multi-column row gather -- every column of a batch by one index array.
//
// Replaces oceanbase_tpu/ops/gather.py:54 gather_rows and
// engine/executor.py:99 gather_payload: out[c][r] = col[c][norm(idx[r])]
// for all payload columns (values, validity masks and the sel mask), where
// norm is jnp's gather rule: an index below 0 counts from the end (i + n),
// then the result is clamped to [0, n - 1].
//
// Bound on an H100 (3.35 TB/s): it reads the index array and writes every
// output once, and reads each gathered element once, M * (4 + 2 * sum of
// column widths) bytes -- memory bound. When the index is a sort order over
// a large table the reads are random, and every random read moves a whole
// 32-byte sector (a 64-byte DRAM atom) for the 1-8 bytes it needs: the
// first design read each row's value from each column separately (five
// random reads a row at S1's shape, 31G reads/s, 9.7 ms), as a chain in
// which each column's load waited on the previous column's store.
//
// Design: three paths, chosen without a host read.
//
// - Row image (large sources, random orders). The JAX package packs int32
//   planes 8 to a row (oceanbase_tpu/ops/gather.py:22) so that one TPU row
//   gather fetches every column of a row; on this card the same packing
//   turns one random sector per column into one per row. `k4_pack` reads
//   each column once, in sequence, and writes a row image: each row's
//   columns at fixed byte offsets, widest first (so each is aligned to its
//   width), in a record of 16, 32 or 64 bytes, staged through shared
//   memory and stored as coalesced 16-byte vectors. `k4_gather_image`
//   gives each warp 32 x K4_STRIP bytes of consecutive output rows: it
//   reads their indices as vectors and stages them in shared memory, then
//   the lanes of a record (one, two or four) fetch its 16-byte parts
//   together (ld.global.nc), so each warp load moves whole sectors and
//   none twice; all loads of a lane are issued before any store. The rows
//   park in a shared tile, and each column goes out from it four or eight
//   bytes a thread, so that even a 1-byte column is written in whole
//   128-byte lines. A payload wider than one image (the wrapper's
//   K4_IMAGE_BYTES) splits into several; the wrapper lays the images out
//   (kernels.k4_images).
// - One pass over the rows (`k4_direct`; locally ordered indices: the
//   compaction orders of compact_batch and _dedup_batch, live rows first,
//   each run in row order). Reads are already coalesced there, and an
//   image would add the pack's bytes. One pass over idx for all columns
//   (up to K4_MAX_COLS a launch), rows a block width apart, so that a
//   warp's loads and stores are coalesced; the loads of four columns,
//   whatever their widths, are issued before their stores. (Four
//   consecutive rows a thread with vector stores took 1.594 ms at
//   bench_k4.py's monotone shape against 1.160 for rows a block width
//   apart, on an H100 80GB HBM3 at 700 W: each warp load then strides 4
//   elements.)
// - A pass a column (`k4_columns`; random indices where the image does
//   not pay: smaller sources, fewer rows, two columns half in order).
//   Gathering the columns one after another keeps each column's random
//   reads in L2 (see k4_columns).
//
// The wrapper picks by shape (kernels.k4_route: the gathered bytes times
// (columns - 1) and the source's bytes past cutoffs measured where the
// image starts to pay; enough rows to pay for the pack); elsewhere a pass
// a column runs (one pass for one column). Where the image may pay, a
// probe (`k4_probe`) samples up to K4_PROBE_PAIRS evenly spaced
// neighbouring rows of idx and counts those whose sources lie more than
// `near` rows apart; every later
// launch reads that count and exits at once when its path is not the one
// taken (`k4_path`), as K3's passes skip on the device. The launch that
// does the work sets its path's bit in the state's second word, so a
// check can read back which path ran (kernels.k4_launch with trace).
// Every kernel after the probe runs a grid of as many blocks as the card
// holds at once (each kernel's occupancy, asked of the runtime once),
// which walks over the tiles, so a launch that exits at once costs a few
// microseconds.
#include <mutex>

#include "ob_common.cuh"

#define K4_THREADS 256
#define K4_MAX_COLS 48
// direct path, one pass over the rows (locally ordered indices): rows a
// thread, columns a round (every load of a round before its stores),
// blocks an SM at least. On an H100 80GB HBM3 at 700 W (bench_k4.py's
// monotone shape), one row a thread and 8 blocks took 1.035 ms, four rows
// and no bound 1.067, four rows over each width's columns in turn 1.186.
#define K4_RPT 1
#define K4_DIRECT_COLS 4
#define K4_DIRECT_MINB 8
// direct path, a pass a column (random indices): rows a thread
#define K4_COL_RPT 4
// image path: bytes of image rows a lane loads before its stores, and the
// shared tile they fill (16 KiB); the pack's tile (32 KiB). On an H100
// 80GB HBM3 at 700 W (bench_k4.py), strips of 128 bytes ran S1's gather
// in 3.04 ms against 2.50 for 64 (fewer blocks fit an SM), and a pack
// tile of 16 KiB took 1.26 ms against 1.16 for 32.
#define K4_STRIP 64
#define K4_TILE_CHUNKS (K4_THREADS * K4_STRIP / 16)
#define K4_PACK_CHUNKS 2048
// the paths, and their bits in the state's second word (which did the
// work)
#define K4_IMAGE 1
#define K4_ROWS 2
#define K4_COLUMNS 4

struct K4Direct {
  const void* src[K4_MAX_COLS];
  void* dst[K4_MAX_COLS];
  int width[K4_MAX_COLS];  // 8, 4, 2 or 1
  int ncols;
};

struct K4Image {
  const void* src[K4_MAX_COLS];
  void* dst[K4_MAX_COLS];
  int off[K4_MAX_COLS];    // byte offset in the record, aligned to width
  int width[K4_MAX_COLS];  // 8, 4, 2 or 1, widest first
  int ncols;
};

__device__ __forceinline__ long long k4_norm(long long s, long long n) {
  s = s < 0 ? s + n : s;
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

// The path of a call: `by_shape` where no probe ran (st null), else by the
// probe's count of far pairs in st[0]: the image where far * img_mul >
// pairs * img_num, one pass over the rows where far * far_div <= pairs,
// else a pass a column. A launch of another path exits at once; the one
// taken sets its bit in st[1].
struct K4Rule {
  unsigned long long* st;
  unsigned long long pairs;
  unsigned long long far_div, img_mul, img_num;
  int by_shape;
};

__device__ __forceinline__ int k4_path(const K4Rule& r) {
  if (r.st == nullptr) return r.by_shape;
  unsigned long long far = r.st[0];
  if (far * r.img_mul > r.pairs * r.img_num) return K4_IMAGE;
  return far * r.far_div > r.pairs ? K4_COLUMNS : K4_ROWS;
}

// true when this launch's path is the one taken (its bit set once)
__device__ __forceinline__ bool k4_taken(const K4Rule& r, int path) {
  if (k4_path(r) != path) return false;
  if (r.st != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0) {
    atomicOr(r.st + 1, (unsigned long long)path);
  }
  return true;
}

// The shared tile's 16-byte chunks are XOR-swizzled (chunk c lies at
// c ^ ((c >> 3) & 7), a permutation within each 8 chunks, so 8 lanes
// storing 8 consecutive chunks still hit distinct banks), so that a
// column's values in consecutive rows, read by neighbouring threads,
// spread over the banks. A value never straddles a chunk: it is at most
// 8 bytes, aligned to its width.
__device__ __forceinline__ int k4_swz(int b) {
  return b ^ (((b >> 7) & 7) << 4);
}

// RPT indices of rows r0 .. r0 + RPT - 1, normalized; rows at or past
// r0 + nr read as row 0 (loaded, never stored).
template <int RPT>
__device__ __forceinline__ void k4_load_idx(const int* __restrict__ idx,
                                            long long r0, int nr,
                                            long long n, long long* s) {
  int v[RPT];
  constexpr int AL = RPT >= 4 ? 16 : 4 * RPT;  // the vector's alignment
  if (RPT > 1 && nr == RPT && ((uintptr_t)(idx + r0)) % AL == 0) {
    if (RPT == 2) {
      int2 a = __ldg((const int2*)(idx + r0));
      v[0] = a.x;
      v[1] = a.y;
    } else {
#pragma unroll
      for (int q = 0; q < RPT / 4; q++) {
        int4 a = __ldg((const int4*)(idx + r0) + q);
        v[4 * q] = a.x;
        v[4 * q + 1] = a.y;
        v[4 * q + 2] = a.z;
        v[4 * q + 3] = a.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < RPT; k++) v[k] = k < nr ? __ldg(idx + r0 + k) : 0;
  }
#pragma unroll
  for (int k = 0; k < RPT; k++) s[k] = k4_norm(v[k], n);
}

// ---------------------------------------------------------------------------
// probe: how many of `pairs` evenly spaced neighbouring output rows read
// sources far apart (pair i: rows r - 1 and r = 1 + i * (m - 1) / pairs)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(K4_THREADS)
    k4_probe(const int* __restrict__ idx, long long m, long long n, int near,
             long long pairs, unsigned long long* far) {
  long long i = (long long)blockIdx.x * K4_THREADS + threadIdx.x;
  unsigned f = 0;
  if (i < pairs) {
    long long r = 1 + i * (m - 1) / pairs;
    long long d = k4_norm(__ldg(idx + r), n) - k4_norm(__ldg(idx + r - 1), n);
    f = (d > near || d < -near) ? 1u : 0u;
  }
  f = __reduce_add_sync(OB_FULL_MASK, f);
  if ((threadIdx.x & 31) == 0 && f) atomicAdd(far, (unsigned long long)f);
}

// ---------------------------------------------------------------------------
// direct path
// ---------------------------------------------------------------------------

// RPT rows of one column (rows of the strip a block width apart) into
// 8-byte registers, and back out
template <typename T>
__device__ __forceinline__ void k4_direct_load(const void* src,
                                               const long long* s,
                                               unsigned long long* v) {
  const T* __restrict__ p = (const T*)src;
#pragma unroll
  for (int k = 0; k < K4_RPT; k++) v[k] = __ldg(p + s[k]);
}

template <typename T>
__device__ __forceinline__ void k4_direct_store(void* dst, long long r0,
                                                long long m,
                                                const unsigned long long* v) {
  T* q = (T*)dst;
#pragma unroll
  for (int k = 0; k < K4_RPT; k++) {
    long long r = r0 + (long long)k * K4_THREADS;
    if (r < m) q[r] = (T)v[k];
  }
}

// One pass over the rows for every column, for locally ordered indices:
// strips of K4_RPT * K4_THREADS rows, thread x taking rows x, x + 256,
// ..., so a warp's loads and its stores are coalesced. The columns go
// K4_DIRECT_COLS at a time, whatever their widths: every load of a round
// before its stores.
__global__ void __launch_bounds__(K4_THREADS, K4_DIRECT_MINB)
    k4_direct(const int* __restrict__ idx, long long m, long long n,
              K4Direct a, K4Rule rule) {
  if (!k4_taken(rule, K4_ROWS)) return;
  const long long strip = (long long)K4_RPT * K4_THREADS;
  for (long long t0 = (long long)blockIdx.x * strip; t0 < m;
       t0 += (long long)gridDim.x * strip) {
    long long r0 = t0 + threadIdx.x;
    long long s[K4_RPT];
#pragma unroll
    for (int k = 0; k < K4_RPT; k++) {
      long long r = r0 + (long long)k * K4_THREADS;
      s[k] = r < m ? k4_norm(__ldg(idx + r), n) : 0;
    }
    for (int c = 0; c < a.ncols; c += K4_DIRECT_COLS) {
      unsigned long long v[K4_DIRECT_COLS][K4_RPT];
#pragma unroll
      for (int j = 0; j < K4_DIRECT_COLS; j++) {
        if (c + j >= a.ncols) continue;
        switch (a.width[c + j]) {
          case 8:
            k4_direct_load<unsigned long long>(a.src[c + j], s, v[j]);
            break;
          case 4:
            k4_direct_load<unsigned>(a.src[c + j], s, v[j]);
            break;
          case 2:
            k4_direct_load<unsigned short>(a.src[c + j], s, v[j]);
            break;
          default:
            k4_direct_load<unsigned char>(a.src[c + j], s, v[j]);
            break;
        }
      }
#pragma unroll
      for (int j = 0; j < K4_DIRECT_COLS; j++) {
        if (c + j >= a.ncols) continue;
        switch (a.width[c + j]) {
          case 8:
            k4_direct_store<unsigned long long>(a.dst[c + j], r0, m, v[j]);
            break;
          case 4:
            k4_direct_store<unsigned>(a.dst[c + j], r0, m, v[j]);
            break;
          case 2:
            k4_direct_store<unsigned short>(a.dst[c + j], r0, m, v[j]);
            break;
          default:
            k4_direct_store<unsigned char>(a.dst[c + j], r0, m, v[j]);
            break;
        }
      }
    }
  }
}

// A pass a column, for random indices: column blockIdx.y of the launch.
// The blocks of one column fill the card before the next column's start,
// so each column's random reads have L2 to themselves (gathering every
// column in one pass made them evict each other: [4,1] over 15M random
// rows 0.588 ms, against 0.471 a column at a time, on an H100 80GB HBM3
// at 700 W). K4_COL_RPT rows a thread, a block width apart, all loaded
// before any store.
template <typename T>
__device__ __forceinline__ void k4_column(const int* __restrict__ idx,
                                          long long m, long long n,
                                          const void* src, void* dst) {
  const T* __restrict__ p = (const T*)src;
  T* q = (T*)dst;
  const long long strip = (long long)K4_COL_RPT * K4_THREADS;
  for (long long t0 = (long long)blockIdx.x * strip; t0 < m;
       t0 += (long long)gridDim.x * strip) {
    long long r0 = t0 + threadIdx.x;
    T v[K4_COL_RPT];
#pragma unroll
    for (int k = 0; k < K4_COL_RPT; k++) {
      long long r = r0 + (long long)k * K4_THREADS;
      v[k] = r < m ? __ldg(p + k4_norm(__ldg(idx + r), n)) : (T)0;
    }
#pragma unroll
    for (int k = 0; k < K4_COL_RPT; k++) {
      long long r = r0 + (long long)k * K4_THREADS;
      if (r < m) q[r] = v[k];
    }
  }
}

__global__ void __launch_bounds__(K4_THREADS, K4_DIRECT_MINB)
    k4_columns(const int* __restrict__ idx, long long m, long long n,
               K4Direct a, K4Rule rule) {
  if (!k4_taken(rule, K4_COLUMNS)) return;
  int c = blockIdx.y;
  switch (a.width[c]) {
    case 8:
      k4_column<unsigned long long>(idx, m, n, a.src[c], a.dst[c]);
      break;
    case 4:
      k4_column<unsigned>(idx, m, n, a.src[c], a.dst[c]);
      break;
    case 2:
      k4_column<unsigned short>(idx, m, n, a.src[c], a.dst[c]);
      break;
    default:
      k4_column<unsigned char>(idx, m, n, a.src[c], a.dst[c]);
      break;
  }
}

// ---------------------------------------------------------------------------
// image path
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void k4_pack_col(unsigned char* tb, int rec,
                                            int off, const T* __restrict__ p,
                                            int rows) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows; i += K4_THREADS) {
    *(T*)(tb + k4_swz(i * rec + off)) = __ldg(p + i);
  }
}

// Each block packs tiles of K4_PACK_CHUNKS 16-byte chunks of records:
// every column read in sequence into the shared tile, then the tile out
// as 16-byte vectors.
// A record's bytes past its columns are left as they were in the tile:
// no output reads them.
template <int REC>
__global__ void __launch_bounds__(K4_THREADS)
    k4_pack(long long n, K4Image a, uint4* __restrict__ img, K4Rule rule) {
  constexpr int TR = K4_PACK_CHUNKS * 16 / REC;
  __shared__ uint4 tile[K4_PACK_CHUNKS];
  if (!k4_taken(rule, K4_IMAGE)) return;
  unsigned char* tb = (unsigned char*)tile;
  long long ntiles = (n + TR - 1) / TR;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long r0 = t * TR;
    int rows = (int)min((long long)TR, n - r0);
    for (int c = 0; c < a.ncols; c++) {
      switch (a.width[c]) {
        case 8:
          k4_pack_col(tb, REC, a.off[c],
                      (const unsigned long long*)a.src[c] + r0, rows);
          break;
        case 4:
          k4_pack_col(tb, REC, a.off[c], (const unsigned*)a.src[c] + r0,
                      rows);
          break;
        case 2:
          k4_pack_col(tb, REC, a.off[c],
                      (const unsigned short*)a.src[c] + r0, rows);
          break;
        default:
          k4_pack_col(tb, REC, a.off[c],
                      (const unsigned char*)a.src[c] + r0, rows);
          break;
      }
    }
    __syncthreads();
    int nch = rows * (REC / 16);
    uint4* out = img + r0 * (REC / 16);
    for (int k = threadIdx.x; k < nch; k += K4_THREADS) {
      out[k] = tile[k ^ ((k >> 3) & 7)];
    }
    __syncthreads();
  }
}

template <int W>
struct K4Unit;  // the store unit of a column of width W: 4 or 8 bytes
template <>
struct K4Unit<1> {
  typedef unsigned T;
  typedef unsigned char E;
};
template <>
struct K4Unit<2> {
  typedef unsigned T;
  typedef unsigned short E;
};
template <>
struct K4Unit<4> {
  typedef unsigned T;
  typedef unsigned E;
};
template <>
struct K4Unit<8> {
  typedef unsigned long long T;
  typedef unsigned long long E;
};

// one column of the tile's rows out to dst (the tile's first row):
// V = 4 / W rows a unit for W < 4, one row otherwise; a warp stores 128
// or 256 contiguous bytes
template <int W>
__device__ __forceinline__ void k4_unpack_col(const unsigned char* tb,
                                              int rec, int off, void* dst,
                                              int rows) {
  typedef typename K4Unit<W>::T U;
  typedef typename K4Unit<W>::E E;
  constexpr int V = W >= 4 ? 1 : 4 / W;
  int units = (rows + V - 1) / V;
  for (int u = threadIdx.x; u < units; u += K4_THREADS) {
    int i0 = u * V;
    if (i0 + V <= rows) {
      U w = 0;
#pragma unroll
      for (int j = 0; j < V; j++) {
        w |= (U)(*(const E*)(tb + k4_swz((i0 + j) * rec + off)))
             << (8 * W * j);
      }
      ((U*)dst)[u] = w;
    } else {
      for (int i = i0; i < rows; i++) {
        ((E*)dst)[i] = *(const E*)(tb + k4_swz(i * rec + off));
      }
    }
  }
}

// Warp w of the block fills tile chunks [32 NL w, 32 NL (w + 1)), rows
// [w * WR, (w + 1) * WR) of the tile. It first stages its rows' indices
// (normalized) at the start of that region, RPT a lane with one vector
// load; then load j of lane l fetches chunk l % CH of row j * LR + l / CH,
// so each warp load covers LR whole records (whole sectors, none read
// twice), and lands at chunk 32 NL w + 32 j + l: chunk row * CH + part.
template <int REC>
__global__ void __launch_bounds__(K4_THREADS)
    k4_gather_image(const int* __restrict__ idx, long long m, long long n,
                    const uint4* __restrict__ img, K4Image a,
                    K4Rule rule) {
  constexpr int RPT = K4_STRIP / REC;   // rows a thread
  constexpr int CH = REC / 16;          // 16-byte chunks a row
  constexpr int TR = K4_THREADS * RPT;  // rows a tile
  constexpr int WR = 32 * RPT;          // rows a warp
  constexpr int LR = 32 / CH;           // rows a warp load
  constexpr int NL = K4_STRIP / 16;     // loads a lane
  __shared__ uint4 tile[K4_TILE_CHUNKS];
  if (!k4_taken(rule, K4_IMAGE)) return;
  const unsigned char* tb = (const unsigned char*)tile;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* sidx = (int*)(tile + 32 * NL * w);
  long long ntiles = (m + TR - 1) / TR;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long t0 = t * TR;
    long long r0 = t0 + (long long)w * WR + (long long)lane * RPT;
    int nr = r0 < m ? (int)min((long long)RPT, m - r0) : 0;
    long long s[RPT];
    k4_load_idx<RPT>(idx, r0, nr, n, s);
#pragma unroll
    for (int k = 0; k < RPT; k++) sidx[lane * RPT + k] = (int)s[k];
    __syncwarp();
    int sj[NL];
#pragma unroll
    for (int j = 0; j < NL; j++) sj[j] = sidx[j * LR + lane / CH];
    __syncwarp();
    uint4 v[NL];
#pragma unroll
    for (int j = 0; j < NL; j++) {
      v[j] = __ldg(img + (long long)sj[j] * CH + lane % CH);
    }
#pragma unroll
    for (int j = 0; j < NL; j++) {
      int c = 32 * NL * w + 32 * j + lane;
      tile[c ^ ((c >> 3) & 7)] = v[j];
    }
    __syncthreads();
    int rows = (int)min((long long)TR, m - t0);
    for (int c = 0; c < a.ncols; c++) {
      switch (a.width[c]) {
        case 8:
          k4_unpack_col<8>(tb, REC, a.off[c],
                           (unsigned long long*)a.dst[c] + t0, rows);
          break;
        case 4:
          k4_unpack_col<4>(tb, REC, a.off[c], (unsigned*)a.dst[c] + t0,
                           rows);
          break;
        case 2:
          k4_unpack_col<2>(tb, REC, a.off[c],
                           (unsigned short*)a.dst[c] + t0, rows);
          break;
        default:
          k4_unpack_col<1>(tb, REC, a.off[c], (unsigned char*)a.dst[c] + t0,
                           rows);
          break;
      }
    }
    __syncthreads();
  }
}

static inline long long k4_min(long long a, long long b) {
  return a < b ? a : b;
}

// blocks of K4_THREADS a kernel needs for `work` blocks' worth of rows,
// capped at what the card holds at once: a block past that would start
// only once a resident one had walked all its tiles
static int k4_grid(const void* fn, long long work, int sms) {
  static std::mutex mu;
  static const void* keys[16];
  static int occ[16];
  static int used = 0;
  int o = 0;
  {
    std::lock_guard<std::mutex> g(mu);
    for (int i = 0; i < used; i++) {
      if (keys[i] == fn) o = occ[i];
    }
    if (o == 0) {
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o, fn, K4_THREADS,
                                                        0) != cudaSuccess ||
          o < 1) {
        cudaGetLastError();
        o = 1;
      }
      if (used < 16) {
        keys[used] = fn;
        occ[used++] = o;
      }
    }
  }
  return (int)k4_min(work < 1 ? 1 : work, (long long)sms * o);
}

template <int REC>
static int k4_image_pair(const int* idx, long long m, long long n,
                         const K4Image& a, uint4* img, const K4Rule& rule,
                         int sms, cudaStream_t s) {
  const long long pack_rows = K4_PACK_CHUNKS * 16 / REC;
  const long long gather_rows = K4_THREADS * (K4_STRIP / REC);
  k4_pack<REC><<<k4_grid((const void*)k4_pack<REC>,
                         (n + pack_rows - 1) / pack_rows, sms),
                 K4_THREADS, 0, s>>>(n, a, img, rule);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k4_gather_image<REC>
      <<<k4_grid((const void*)k4_gather_image<REC>,
                 (m + gather_rows - 1) / gather_rows, sms),
         K4_THREADS, 0, s>>>(idx, m, n, img, a, rule);
  return (int)cudaGetLastError();
}

// idx: int32 [m]; src/dst/width: ncols columns, widest first. Images: nimg
// records of rec[i] bytes (16, 32 or 64) at img[i], n records each (n
// below 2^31); image i holds columns [istart[i], istart[i+1]) at byte
// offsets off[] (each aligned to its width, in order). state: 16 bytes,
// the probe's count and the bits of the paths that ran (unused when nimg
// is 0: then the direct path runs a pass a column, or one pass for one
// column). near, pairs, far_div, img_num / img_den: the probe's rule
// (kernels.K4_NEAR, the pairs it samples, K4_FAR_DIV, K4_IMAGE_SHARE:
// the image where far / pairs x (ncols - 1) > img_num / img_den). sms:
// the card's multiprocessor count.
extern "C" int ob_k4_gather(const void* idx, long long m, long long n,
                            int ncols, const void* const* src,
                            void* const* dst, const int* width, int nimg,
                            const int* rec, void* const* img,
                            const int* istart, const int* off, void* state,
                            int near, long long pairs, int far_div,
                            int img_num, int img_den, int sms,
                            void* stream) {
  if (ncols < 1 || n < 1 || m < 1 || sms < 1 || nimg < 0 ||
      (nimg > 0 && (state == nullptr || near < 0 || far_div < 1 ||
                    img_num < 0 || img_den < 1 || pairs < 0 ||
                    pairs > m - 1 || n >= (1LL << 31) || istart[0] != 0 ||
                    istart[nimg] != ncols))) {
    return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < ncols; c++) {
    int w = width[c];
    if ((w != 1 && w != 2 && w != 4 && w != 8) ||
        (c > 0 && w > width[c - 1])) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  K4Rule rule;
  memset(&rule, 0, sizeof(rule));
  rule.by_shape = ncols > 1 ? K4_COLUMNS : K4_ROWS;
  if (nimg > 0) {
    cudaError_t e =
        cudaMemsetAsync(state, 0, 2 * sizeof(unsigned long long), s);
    if (e != cudaSuccess) return (int)e;
    if (pairs > 0) {
      k4_probe<<<(int)((pairs + K4_THREADS - 1) / K4_THREADS), K4_THREADS,
                 0, s>>>((const int*)idx, m, n, near, pairs,
                         (unsigned long long*)state);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    rule.st = (unsigned long long*)state;
    rule.pairs = (unsigned long long)pairs;
    rule.far_div = (unsigned long long)far_div;
    rule.img_mul =
        (unsigned long long)img_den * (unsigned long long)(ncols - 1);
    rule.img_num = (unsigned long long)img_num;
  }
  for (int i = 0; i < nimg; i++) {
    int c0 = istart[i], c1 = istart[i + 1];
    if (c1 - c0 < 1 || c1 - c0 > K4_MAX_COLS) {
      return (int)cudaErrorInvalidValue;
    }
    K4Image a;
    memset(&a, 0, sizeof(a));
    a.ncols = c1 - c0;
    int at = 0;
    for (int j = 0; j < a.ncols; j++) {
      int c = c0 + j;
      a.src[j] = src[c];
      a.dst[j] = dst[c];
      a.width[j] = width[c];
      a.off[j] = off[c];
      if (a.off[j] % a.width[j] != 0 || a.off[j] < at) {
        return (int)cudaErrorInvalidValue;
      }
      at = a.off[j] + a.width[j];
    }
    if (at > rec[i]) return (int)cudaErrorInvalidValue;
    int rc;
    switch (rec[i]) {
      case 16:
        rc = k4_image_pair<16>((const int*)idx, m, n, a, (uint4*)img[i],
                               rule, sms, s);
        break;
      case 32:
        rc = k4_image_pair<32>((const int*)idx, m, n, a, (uint4*)img[i],
                               rule, sms, s);
        break;
      case 64:
        rc = k4_image_pair<64>((const int*)idx, m, n, a, (uint4*)img[i],
                               rule, sms, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  // the direct paths over every column, K4_MAX_COLS a launch: one pass
  // over the rows, and a pass a column (launched where they may be taken)
  bool rows = nimg > 0 || rule.by_shape == K4_ROWS;
  bool cols = nimg > 0 || rule.by_shape == K4_COLUMNS;
  const long long strip = (long long)K4_RPT * K4_THREADS;
  const long long cstrip = (long long)K4_COL_RPT * K4_THREADS;
  int nb = k4_grid((const void*)k4_direct, (m + strip - 1) / strip, sms);
  int nbc = k4_grid((const void*)k4_columns, (m + cstrip - 1) / cstrip, sms);
  for (int l0 = 0; l0 < ncols; l0 += K4_MAX_COLS) {
    int l1 = (int)k4_min(ncols, l0 + K4_MAX_COLS);
    K4Direct a;
    memset(&a, 0, sizeof(a));
    a.ncols = l1 - l0;
    for (int j = l0; j < l1; j++) {
      a.src[j - l0] = src[j];
      a.dst[j - l0] = dst[j];
      a.width[j - l0] = width[j];
    }
    if (rows) {
      k4_direct<<<nb, K4_THREADS, 0, s>>>((const int*)idx, m, n, a, rule);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    if (cols) {
      k4_columns<<<dim3(nbc, a.ncols), K4_THREADS, 0, s>>>((const int*)idx,
                                                           m, n, a, rule);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
