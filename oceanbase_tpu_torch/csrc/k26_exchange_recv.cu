// K26: the receive half of a PX exchange -- a receiver's rows taken from
// every sender's block, for every column and validity plane in one pass.
//
// Replaces oceanbase_tpu/parallel/exchange.py's collectives: the
// all_to_all of :65 repartition (:101-109; receiver d takes lane d of
// every sender, sender i's rows at offset i * cap), the all_gather of
// :114 broadcast_rows and of px.py:505 _gather_batch (sender i's n rows
// at offset i * n), :127 ring_broadcast_rows (the same layout, one block
// a step of the ring), and :210 bc2host (the all_gather with the mask
// kept on the stripe row % per_host == lane of the receiver's host).
//
// Bound on an H100 (3.35 TB/s): read each received byte once and write it
// once, nsend * rows * element bytes of every plane -- memory bound.
//
// Design: every (plane, sender) pair is one contiguous byte range, from
// the sender's lane to the receiver's offset, so the call is a work list
// of (source, destination, bytes) segments that the wrapper plans
// (kernels.k26_plan): each segment is cut into K26_CHUNK-byte chunks, one
// block a chunk, each block finding its chunk's segment by a binary
// search of the segments' first chunks. A bool plane thus moves as many
// bytes per instruction as an int64 plane, and every plane gets blocks in
// proportion to its bytes. Short chunks, scheduled by the card as blocks
// finish, keep the last wave short (H100 80GB HBM3 at 700 W, bench_k26.py
// at the PX sort's receive: 32 KiB chunks a block 1.110 ms, 64 KiB 1.116,
// a persistent grid over 64 KiB chunks 1.154, torch.cat 1.147). Within a chunk a thread
// copies 16-byte vectors, K26_UNROLL loads in flight before their stores;
// a head and a tail of fewer than 16 bytes go byte by byte. Where source
// and destination disagree mod 16 (a bool plane's lane * rows and
// out_base + s * rows often do), each destination vector is assembled
// from the two aligned source vectors that hold its bytes with funnel
// shifts, never a byte per thread. The stripe mask is applied in the same
// pass: on the mask plane (a byte a row) each byte's row follows from its
// offset, and bytes with row % per_host != host_lane are stored as 0. The
// segment table rides the kernel's parameters up to K26_INLINE entries,
// device memory past that, so any number of planes and senders take one
// launch and the main path uploads nothing.
//
// The first design gave each plane the same blocks and copied an element
// per thread through a type switch (a byte at a time on the bool planes),
// and uploaded the address table on every call: it reached half its bound
// while torch.cat reached 87%.
//
// The shards of a mesh run in threads of one process. When they share a
// card, a receiver reads its senders' buffers where they lie. Shards on
// different cards first bring each foreign block onto the receiver's card
// (a peer copy), and K26 then places it.
#include "ob_common.cuh"

#define K26_THREADS 256
#define K26_CHUNK (32 * 1024)
#define K26_FIELDS 5
#define K26_INLINE 160
#define K26_UNROLL 4

// The segment table: K26_FIELDS int64 entries per segment: the source
// address, the destination address, the bytes, the segment's first chunk
// (chunks numbered over the segments in order), and the destination row
// of the segment's first byte on the striped mask plane (-1: no stripe).
// In `e` when it has at most K26_INLINE entries (t is null), else at t in
// device memory.
struct K26Args {
  long long e[K26_INLINE];
  const long long* t;
  long long nchunks;
  int nseg;
  int per_host;
  int host_lane;
};

__device__ __forceinline__ long long k26_f(const K26Args& a, int s, int f) {
  int i = s * K26_FIELDS + f;
  return a.t != nullptr ? __ldg(a.t + i) : a.e[i];
}

// The 16 bytes of rows row .. row + 15 of the mask plane, each kept only
// where its row % per_host == host_lane.
__device__ __forceinline__ uint4 k26_stripe(uint4 v, long long row,
                                            int per_host, int host_lane) {
  unsigned w[4] = {v.x, v.y, v.z, v.w};
  int m = (int)(row % per_host);
#pragma unroll
  for (int k = 0; k < 16; k++) {
    if (m != host_lane) w[k >> 2] &= ~(0xffu << ((k & 3) * 8));
    m = m + 1 == per_host ? 0 : m + 1;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One byte, striped when row >= 0.
__device__ __forceinline__ void k26_byte(const unsigned char* src,
                                         unsigned char* dst, long long o,
                                         long long row, int per_host,
                                         int host_lane) {
  unsigned char b = __ldg(src + o);
  if (row >= 0 && (row + o) % per_host != host_lane) b = 0;
  dst[o] = b;
}

// len bytes from src to dst by the block; row >= 0: dst is the mask plane
// and its byte 0 is that row.
__device__ __forceinline__ void k26_chunk(const unsigned char* src,
                                          unsigned char* dst, long long len,
                                          long long row, int per_host,
                                          int host_lane) {
  int t = threadIdx.x;
  long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  if (head > len) head = len;
  long long nvec = (len - head) >> 4;
  long long body_end = head + (nvec << 4);
  if (t < head) k26_byte(src, dst, t, row, per_host, host_lane);
  if (body_end + t < len) {
    k26_byte(src, dst, body_end + t, row, per_host, host_lane);
  }
  if (nvec == 0) return;
  const unsigned char* s = src + head;
  uint4* d = (uint4*)(dst + head);
  long long vrow = row >= 0 ? row + head : -1;
  int sh = (int)(reinterpret_cast<uintptr_t>(s) & 15);
  if (sh == 0) {
    const uint4* sv = (const uint4*)s;
    for (long long v = t; v < nvec; v += K26_THREADS * K26_UNROLL) {
      uint4 x[K26_UNROLL];
#pragma unroll
      for (int u = 0; u < K26_UNROLL; u++) {
        long long i = v + (long long)u * K26_THREADS;
        if (i < nvec) x[u] = __ldg(sv + i);
      }
#pragma unroll
      for (int u = 0; u < K26_UNROLL; u++) {
        long long i = v + (long long)u * K26_THREADS;
        if (i < nvec) {
          uint4 y = x[u];
          if (vrow >= 0) y = k26_stripe(y, vrow + 16 * i, per_host, host_lane);
          d[i] = y;
        }
      }
    }
  } else {
    // the aligned source vectors a and a + 1 hold destination vector i's
    // bytes; the last one holds at least one wanted byte, so no read
    // leaves the 16-byte blocks the source range touches
    const uint4* sa = (const uint4*)(s - sh);
    for (long long v = t; v < nvec; v += K26_THREADS * K26_UNROLL) {
      uint4 x[K26_UNROLL], z[K26_UNROLL];
#pragma unroll
      for (int u = 0; u < K26_UNROLL; u++) {
        long long i = v + (long long)u * K26_THREADS;
        if (i < nvec) {
          x[u] = __ldg(sa + i);
          z[u] = __ldg(sa + i + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < K26_UNROLL; u++) {
        long long i = v + (long long)u * K26_THREADS;
        if (i < nvec) {
          uint4 y = ob_funnel16(x[u], z[u], sh);
          if (vrow >= 0) y = k26_stripe(y, vrow + 16 * i, per_host, host_lane);
          d[i] = y;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(K26_THREADS) k26_recv(K26Args a) {
  long long c = blockIdx.x;
  // the segment of chunk c: the last one whose first chunk is <= c
  int lo = 0, hi = a.nseg - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (k26_f(a, mid, 3) <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  long long off = (c - k26_f(a, lo, 3)) * K26_CHUNK;
  long long nb = k26_f(a, lo, 2);
  long long len = nb - off < K26_CHUNK ? nb - off : K26_CHUNK;
  long long row = k26_f(a, lo, 4);
  k26_chunk((const unsigned char*)k26_f(a, lo, 0) + off,
            (unsigned char*)k26_f(a, lo, 1) + off, len,
            row >= 0 ? row + off : -1, a.per_host, a.host_lane);
}

// The work list of a receive (kernels.k26_plan): nseg segments of
// K26_FIELDS entries, from `inl` into the kernel's parameters when there
// are at most K26_INLINE entries (table null), else `table` in device
// memory; nchunks chunks in all, a block each; per_host > 0 with
// host_lane: the stripe of the segments that carry a row.
extern "C" int ob_k26_recv(int nseg, const long long* inl,
                           const void* table, long long nchunks,
                           int per_host, int host_lane, void* stream) {
  if (nseg < 1 || nchunks < 1 || nchunks > 0x7fffffffLL || per_host < 0 ||
      (table == nullptr &&
       (inl == nullptr || (long long)nseg * K26_FIELDS > K26_INLINE))) {
    return (int)cudaErrorInvalidValue;
  }
  K26Args a;
  memset(&a, 0, sizeof(a));
  a.t = (const long long*)table;
  a.nchunks = nchunks;
  a.nseg = nseg;
  a.per_host = per_host > 0 ? per_host : 1;
  a.host_lane = host_lane;
  if (table == nullptr) {
    for (int i = 0; i < nseg * K26_FIELDS; i++) a.e[i] = inl[i];
  }
  k26_recv<<<(unsigned)nchunks, K26_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ob_k26_chunk_bytes() { return K26_CHUNK; }

extern "C" int ob_k26_inline() { return K26_INLINE; }
