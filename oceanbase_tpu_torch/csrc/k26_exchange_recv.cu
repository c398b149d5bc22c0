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
// Bound on an H100 (3.35 TB/s): read each received element once and write
// it once, nsend * rows * element bytes of every plane. Memory bound, and
// every access is coalesced: consecutive threads copy consecutive rows of
// one sender's block.
//
// Design: the shards of a mesh run in threads of one process. When they
// share a card, a receiver reads its senders' buffers where they lie:
// one launch per receiver, grid.y over the planes, each block copying
// its plane's rows sender by sender from a device table of (plane,
// sender) addresses, so any number of planes and senders take one
// launch. Shards on different cards first bring each foreign block onto
// the receiver's card (a peer copy), and K26 then places it.
#include "ob_common.cuh"

#define K26_THREADS 256

// grid.y runs over the planes: each block copies its plane's rows of
// every sender, sender by sender (no per-element division).
// table: np * nsend source addresses (plane-major), np destination
// addresses, np element sizes.
__global__ void k26_recv(int np, int nsend, const long long* __restrict__ t,
                         long long rows, long long lane, long long out_base,
                         int mask_plane, int per_host, int host_lane) {
  int c = blockIdx.y;
  const long long* srcs = t + (long long)c * nsend;
  void* dst = (void*)t[(long long)np * nsend + c];
  int esz = (int)t[(long long)np * nsend + np + c];
  bool stripe = c == mask_plane && per_host > 0;
  long long stride = (long long)gridDim.x * blockDim.x;
  long long j0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int s = 0; s < nsend; s++) {
    const void* src = (const void*)srcs[s];
    long long o = out_base + (long long)s * rows;
    for (long long j = j0; j < rows; j += stride) {
      ob_copy_elem(src, dst, esz, lane * rows + j, o + j);
      if (stripe && ((o + j) % per_host) != host_lane) {
        ((unsigned char*)dst)[o + j] = 0;
      }
    }
  }
}

// Receiver side of an exchange: out plane c, rows [out_base + s * rows,
// out_base + (s + 1) * rows), takes rows [lane * rows, (lane + 1) * rows)
// of sender s's plane c. mask_plane >= 0 with per_host > 0 keeps that
// (bool) plane only on rows r with r % per_host == host_lane.
extern "C" int ob_k26_recv(int np, int nsend, const void* table,
                           long long rows, long long lane, long long out_base,
                           int mask_plane, int per_host, int host_lane,
                           int blocks, void* stream) {
  if (np < 1 || np > 65535 || nsend < 1 || rows < 0 || lane < 0 ||
      out_base < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  dim3 grid((unsigned)blocks, (unsigned)np);
  k26_recv<<<grid, K26_THREADS, 0, (cudaStream_t)stream>>>(
      np, nsend, (const long long*)table, rows, lane, out_base, mask_plane,
      per_host, host_lane);
  return (int)cudaGetLastError();
}
