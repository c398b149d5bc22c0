"""IVF-flat vector index: ANN search as a centroid pass, a list gather and
an exact re-rank.

Counterpart of `oceanbase_tpu/storage/vector_index.py` (reference
surface: src/storage/vector_index and the ANN DAS iterators,
src/sql/das/iter/ob_das_vec_*). The index family is IVF-flat, whose
probe is dense algebra:

  build:  k-means over the column. Each iteration assigns every row its
          nearest centroid (kernel K19, a fused distance + argmin) and
          sums each list's rows (kernel K20, row-order segment sums); the
          centroid means and the reseeding of empty lists stay on the
          host, with the reference's own numpy generator, so a build
          draws the reference's initial centroids bit for bit.
  layout: rows permuted list-contiguous (perm), one offset per list.
  probe:  the nprobe nearest lists (kernel K21) -> their contiguous row
          windows -> exact re-rank -> top-k (kernel K22), in
          `engine/executor.py: _emit_vector_topn`.

The index is a derived structure cached like device columns: the
executor rebuilds it when the table version moves
(`Executor.ivf_host`). `ivf_from_arrays` takes an index built elsewhere
(the JAX package's arrays, as numpy) so that a probe can be held to
another build's index exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _device


@dataclass
class IvfSpec:
    """Registration of a vector index on a Table; the built artifact is
    cached in the executor keyed by table version."""

    column: str
    lists: int = 0       # 0 = auto (~sqrt(n), power-of-two clamped)
    nprobe: int = 8


@dataclass
class IvfIndex:
    centroids: np.ndarray   # (L, d) float32
    perm: np.ndarray        # (n,) int32: rows in list-contiguous order
    offsets: np.ndarray     # (L,) int32: start of each list in perm
    lengths: np.ndarray     # (L,) int32
    max_list: int           # static per-list read window
    iterations: int = 0     # k-means update rounds the build ran


def _auto_lists(n: int) -> int:
    L = 1
    while L * L < n:
        L *= 2
    return max(4, min(L, 4096))


def _layout(a: np.ndarray, L: int):
    perm = np.argsort(a, kind="stable").astype(np.int32)
    lengths = np.bincount(a, minlength=L).astype(np.int32)
    offsets = np.concatenate(
        [[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    return perm, offsets, lengths


def build_ivf(x: np.ndarray, lists: int = 0, iters: int = 10,
              seed: int = 0, device=None) -> IvfIndex:
    """k-means build on `device`: the data matrix is uploaded once; each
    iteration's assignment comes back to the host (the fixed-point test)
    and the centroid update runs there, as in the reference."""
    from ..kernels import kmeans_assign, kmeans_update

    dev = _device(device)
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    L = lists or _auto_lists(n)
    L = min(L, n)
    rng = np.random.default_rng(seed)
    cent = x[rng.choice(n, size=L, replace=False)].copy()
    xd = torch.from_numpy(x).to(dev)

    def assign(c):
        a_dev = kmeans_assign(xd, torch.from_numpy(c).to(dev))
        return a_dev, a_dev.cpu().numpy()

    a_dev, a = assign(cent)
    rounds = 0
    for _ in range(iters):
        rounds += 1
        sums, cnt = (v.cpu().numpy() for v in kmeans_update(xd, a_dev, L))
        nonempty = cnt > 0
        cent[nonempty] = (
            sums[nonempty] / cnt[nonempty, None]).astype(np.float32)
        # re-seed empty lists from random rows
        for li in np.nonzero(~nonempty)[0]:
            cent[li] = x[rng.integers(0, n)]
        a_dev, a2 = assign(cent)
        if np.array_equal(a2, a):
            a = a2
            break
        a = a2

    perm, offsets, lengths = _layout(a, L)
    return IvfIndex(
        centroids=cent,
        perm=perm,
        offsets=offsets,
        lengths=lengths,
        max_list=int(lengths.max()) if L else 0,
        iterations=rounds,
    )


def ivf_from_arrays(centroids, perm, offsets, lengths) -> IvfIndex:
    """An IvfIndex over arrays built elsewhere (numpy, the reference's
    dtypes): the same index the probe reads, whatever built it."""
    lengths = np.asarray(lengths, dtype=np.int32)
    return IvfIndex(
        centroids=np.asarray(centroids, dtype=np.float32),
        perm=np.asarray(perm, dtype=np.int32),
        offsets=np.asarray(offsets, dtype=np.int32),
        lengths=lengths,
        max_list=int(lengths.max()) if len(lengths) else 0,
    )


def register_vector_index(catalog, table: str, column: str,
                          lists: int = 0, nprobe: int = 8) -> None:
    """CREATE VECTOR INDEX surface: registers the spec on the Table; the
    executor builds (and version-caches) the artifact on first use."""
    t = catalog[table]
    t.vector_indexes = {
        **getattr(t, "vector_indexes", {}),
        column: IvfSpec(column, lists, nprobe),
    }


def drop_vector_index(catalog, table: str, column: str) -> None:
    t = catalog[table]
    vi = dict(getattr(t, "vector_indexes", {}))
    vi.pop(column, None)
    t.vector_indexes = vi
