"""Host-side global string dictionaries.

Strings never reach the TPU: every VARCHAR column is dictionary-encoded at
load/ingest time into int32 codes, with the code->string mapping kept on the
host. Joins and group-bys on strings become integer problems on device.

Reference precedent: OceanBase's per-micro-block dictionary encodings
(storage/blocksstable/encoding/ob_dict_decoder_simd.cpp and
cs_encoding/ob_dict_column_decoder_simd.cpp). The TPU redesign promotes the
dictionary from a block-local compression detail to the *global* physical
representation of the column, because device kernels cannot chase varlen
bytes.

Two dictionary flavors:

- Dictionary: insertion-ordered, codes are arbitrary. O(1) encode.
- SortedDictionary: codes are assigned in lexicographic order so that
  code comparison == string comparison; required when range predicates
  (<, >, BETWEEN, ORDER BY) apply to the column. Built by finalizing an
  unsorted dictionary.
"""

from __future__ import annotations

import numpy as np


class Dictionary:
    """Insertion-ordered string <-> int32 code mapping."""

    __slots__ = ("_values", "_index", "sorted")

    def __init__(self, values: list[str] | None = None, sorted_: bool = False):
        self._values: list[str] = list(values) if values else []
        self._index: dict[str, int] = {v: i for i, v in enumerate(self._values)}
        self.sorted = sorted_

    def __len__(self) -> int:
        return len(self._values)

    def encode_one(self, s: str, add: bool = True) -> int:
        code = self._index.get(s)
        if code is None:
            if not add:
                return -1
            code = len(self._values)
            self._values.append(s)
            self._index[s] = code
            self.sorted = self.sorted and (
                len(self._values) < 2 or self._values[-2] <= s
            )
        return code

    def encode(self, strings, add: bool = True) -> np.ndarray:
        return np.fromiter(
            (self.encode_one(s, add) for s in strings),
            dtype=np.int32,
            count=len(strings),
        )

    def decode_one(self, code: int) -> str:
        return self._values[code]

    def decode(self, codes: np.ndarray) -> list[str]:
        vals = self._values
        return [vals[c] if c >= 0 else None for c in codes]

    def values(self) -> list[str]:
        return list(self._values)

    @staticmethod
    def from_strings_bulk(strings: np.ndarray) -> tuple["Dictionary", np.ndarray]:
        """Vectorized build: unique+inverse in one numpy pass.

        Returns a SORTED dictionary (np.unique sorts) and int32 codes.
        ~100x faster than per-item encode for multi-million-row ingest.
        """
        values, codes = np.unique(np.asarray(strings), return_inverse=True)
        return Dictionary([str(v) for v in values], sorted_=True), codes.astype(
            np.int32
        )

    @staticmethod
    def merge(
        dl: "Dictionary | None", dr: "Dictionary | None"
    ) -> tuple["Dictionary | None", np.ndarray | None, np.ndarray | None]:
        """Common dictionary for combining two dict-encoded columns (set
        operations, cross-table comparisons). Returns (merged, remap_left,
        remap_right); a None remap means codes pass through unchanged."""
        if dr is None or dl is dr:
            return dl, None, None
        if dl is None:
            return dr, None, None
        if dl._values == dr._values:
            return dl, None, None
        merged_vals = sorted(set(dl._values) | set(dr._values))
        merged = Dictionary(merged_vals, sorted_=True)
        lmap = np.fromiter(
            (merged._index[v] for v in dl._values), np.int32, len(dl._values)
        )
        rmap = np.fromiter(
            (merged._index[v] for v in dr._values), np.int32, len(dr._values)
        )
        return merged, lmap, rmap

    def finalize_sorted(self, codes: np.ndarray) -> tuple["Dictionary", np.ndarray]:
        """Return an order-preserving dictionary and remapped codes.

        After this, code order == lexicographic string order, enabling device
        range predicates and ORDER BY directly on codes.
        """
        order = np.argsort(np.asarray(self._values, dtype=object), kind="stable")
        remap = np.empty(len(self._values), dtype=np.int32)
        remap[order] = np.arange(len(self._values), dtype=np.int32)
        new_values = [self._values[i] for i in order]
        d = Dictionary(new_values, sorted_=True)
        return d, remap[codes]
