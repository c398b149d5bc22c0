"""Host storage engine: LSM columnar storage feeding the TPU engine.

Layer map (SURVEY.md §2.3 -> rebuild):
  encoding.py    per-column codecs (native C++ + numpy twins)
  microblock.py  self-contained columnar block format
  sstable.py     immutable sorted runs w/ block index, zone maps, bloom
  memtable.py    MVCC mutable head (version chains, staged tx writes)
  scan_merge.py  snapshot fuse of memtables + sstables
  compaction.py  mini/minor/major merges
  tablet.py      the per-shard unit binding all of the above
"""

from .memtable import Memtable, WriteConflict
from .sstable import OP_DELETE, OP_PUT, SSTable, write_sstable
from .scan_merge import scan_merge
from .compaction import freeze_to_mini, major_compact, minor_compact
from .tablet import SnapshotDiscarded, Tablet

__all__ = [
    "Memtable",
    "WriteConflict",
    "SSTable",
    "write_sstable",
    "OP_PUT",
    "OP_DELETE",
    "scan_merge",
    "freeze_to_mini",
    "minor_compact",
    "major_compact",
    "Tablet",
    "SnapshotDiscarded",
]
