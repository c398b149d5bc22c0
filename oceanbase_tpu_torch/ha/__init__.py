"""High availability & failure handling.

coordinator.py  FailureDetector + LeaderCoordinator (demote sick leaders)
detect.py       NetKeepAlive (peer-death detection) + DetectManager
                (GC of orphaned distributed state)
rebuild.py      replica rebuild from a leader snapshot + log catch-up
                (storage/high_availability migration analog)
"""

from .coordinator import FailureDetector, LeaderCoordinator
from .detect import DetectManager, NetKeepAlive
from .rebuild import RebuildError, RebuildService, rebuild_replica

__all__ = [
    "FailureDetector",
    "LeaderCoordinator",
    "NetKeepAlive",
    "DetectManager",
    "RebuildError",
    "RebuildService",
    "rebuild_replica",
]
