"""Shared cluster infrastructure (reference: src/share).

config.py          typed parameter registry + hot reload (DEF_* analog)
schema_service.py  multi-version schema cache (ObMultiVersionSchemaService)
location.py        LS -> leader-node cache w/ refresh (ObLocationService)
metrics.py         sysstat/wait-event/histogram registry (ob_stat_event)
"""

from .config import Config, Param, default_params
from .location import LocationService
from .metrics import Histogram, MetricsRegistry, WaitEvent
from .schema_service import SchemaGuard, SchemaService

__all__ = [
    "Config",
    "Param",
    "default_params",
    "LocationService",
    "SchemaService",
    "SchemaGuard",
    "MetricsRegistry",
    "WaitEvent",
    "Histogram",
]
