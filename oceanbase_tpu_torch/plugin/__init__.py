"""Plugin surface: external data loaders.

Reference surface: src/plugin — OceanBase's plugin framework whose
north-star-named member is the external Arrow data loader
(ob_external_arrow_data_loader.h): external tables declare a format +
location, and a registered loader materializes batches at scan time.

The rebuild keeps the same two pieces at this engine's scale:
- a LOADER REGISTRY keyed by format name (arrow/parquet/csv built in,
  user-registered loaders join the same dict), and
- CREATE EXTERNAL TABLE ... USING <format> LOCATION '<path>' DDL that
  routes through it into a catalog Table (columnar from the first byte:
  an Arrow column IS the device column after one dtype mapping).
"""

from .external import (  # noqa: F401
    ExternalFormatError,
    load_external,
    register_loader,
    registered_formats,
)
