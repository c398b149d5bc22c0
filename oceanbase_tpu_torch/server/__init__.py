"""Server layer: the observer analog.

Reference surface: src/observer — the process that binds the SQL engine,
storage, transactions and replication into one service: statement dispatch
(ObMPQuery::process, observer/mysql/obmp_query.cpp:53), DDL, and sessions.

database.py  Database/DbSession: full-statement SQL (DDL + DML + SELECT)
             over a replicated LocalCluster, with the analytic engine
             reading MVCC snapshots marshalled to the device.
"""

from .database import Database, DbSession

__all__ = ["Database", "DbSession"]
