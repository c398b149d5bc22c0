"""Cluster management (reference: src/rootserver).

service.py  RootService-lite: bootstrap, DDL orchestration, tablet
            placement / balance reporting.
"""

from .service import RootService

__all__ = ["RootService"]
