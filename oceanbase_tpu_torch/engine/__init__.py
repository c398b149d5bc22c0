from .executor import Executor, PhysicalParams
from .session import LazyResultSet, ResultSet, Session

__all__ = ["Executor", "LazyResultSet", "PhysicalParams", "ResultSet",
           "Session"]
