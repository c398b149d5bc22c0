from . import ast, logical, parser, planner

__all__ = ["ast", "logical", "parser", "planner"]
