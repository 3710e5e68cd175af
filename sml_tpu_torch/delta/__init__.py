from .table import DeltaTable, read_delta, write_delta

__all__ = ["DeltaTable", "read_delta", "write_delta"]
