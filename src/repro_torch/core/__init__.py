"""Core helpers of the port: error types and device selection."""
from .device import resolve_device
from .errors import GuardError, TileError

__all__ = ["GuardError", "TileError", "resolve_device"]
