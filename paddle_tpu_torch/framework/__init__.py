"""Framework pieces the serving slice needs: the flag registry subset
and the device rule."""
from .device import resolve_device
from .flags import get_flag, set_flags

__all__ = ["resolve_device", "get_flag", "set_flags"]
