"""Runtime plumbing of the port: device selection, the named
host<->device boundaries, and the fault-tolerance signals
(:mod:`.fault_tolerance`) the closed remapping loop consumes."""

from .boundary import Boundary, host_boundary
from .device import resolve_device

__all__ = ["Boundary", "host_boundary", "resolve_device"]
