"""Runtime plumbing of the port: device selection and the named
host<->device boundaries."""

from .boundary import Boundary, host_boundary
from .device import resolve_device

__all__ = ["Boundary", "host_boundary", "resolve_device"]
