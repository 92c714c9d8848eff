"""Small helpers of the port: the registry, and what the entry points
accept as a device and as a configuration."""

from .cfg import as_config
from .device import require_device
from .registry import Registry

__all__ = ["Registry", "as_config", "require_device"]
