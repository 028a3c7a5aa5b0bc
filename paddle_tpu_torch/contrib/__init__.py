"""Contrib modules of the port: mixed precision."""
from . import mixed_precision  # noqa: F401
