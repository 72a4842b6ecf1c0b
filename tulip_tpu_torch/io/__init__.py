"""Problem file ingestion."""

from .mps import read_mps, write_mps

__all__ = ["read_mps", "write_mps"]
