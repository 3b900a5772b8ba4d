"""Fault-tolerant checkpointing (atomic, content-checked, keep-N, async),
the port of ``repro.checkpoint``."""
from .manager import CheckpointManager  # noqa: F401

__all__ = ["CheckpointManager"]
