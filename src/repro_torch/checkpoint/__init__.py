"""Port of ``repro.checkpoint``."""
