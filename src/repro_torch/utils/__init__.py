"""Port of ``repro.utils``."""
