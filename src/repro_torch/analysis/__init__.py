"""Port of ``repro.analysis``."""
