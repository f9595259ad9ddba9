"""Port of ``repro.optim``."""
