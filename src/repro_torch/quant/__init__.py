"""Port of ``repro.quant``."""
