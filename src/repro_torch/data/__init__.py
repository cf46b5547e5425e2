"""The synthetic data pipeline — the port of ``repro.data``."""
