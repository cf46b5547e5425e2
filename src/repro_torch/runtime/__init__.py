"""Open-loop serving runtime: load generation and trace replay."""
