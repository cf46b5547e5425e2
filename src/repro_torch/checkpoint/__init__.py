"""Write-through checkpoints — the port of ``repro.checkpoint``."""
