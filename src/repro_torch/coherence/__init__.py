"""Lease coherence on torch: the fabric and its serving adapter."""
