"""HALCONE core for the PyTorch port: the protocol rules and the array
state layer of the coherence fabric."""
from repro_torch.core import protocol, state  # noqa: F401
