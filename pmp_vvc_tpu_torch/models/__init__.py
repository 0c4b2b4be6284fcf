from .checkpoint import load_into, load_trained, params_from_jax, read_flax_msgpack
from .qbd import ChromaMSBDNet, ChromaQNet, LumaMSBDNet, LumaQNet

__all__ = [
    "LumaQNet", "LumaMSBDNet", "ChromaQNet", "ChromaMSBDNet",
    "read_flax_msgpack", "load_trained", "params_from_jax", "load_into",
]
