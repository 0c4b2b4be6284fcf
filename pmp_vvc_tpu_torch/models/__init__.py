from .checkpoint import (init_params, load_into, load_trained, params_from_jax, params_to_jax,
                         read_flax_msgpack, save_params, write_flax_msgpack)
from .qbd import ChromaMSBDNet, ChromaQNet, LumaMSBDNet, LumaQNet

__all__ = [
    "LumaQNet", "LumaMSBDNet", "ChromaQNet", "ChromaMSBDNet",
    "read_flax_msgpack", "load_trained", "params_from_jax", "load_into",
    "write_flax_msgpack", "save_params", "params_to_jax", "init_params",
]
