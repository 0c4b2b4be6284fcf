"""Multi-device encoding over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/``: one process per rank
(one card each under NCCL, or processes on the CPU under gloo) in place of
a JAX device mesh.

- ``distributed``: the process-group bootstrap (``initialize``,
  ``shutdown``) and all-intra frame sharding (``process_frame_range``);
- ``wavefront_dp``: the port's mesh (``make_mesh``) and the CU-batch
  sharding of a wave step (``shard_rows``; K12a, used by
  ``codec.wavefront.WavefrontEncoder(mesh=...)``);
- ``comm``: every collective of the package (the step's all-gather, the
  halo send / receive), the one place where the backend matters;
- ``spatial``: the spatial-stripe scan with its halo-exchange kernel
  (K12b, ``csrc/halo.cu``);
- ``dryrun``: the encode half of the JAX package's ``dryrun_multichip``.
"""
from .distributed import initialize, process_frame_range, shutdown
from .wavefront_dp import Mesh, make_mesh, shard_rows

__all__ = ["Mesh", "initialize", "make_mesh", "process_frame_range", "shard_rows",
           "shutdown"]
