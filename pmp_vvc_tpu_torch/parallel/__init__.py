"""Multi-device encoding, prediction and training over
``torch.distributed``.

The counterpart of the JAX package's ``parallel/``: one process per rank
(one card each under NCCL, or processes on the CPU under gloo) in place of
a JAX device mesh.

- ``distributed``: the process-group bootstrap (``initialize``,
  ``shutdown``), all-intra frame sharding (``process_frame_range``) and a
  rank's own slice of a global batch as its block (``host_shard``);
- ``wavefront_dp``: the port's mesh (``make_mesh``) and the CU-batch
  sharding of a wave step (``shard_rows``; K12a, used by
  ``codec.wavefront.WavefrontEncoder(mesh=...)``);
- ``comm``: every collective of the package (the step's all-gather, the
  halo send / receive, the gradient bucket's ``all_reduce_sum``), the one
  place where the backend matters;
- ``spatial``: the spatial-stripe scan with its halo-exchange kernel
  (K12b, ``csrc/halo.cu``);
- ``dryrun``: the JAX package's ``dryrun_multichip``, its data-parallel
  training step (K12c) and its encodes.

The data-parallel CNN (K12c) lives with the modules it shards:
``pmp.predict.CompPredictor(mesh=...)`` and ``train.trainer``'s steps
(``mesh=``; the bucket kernel in ``ops/dp_generic.py``).
"""
from .comm import all_reduce_sum
from .distributed import host_shard, initialize, process_frame_range, shutdown
from .wavefront_dp import Mesh, make_mesh, shard_rows

__all__ = ["Mesh", "all_reduce_sum", "host_shard", "initialize", "make_mesh",
           "process_frame_range", "shard_rows", "shutdown"]
