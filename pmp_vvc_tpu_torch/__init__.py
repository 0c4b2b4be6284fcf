"""pmp_vvc_tpu_torch — the PyTorch/CUDA port of pmp_vvc_tpu for NVIDIA Hopper.

The JAX package ``pmp_vvc_tpu`` is the reference; this package does the same
work in PyTorch and imports nothing from it. Ported so far: partition-map
prediction (YUV -> Down-Up-CNN -> structural vote -> PartitionMat).

- ``data``   : YUV ingest, CTU blocking with halo, synthetic content (numpy)
- ``models`` : Down-Up-CNN nets (NCHW ``nn.Module``s) and the flax
               msgpack weight bridge
- ``pmp``    : structural vote (hand-written CUDA kernel + plain version),
               batched prediction, map -> partition reconciliation, pipeline
- ``csrc``   : CUDA C++ kernel sources for sm_90a, built at first use

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
