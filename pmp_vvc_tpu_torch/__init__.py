"""pmp_vvc_tpu_torch — the PyTorch/CUDA port of pmp_vvc_tpu for NVIDIA Hopper.

The JAX package ``pmp_vvc_tpu`` is the reference; this package does the same
work in PyTorch and imports nothing from it. Ported so far: partition-map
prediction (YUV -> Down-Up-CNN -> structural vote -> PartitionMat) and the
map-driven all-intra encode (leaves and wave schedules -> the wave scan on
the card -> CABAC replay, deblocking, SAO, NAL units) in the dual-tree
DCT-2 + deblocking + SAO configuration.

- ``data``   : YUV ingest, CTU blocking with halo, synthetic content (numpy)
- ``models`` : Down-Up-CNN nets (NCHW ``nn.Module``s) and the flax
               msgpack weight bridge
- ``pmp``    : structural vote (hand-written CUDA kernel + plain version),
               batched prediction, map -> partition reconciliation, pipeline
- ``ops``    : intra prediction, transform, quantisation and SATD of the
               wave step (plain versions + the K1/K2/K4 kernels' wrappers)
- ``codec``  : syntax writers, CABAC, loop filters, the frame encoder and
               the wavefront encoder (with the K7 scatter)
- ``native`` : the C CABAC finalizer, built at first use
- ``csrc``   : CUDA C++ kernel sources for sm_90a, built at first use

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
