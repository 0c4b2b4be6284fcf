"""pmp_vvc_tpu_torch — the PyTorch/CUDA port of pmp_vvc_tpu for NVIDIA Hopper.

The JAX package ``pmp_vvc_tpu`` is the reference; this package does the same
work in PyTorch and imports nothing from it. Ported so far: partition-map
prediction (YUV -> Down-Up-CNN -> structural vote -> PartitionMat), the
map-driven all-intra encode (leaves and wave schedules -> the wave scan on
the card -> CABAC replay, loop filters, NAL units) with every tool of the
bench configuration, the device RDO, the sequential encoder with every tool
(MRL, ISP and dependent quantization too) and the encode CLI, and training.

- ``data``   : YUV ingest, CTU blocking with halo, synthetic content,
               training labels from partition trees (numpy)
- ``models`` : Down-Up-CNN nets (NCHW ``nn.Module``s) and the flax
               msgpack weight bridge
- ``pmp``    : structural vote (hand-written CUDA kernel + plain version),
               batched prediction, map -> partition reconciliation, pipeline
- ``ops``    : intra prediction, transform, quantisation and SATD of the
               wave step and of the sequential encoder (plain versions +
               the kernels' wrappers), dependent quantization, LFNST, CCLM
- ``codec``  : syntax writers, CABAC and its rate estimator, loop filters,
               the sequential frame encoder and the wavefront encoder
               (with the K7 scatter)
- ``cli``    : ``encode`` (both engines) and ``train``; ``utils``: VTM cfg
               files, bin statistics, recon summaries
- ``train``  : the training losses, the three stages' steps (with the K11a
               loss and K11b Adam kernels of ``ops/train_generic.py``) and
               the driver; ``cli/train.py`` and ``tools/`` (labels from the
               device RDO, the bd + qbd stages) are their entry points
- ``native`` : the C CABAC finalizer, built at first use
- ``csrc``   : CUDA C++ kernel sources for sm_90a, built at first use

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
