"""Intra prediction (angular and MIP), transform, quantization, sign-data
hiding and distortion for the wave path and the sequential encoder (K10a-d),
and the sequential encoder's host dependent quantization, LFNST and CCLM."""
