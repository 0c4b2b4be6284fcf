"""Intra prediction (angular and MIP), transform, quantization, sign-data
hiding and distortion for the wave path."""
