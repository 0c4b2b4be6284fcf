"""Intra prediction (angular and MIP), transform, quantization, sign-data
hiding and distortion for the wave path and the sequential encoder (K10a-e),
and the sequential encoder's host dependent quantization, LFNST and CCLM."""
from .distortion import sad, satd, sse

__all__ = ["sad", "satd", "sse"]
