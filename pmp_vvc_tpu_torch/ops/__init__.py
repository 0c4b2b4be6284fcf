"""Intra prediction, transform, quantization and distortion for the wave path."""
