"""VVC codec: host syntax writers, loop filters and the wave-path encoder."""
