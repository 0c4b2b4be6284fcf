"""Command-line entry points of the port (``python -m pmp_vvc_tpu_torch.cli.<name>``)."""
