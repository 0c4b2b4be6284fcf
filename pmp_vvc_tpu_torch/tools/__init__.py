"""Dataset and training tools (``python -m pmp_vvc_tpu_torch.tools.<name>``)."""
