"""Operator tools of the port (``python -m zkstark_tpu_torch.tools.<name>``)."""
