"""Host-side tools of the port (python -m lc_tpu_torch.tools.<name>)."""
