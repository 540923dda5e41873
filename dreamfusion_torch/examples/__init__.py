"""Runnable examples of the port (``python -m dreamfusion_torch.examples.<name>``)."""
