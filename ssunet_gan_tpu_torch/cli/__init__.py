"""Command-line entry points of the port (``python -m
ssunet_gan_tpu_torch.cli.<name>``)."""
