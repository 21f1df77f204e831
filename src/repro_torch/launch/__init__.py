"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``). Import-light: nothing is imported here."""
