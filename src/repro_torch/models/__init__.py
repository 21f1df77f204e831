"""The dense decoder family in PyTorch (ported from ``repro.models``)."""
