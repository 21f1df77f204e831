"""PyTorch/CUDA port of the ``repro`` serving stack.

The package serves the dense model family through the same entry path as
the JAX package (``Router`` → ``ThreadBackend`` → ``ServingEngine`` →
``Model`` → kernels), over the dense or the paged KV cache (with prefix
sharing), on an NVIDIA H100 with hand-written CUDA kernels for prefill
(``kernels/csrc/flash_attention.cu``) and decode over the dense ring or
the block table (``kernels/csrc/decode_attention.cu``,
``kernels/csrc/paged_attention.cu``). It imports ``torch`` and numpy
only: never ``jax``, never the ``repro`` package. Weights cross over from
the JAX side only as numpy arrays (``params.from_numpy``).

Entry points default to ``device="cuda"`` and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels (the CPU tests do).
"""
