"""PyTorch/CUDA port of the ``repro`` serving stack.

The package serves the dense, SSM and MoE (with DeepSeek's latent
attention) model families through the same entry path as the JAX package
(``Router`` → ``ThreadBackend`` or ``ProcessBackend`` → ``ServingEngine``
→ ``Model`` → kernels), over the dense or the paged cache (with prefix
sharing), on an NVIDIA H100 with hand-written CUDA kernels under
``kernels/csrc/`` for prefill attention, decode over the dense ring or the
block table (in the model's dtype or int8), the Mamba2 scan, absorbed MLA
decode and RMSNorm. It
imports ``torch`` and numpy only: never ``jax``, never the ``repro``
package. Weights cross over from the JAX side only as numpy arrays
(``params.from_numpy``).

Entry points default to ``device="cuda"`` and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels (the CPU tests do).
"""
