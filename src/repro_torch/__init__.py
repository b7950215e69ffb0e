"""LIRA on PyTorch and CUDA: the port of ``repro`` (JAX/Pallas) to an NVIDIA
Hopper card.

The package mirrors ``repro``'s module names (``kernels/``, ``core/``,
``configs/``, ``data/``, ``serving/``, ``ckpt/``) so each module's counterpart
is easy to find. It imports torch and numpy only — never jax, never ``repro``.

Entry points take an explicit ``device``. With ``device=None`` they run on
``"cuda"`` and raise when CUDA is absent; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the CPU (what the tests do).
"""
