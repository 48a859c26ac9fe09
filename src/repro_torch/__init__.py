"""START on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors ``repro``'s layout and names.  It imports ``torch``
and numpy only: never ``jax`` and nothing of ``repro`` (numpy modules it
needs are copied, not imported), so it runs on a machine without JAX.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.
Asking for CUDA where there is none raises; nothing falls back to the
CPU.  Tests pass ``device="cpu"``, where every kernel wrapper runs its
plain PyTorch version.
"""
