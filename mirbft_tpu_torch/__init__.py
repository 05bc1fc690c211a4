"""mirbft_tpu_torch — the Mir-BFT atomic-broadcast framework on PyTorch + CUDA.

The same layers as the JAX package it is ported from, held byte for byte
against it by the tests:

* L1 — the deterministic, single-threaded consensus state machine on the host
  (``statemachine/``, a verbatim copy).
* L2 — the processor layer, whose crypto hot path (cluster-wide waves of
  SHA-256 hash requests) runs as hand-written CUDA kernels on an NVIDIA
  Hopper card (``ops/``, kernels in ``csrc/``), with a plain PyTorch twin of
  each kernel for CPU tensors.
* L3 — the deterministic in-process test engine (``testengine/``), whose
  ``Recording`` drives N replicas through the device hash plane.

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.
"""

__version__ = "0.1.0"
