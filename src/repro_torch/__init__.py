"""repro_torch - IDCluster (DAG-compressed XML keyword search) in PyTorch + CUDA.

The port of :mod:`repro` to an NVIDIA H100: plain tensor code in PyTorch,
the fused search kernel hand-written in CUDA C++ (``csrc/``).  It imports
neither ``jax`` nor anything of ``repro``.
"""
