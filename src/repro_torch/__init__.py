"""repro_torch — the PyTorch/CUDA port of the Gleam reproduction.

A second package beside the JAX reference ``repro``; it imports torch
and numpy and nothing of ``repro``.  This slice ports the fluid flow
engine: ``core/engine.py:make_engine("flow", topo)`` solves on
``core/flowsim_torch.py:TorchFlowSim``, whose max-min filling and
loss factors are the hand-written Hopper kernels of
``kernels/csrc/maxmin.cu`` on a CUDA device and their plain PyTorch
versions (``kernels/ref.py``) on the CPU.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
