"""repro_torch — the PyTorch/CUDA port of the Gleam reproduction.

A second package beside the JAX reference ``repro``; it imports torch
and numpy and nothing of ``repro``.  Two slices so far:

- the fluid flow engine: ``core/engine.py:make_engine("flow", topo)``
  solves on ``core/flowsim_torch.py:TorchFlowSim``, whose max-min
  filling and loss factors are the hand-written Hopper kernels of
  ``kernels/csrc/maxmin.cu``;
- serving a dense LM: ``runtime/serve.py:Server`` (continuous batching,
  behind ``launch/serve.py``) runs ``models/model.py:decode_forward``,
  whose every attention layer is the flash-decode kernel of
  ``kernels/csrc/flash_decode.cu``.

On a CUDA device the kernels run; on the CPU their plain PyTorch
versions (``kernels/ref.py``) do.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
