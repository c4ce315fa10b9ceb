"""repro_torch — the PyTorch/CUDA port of the Gleam reproduction.

A second package beside the JAX reference ``repro``; it imports torch
and numpy and nothing of ``repro``.  Among its slices:

- the fluid flow engine: ``core/engine.py:make_engine("flow", topo)``
  solves on ``core/flowsim_torch.py:TorchFlowSim``, whose max-min
  filling and loss factors are the hand-written Hopper kernels of
  ``kernels/csrc/maxmin.cu``; ``make_engine("packet", topo)`` runs the
  packet engine on the host;
- the LM stack: serving (``runtime/serve.py:Server`` behind
  ``launch/serve.py`` runs ``models/model.py:decode_forward``, every
  attention layer the flash-decode kernel of
  ``kernels/csrc/flash_decode.cu``), prefill and training of every
  configuration (``launch/steps.py``);
- the serve step on a mesh of ranks (``launch/mesh.py``,
  ``parallel/sharding.py``, ``launch/steps.make_serve_step``): the KV
  cache split along its sequence, each rank's flash-decode partials
  merged by the Gleam collectives of ``core/collectives.py``.

On a CUDA device the kernels run; on the CPU their plain PyTorch
versions (``kernels/ref.py``) do.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
