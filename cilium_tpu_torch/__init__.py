"""PyTorch/CUDA port of the cilium_tpu verdict engine.

The package mirrors ``cilium_tpu``'s module layout so each counterpart
is easy to find, but imports neither JAX nor anything of ``cilium_tpu``:
the host half (rule API, policy resolution, automaton compiler,
``CompiledPolicy.build``) is carried as its own copy, and the device half
is PyTorch with hand-written CUDA kernels for the byte scans
(``engine/csrc/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without an explicit device they raise.
"""
