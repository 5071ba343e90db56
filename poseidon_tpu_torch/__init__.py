"""poseidon_tpu_torch — the scheduler on PyTorch and CUDA (NVIDIA Hopper).

A port of ``poseidon_tpu`` (the JAX reference, which stays beside it):
the same flow-graph taxonomy, cost models and dense class-price
auction, on PyTorch tensors, with the auction's dense passes as
hand-written CUDA kernels (``kernels/``). The port never imports JAX or
the reference package; its outputs equal the reference's bit for bit.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), where the kernels' plain PyTorch twins
run instead.

Layers:
  graph/     host flow-graph builder, deltas, DIMACS I/O
  models/    vectorized cost models + knowledge base
  kernels/   CUDA kernels K1-K3 with their plain twins and launch counts
  ops/       transport form, dense auction, device-resident round
  oracle/    the C++ CPU MCMF oracle (exact reference solver)
"""

__version__ = "0.1.0"
