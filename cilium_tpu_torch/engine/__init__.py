"""Verdict engine: compiled policy → staged tensors → fused verdict step
with hand-written CUDA kernels for the byte scans (``csrc/``)."""
