"""Complex real-pair ops, norms and the hand-written CUDA kernels."""
