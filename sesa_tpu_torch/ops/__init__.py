"""Tensor operations of the port; the hand-written CUDA kernels sit behind
``attention.fused_attention_block`` (K1) and ``ff.fused_ff_residual`` (K2)."""
