"""Attention ops of the port and the CUDA kernels behind them."""
