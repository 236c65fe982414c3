"""Aggregation (hybrid-ELL SpMM with its CUDA kernel), activations, loss."""
