"""Functional NN ops (NCHW) and non-maximum suppression, in PyTorch."""
