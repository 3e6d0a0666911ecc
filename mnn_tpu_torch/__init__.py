"""mnn_tpu_torch: the PyTorch/CUDA port of mnn_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one, with the same module layout. Plain
tensor code is PyTorch; every kernel on the serving path is a CUDA C++
kernel written by hand for sm_90a (`csrc/`), built with nvcc at first use
(`kernels/build.py`). On CPU tensors each kernel wrapper runs its plain
PyTorch version instead. It imports neither jax nor the JAX package `mnn_tpu`.
"""
