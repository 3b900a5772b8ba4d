"""repro_torch.kernels — hand-written Hopper kernels (``csrc/``), each
beside its plain PyTorch version and a wrapper that launches the kernel
for CUDA tensors and runs the plain version for CPU tensors."""
