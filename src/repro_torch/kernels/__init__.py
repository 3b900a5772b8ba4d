"""repro_torch.kernels — hand-written Hopper kernels (``csrc/``), each
beside its plain PyTorch version and a wrapper that launches the kernel
for CUDA tensors and runs the plain version for CPU tensors.

    bsearch_probe     bulk binary search into prefix vectors
    tree_probe        the fused USR-GET walk over the packed arena, and its
                      paged forms (tree_probe_paged)
    fused_draw        key -> Poisson positions and rows in one launch, and
                      fused_sample (the same without the walk)
    prefix_sum        reduce-then-scan prefix sums (int32 and float32)
    geo_gaps          fused GEO positions (the scan with a step prologue)
    flash_decode      split-S decode attention with GQA and a bias
    flash_prefill     causal or full flash attention with GQA

``ops`` holds the public wrappers with the reference's signatures and
``ref`` the oracles under the reference's names.
"""
