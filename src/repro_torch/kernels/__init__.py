"""repro_torch.kernels — hand-written Hopper kernels (``csrc/``), each
beside its plain PyTorch version and a wrapper that launches the kernel
for CUDA tensors and runs the plain version for CPU tensors.

    bsearch_probe     bulk binary search into prefix vectors
    tree_probe        the fused USR-GET walk over the packed arena, and its
                      paged forms (tree_probe_paged)
    fused_draw        key -> Poisson positions and rows in one cooperative
                      launch over the card, and fused_sample (the same
                      without the walk)
    prefix_sum        prefix sums: int32 by a single-pass look-back,
                      float32 by a fixed-order reduce-then-scan
    geo_gaps          fused GEO positions (the look-back with a step
                      prologue)
    flash_decode      split-S decode attention with GQA and a bias
    flash_prefill     causal or full flash attention with GQA

``ops`` holds the public wrappers with the reference's signatures and
``ref`` the oracles under the reference's names.
"""
