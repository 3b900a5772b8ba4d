"""repro_torch.kernels — hand-written Hopper kernels (``csrc/``), each
beside its plain PyTorch version and a wrapper that launches the kernel
for CUDA tensors and runs the plain version for CPU tensors.

    bsearch_probe     bulk binary search into prefix vectors, by tiles
                      of queries (the GET's search of one vector)
    tree_probe        the fused USR-GET walk over the packed arena, and its
                      paged forms (tree_probe_paged)
    fused_draw        key -> Poisson positions and rows in one cooperative
                      launch over the card, and fused_sample (the same
                      without the walk)
    prefix_sum        prefix sums: int32 by a single-pass look-back (no
                      reset a call), float32 by a fixed-order
                      reduce-then-scan
    geo_gaps          fused GEO positions (the look-back with a step
                      prologue)
    flash_decode      split-S decode attention with GQA and a bias
    flash_prefill     causal or full flash attention with GQA
    csr_walk          the CSR GET's chain walk over one tree edge, from
                      each head or resuming along runs of equal heads

``ops`` holds the public wrappers with the reference's signatures and
``ref`` the oracles under the reference's names; ``ab`` times the search
and scan wrappers of this checkout against another's on the card.
"""
