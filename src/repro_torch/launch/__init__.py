"""repro_torch.launch — the serving entry point (``serve --mode join``,
``--mode lm``), the replicated fleet, the latency metrics they share, the
training loop (``train``, data-parallel over a mesh's entries) and the
multi-pod dry run (``dryrun``).

Not ported: ``launch/hlo_cost.py`` parses XLA HLO, which the port never
compiles; ``compat.py`` holds jax version shims, and the port has no
jax."""
