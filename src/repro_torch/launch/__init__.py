"""repro_torch.launch — the serving entry point (``serve --mode join``,
``--mode lm``), the replicated fleet, the latency metrics they share, the
training loop (``train``, data-parallel over a mesh's entries) and the
multi-pod dry run (``dryrun``, its collective bytes counted by
``comm_cost``, the counterpart of the reference's ``launch/hlo_cost.py``).

Not ported: ``compat.py`` holds jax version shims, and the port has no
jax."""
