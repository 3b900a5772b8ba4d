"""repro_torch.launch — the serving entry point (``serve --mode join``),
the replicated fleet and the latency metrics they share."""
