"""repro_torch.launch — the serving entry point (``serve --mode join``,
``--mode lm``), the replicated fleet, the latency metrics they share, and
the training loop (``train``)."""
