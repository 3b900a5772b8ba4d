"""The harness: the manifest, the window, the trace and the judge."""
