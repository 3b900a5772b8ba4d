"""The port's own copies of the reference's example runs (the reference's
``examples/`` stays as it is)."""
