"""Poisson draws completed in the churn cell's window over its seconds:
``draws_per_s``, under a name of its own so that its bound follows its
own spread."""
from portbench.lib.manifest import HERE, load_module

read = load_module(HERE / "e2e" / "draws_per_s.py").read
