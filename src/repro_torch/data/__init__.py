"""Data pipeline: deterministic, resumable, with Poisson sampling over a
join as an engine-native batch source. ``SyntheticLMSource`` waits for the
model half (ROADMAP A.5)."""
from .pipeline import (  # noqa: F401
    PoissonJoinSource, Prefetcher, corpus_delta, make_corpus_db,
)

__all__ = ["PoissonJoinSource", "Prefetcher", "corpus_delta",
           "make_corpus_db"]
