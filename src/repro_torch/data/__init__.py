"""Data pipeline: deterministic, resumable, with Poisson sampling over a
join as an engine-native batch source, and ``SyntheticLMSource``'s
pure-random token batches."""
from .pipeline import (  # noqa: F401
    PoissonJoinSource, Prefetcher, SyntheticLMSource, corpus_delta,
    make_corpus_db,
)

__all__ = ["PoissonJoinSource", "Prefetcher", "SyntheticLMSource",
           "corpus_delta", "make_corpus_db"]
