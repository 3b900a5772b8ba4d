"""repro_torch.engine — the query engine over the shredded index."""
from .capacity import CapacityPolicy, DEFAULT_POLICY
from .engine import CacheStats, QueryEngine
from .fingerprint import draw_fingerprint, query_fingerprint, schema_fingerprint
from .plan import CompiledPlan
from .spec import DrawSpec, merge_spec

__all__ = ["QueryEngine", "CacheStats", "CompiledPlan", "CapacityPolicy",
           "DEFAULT_POLICY", "DrawSpec", "merge_spec", "query_fingerprint",
           "schema_fingerprint", "draw_fingerprint"]
