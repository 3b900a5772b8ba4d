"""repro_torch.core — data model, shredded index, GET and sampling."""
from .relations import Relation, dense_keys, pack_keys
from .database import Database
from .delta import DeltaBatch, RelationDelta
from .jointree import Atom, JoinQuery, gyo_join_tree, is_acyclic, reroot_for
from .shred import (Shred, ShredNode, build_shred, build_plan, PackedShred,
                    PagedArena, pack_arena, pack_index, reshred_incremental,
                    shred_from_arrays)
from .probe import (get, get_rows, csr_get_rows, csr_get_rows_cached,
                    usr_get_rows, usr_get_rows_fused, usr_get_rows_paged)
from .poisson import JoinSample, PoissonSampler
from . import sampling, estimate, yannakakis

__all__ = [
    "Relation", "Database", "DeltaBatch", "RelationDelta", "Atom",
    "JoinQuery", "gyo_join_tree", "is_acyclic", "reroot_for", "Shred",
    "ShredNode", "build_shred", "build_plan", "PackedShred", "PagedArena",
    "pack_arena", "pack_index", "reshred_incremental", "shred_from_arrays",
    "get", "get_rows", "csr_get_rows", "csr_get_rows_cached", "usr_get_rows",
    "usr_get_rows_fused", "usr_get_rows_paged", "sampling", "estimate",
    "yannakakis", "JoinSample", "PoissonSampler", "dense_keys", "pack_keys",
]
