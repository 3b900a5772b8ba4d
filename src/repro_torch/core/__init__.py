"""repro_torch.core — data model, shredded index, GET and sampling."""
from .relations import Relation, dense_keys
from .database import Database
from .jointree import Atom, JoinQuery, gyo_join_tree, is_acyclic, reroot_for
from .shred import (Shred, ShredNode, build_shred, build_plan, PackedShred,
                    PagedArena, pack_index, shred_from_arrays)
from .probe import (get, get_rows, usr_get_rows, usr_get_rows_fused,
                    usr_get_rows_paged)
from .poisson import JoinSample, PoissonSampler
from . import sampling, estimate, yannakakis

__all__ = [
    "Relation", "Database", "Atom", "JoinQuery", "gyo_join_tree",
    "is_acyclic", "reroot_for", "Shred", "ShredNode", "build_shred",
    "build_plan", "PackedShred", "PagedArena", "pack_index",
    "shred_from_arrays", "get", "get_rows", "usr_get_rows",
    "usr_get_rows_fused", "usr_get_rows_paged", "sampling", "estimate",
    "yannakakis", "JoinSample", "PoissonSampler", "dense_keys",
]
