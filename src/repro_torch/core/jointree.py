"""Join queries, acyclicity (GYO), join trees and rerooting (Prop. 3.1).

A Poisson sampling query is ``Q = beta_y(R1(x1) |><| ... |><| Rl(xl))``
(paper eq. (1)). Queries are data-independent, so everything here is plain
Python executed at plan time. A framework-free copy of the JAX package's
module of the same name, kept here so the port imports nothing from it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["Atom", "JoinQuery", "JoinTreeNode", "gyo_join_tree", "is_acyclic", "reroot_for"]


@dataclasses.dataclass(frozen=True)
class Atom:
    """One occurrence of a relation symbol in the query body.

    ``alias`` distinguishes repeated relation symbols (self joins): the alias
    is the key into the database dict *and* the node identity in the tree.
    ``attrs`` maps the relation's physical column names to query variables,
    i.e. attrs[column] = variable. For convenience ``Atom.of`` builds the
    identity mapping.
    """

    relation: str
    variables: Tuple[str, ...]
    alias: Optional[str] = None

    @property
    def name(self) -> str:
        return self.alias or self.relation

    @staticmethod
    def of(relation: str, *variables: str, alias: str = None) -> "Atom":
        return Atom(relation, tuple(variables), alias)

    def var_set(self) -> frozenset:
        return frozenset(self.variables)


@dataclasses.dataclass(frozen=True)
class JoinQuery:
    """A full join query, optionally with a Poisson-probability variable y."""

    atoms: Tuple[Atom, ...]
    prob_var: Optional[str] = None  # the y attribute of beta_y

    def __post_init__(self):
        names = [a.name for a in self.atoms]
        if len(set(names)) != len(names):
            raise ValueError(f"atom aliases must be unique, got {names}")
        if self.prob_var is not None:
            allv = set().union(*[a.var_set() for a in self.atoms])
            if self.prob_var not in allv:
                raise ValueError(f"prob_var {self.prob_var!r} not in query variables")

    @property
    def variables(self) -> frozenset:
        return frozenset().union(*[a.var_set() for a in self.atoms])


@dataclasses.dataclass
class JoinTreeNode:
    atom: Atom
    children: List["JoinTreeNode"] = dataclasses.field(default_factory=list)

    def nodes(self) -> List["JoinTreeNode"]:
        out = [self]
        for c in self.children:
            out.extend(c.nodes())
        return out

    def pretty(self, indent: int = 0) -> str:
        s = "  " * indent + f"{self.atom.name}({', '.join(self.atom.variables)})\n"
        for c in self.children:
            s += c.pretty(indent + 1)
        return s


def _gyo_parents(query: JoinQuery) -> Optional[Dict[str, Optional[str]]]:
    """GYO ear decomposition. Returns atom-name -> parent-name (root: None),
    or None if the query is cyclic.

    Disjoint atoms (variables shared with no remaining atom) are a
    *deliberately supported* degenerate ear: their ``shared`` set is empty,
    so the cover check ``shared <= o.var_set()`` holds vacuously and the
    atom hangs off an arbitrary (first-remaining, hence deterministic)
    parent via a keyless edge — the join tree of a disconnected acyclic
    query connects its components with cross-product edges, which the shred
    build and both GETs execute as single-group (key 0) children (see
    shred._edge_keys). This cannot mask a cyclic component: an empty
    ``shared`` set means the atom shares *no* variable with any remaining
    atom, and a non-empty ``shared`` set only contains variables of the
    atom's own component, so cross-component elimination never removes an
    atom a cyclic component still needs (tests/test_jointree.py).
    """
    remaining: Dict[str, Atom] = {a.name: a for a in query.atoms}
    parent: Dict[str, Optional[str]] = {}
    changed = True
    while len(remaining) > 1 and changed:
        changed = False
        for name, atom in list(remaining.items()):
            others = [a for n, a in remaining.items() if n != name]
            shared = atom.var_set() & frozenset().union(*[o.var_set() for o in others])
            # atom is an ear if some other atom covers all its shared
            # variables (vacuously true for a disjoint atom: keyless edge)
            for o in others:
                if shared <= o.var_set():
                    parent[name] = o.name
                    del remaining[name]
                    changed = True
                    break
            if changed:
                break
    if len(remaining) != 1:
        return None
    root = next(iter(remaining))
    parent[root] = None
    return parent


def is_acyclic(query: JoinQuery) -> bool:
    """True iff GYO reduces the query to one atom. Disconnected queries are
    acyclic iff every connected component is (cross products supported)."""
    return _gyo_parents(query) is not None


def _tree_from_parents(query: JoinQuery, parent: Dict[str, Optional[str]]) -> JoinTreeNode:
    by_name = {a.name: JoinTreeNode(a) for a in query.atoms}
    root = None
    for name, p in parent.items():
        if p is None:
            root = by_name[name]
        else:
            by_name[p].children.append(by_name[name])
    assert root is not None
    return root


def gyo_join_tree(query: JoinQuery) -> JoinTreeNode:
    """Join tree via GYO; raises ValueError on cyclic queries."""
    parent = _gyo_parents(query)
    if parent is None:
        raise ValueError(f"query is cyclic: {[a.name for a in query.atoms]}")
    return _tree_from_parents(query, parent)


def reroot_for(tree: JoinTreeNode, var: str) -> JoinTreeNode:
    """Proposition 3.1: reroot the join tree at a node mentioning ``var``
    so that the probability attribute is flat at the root of the 2NSA
    expression. Connectedness is preserved under rerooting of a join tree."""
    # Build undirected adjacency.
    nodes = tree.nodes()
    adj: Dict[str, List[str]] = {n.atom.name: [] for n in nodes}
    atom_of = {n.atom.name: n.atom for n in nodes}
    for n in nodes:
        for c in n.children:
            adj[n.atom.name].append(c.atom.name)
            adj[c.atom.name].append(n.atom.name)
    target = None
    for n in nodes:
        if var in n.atom.var_set():
            target = n.atom.name
            break
    if target is None:
        raise ValueError(f"no atom mentions variable {var!r}")
    # BFS orient away from the new root.
    new_nodes = {name: JoinTreeNode(atom_of[name]) for name in adj}
    seen = {target}
    frontier = [target]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    new_nodes[u].children.append(new_nodes[v])
                    nxt.append(v)
        frontier = nxt
    return new_nodes[target]
