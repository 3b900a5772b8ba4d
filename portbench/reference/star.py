"""The join of a root relation and child relations on one key, by plain
torch operations: its size, the rows at any positions, expected Poisson
sample sizes, the snapshots after deltas, and a plain Poisson sampler.

The join's canonical order is the one the program documents: root rows in
row order; under each root row, the first child's rows with its key in
stable row order; under each of those, the next child's rows with the key,
and so on. Because every child joins on the same key value, the rows under
a root row are the cross product of the children's key groups, first
child outermost.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

I64 = torch.int64


class Star:
    """The join of ``atoms`` (relation, variables), the first the root,
    all sharing one key variable, over ``tables`` (relation -> column ->
    1-D tensor, columns in the atoms' variable order)."""

    def __init__(self, tables: Dict[str, Dict[str, torch.Tensor]],
                 atoms: Sequence[Tuple[str, Sequence[str]]], prob_var: str):
        self.atoms = [(r, tuple(v)) for r, v in atoms]
        shared = set(self.atoms[0][1])
        for _, vs in self.atoms[1:]:
            shared &= set(vs)
        if len(shared) != 1:
            raise ValueError(f"a star joins on one key, got {sorted(shared)}")
        self.key = shared.pop()
        self.prob_var = prob_var
        self.tables = {r: dict(tables[r]) for r, _ in self.atoms}
        root, rvars = self.atoms[0]
        self.root_key = self._col(root, rvars, self.key)
        self.p = self._col(root, rvars, prob_var).to(torch.float64)
        dev = self.root_key.device
        n_key = 1 + max(int(self._col(r, vs, self.key).max())
                        if self._rows(r) else 0 for r, vs in self.atoms)
        # each child: its rows sorted by key (stable), group start and size
        self.children = []
        for r, vs in self.atoms[1:]:
            k = self._col(r, vs, self.key)
            order = torch.argsort(k, stable=True)
            deg = torch.bincount(k, minlength=n_key)
            start = torch.cumsum(deg, 0) - deg
            self.children.append((order, start, deg))
        # rows under each root row, and where its block starts
        w = torch.ones_like(self.root_key)
        for _, _, deg in self.children:
            w = w * deg[self.root_key]
        self.w = w
        self.end = torch.cumsum(w, 0)
        self.size = int(self.end[-1]) if w.numel() else 0
        self.n_key = n_key
        self.device = dev

    def _rows(self, rel: str) -> int:
        return next(iter(self.tables[rel].values())).shape[0]

    def _col(self, rel: str, variables, var: str) -> torch.Tensor:
        cols = list(self.tables[rel])
        return self.tables[rel][cols[list(variables).index(var)]]

    # -- sizes -----------------------------------------------------------------
    def expected_k(self) -> float:
        """E[k]: the sum over join rows of their p."""
        return float((self.w.to(torch.float64) * self.p).sum())

    def variance_k(self) -> float:
        """Var[k] of a Poisson sample: the sum of p (1 - p)."""
        return float((self.w.to(torch.float64) * self.p * (1 - self.p)).sum())

    def expected_p_sum(self) -> float:
        """E of the sum of the kept rows' p: the sum over join rows of p^2
        (a row contributes its p with probability p)."""
        return float((self.w.to(torch.float64) * self.p ** 2).sum())

    def variance_p_sum(self) -> float:
        """Var of the sum of the kept rows' p: the sum of p^3 (1 - p)."""
        return float((self.w.to(torch.float64) * self.p ** 3
                      * (1 - self.p)).sum())

    def key_degrees(self) -> List[torch.Tensor]:
        """Each child's number of rows under each root row's key."""
        return [deg[self.root_key] for _, _, deg in self.children]

    # -- rows ----------------------------------------------------------------
    def locate(self, pos: torch.Tensor) -> List[torch.Tensor]:
        """The row of each atom's relation under join positions ``pos``
        (int64, each in [0, size))."""
        pos = pos.to(I64)
        r = torch.searchsorted(self.end, pos, right=True)
        off = pos - (self.end[r] - self.w[r])
        key = self.root_key[r]
        rows = [r]
        inner = self.w[r]
        for order, start, deg in self.children:
            d = deg[key]
            inner = inner // d
            idx = off // inner
            off = off - idx * inner
            rows.append(order[start[key] + idx])
        return rows

    def rows_at(self, pos: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The join's columns (query variables, each from the first atom
        that has it) at positions ``pos``."""
        rows = self.locate(pos)
        out = {}
        for (rel, vs), rr in zip(self.atoms, rows):
            cols = list(self.tables[rel])
            for c, v in zip(cols, vs):
                if v not in out:
                    out[v] = self.tables[rel][c][rr]
        return out

    def variables(self) -> List[str]:
        seen = []
        for _, vs in self.atoms:
            seen += [v for v in vs if v not in seen]
        return seen


def apply_delta(tables: Dict[str, Dict[str, torch.Tensor]],
                spec: Dict[str, dict]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The next snapshot: each named relation's rows not in ``delete`` (row
    indices) in their order, then the ``insert`` rows; the others as they
    are."""
    out = dict(tables)
    for rel, s in spec.items():
        cols = tables[rel]
        n = next(iter(cols.values())).shape[0]
        dev = next(iter(cols.values())).device
        keep = torch.ones(n, dtype=torch.bool, device=dev)
        dele = torch.as_tensor(s.get("delete", []), dtype=I64, device=dev)
        keep[dele] = False
        ins = s.get("insert", {})
        out[rel] = {c: torch.cat([v[keep], torch.as_tensor(ins[c]).to(
            device=dev, dtype=v.dtype)]) if c in ins else v[keep]
            for c, v in cols.items()}
    return out


def poisson_sample(star: Star, gen: torch.Generator,
                   dtype=torch.float64) -> torch.Tensor:
    """One Poisson sample of the join, as sorted join positions: a unit
    Poisson process over the rows' rates -log(1 - p), its arrivals the
    running sum of exponential gaps, each arrival's row kept. Exact in
    float64; ``dtype`` sets the precision of the rates, the running sums
    and the arrivals (a lower one is the controls' sampler)."""
    lam = (-torch.log1p(-star.p)).to(dtype)
    mass = torch.cumsum(star.w.to(dtype) * lam, 0)
    total = float(mass[-1])
    n = int(total + 8 * total ** 0.5 + 64)
    u = torch.rand(n, generator=gen, device=star.device, dtype=torch.float64)
    gaps = (-torch.log1p(-u)).to(dtype)
    arr = torch.cumsum(gaps, 0)
    arr = arr[arr < mass[-1]]
    r = torch.searchsorted(mass, arr, right=True).clamp_max(
        star.w.numel() - 1)
    before = mass[r] - star.w[r].to(dtype) * lam[r]
    off = torch.floor((arr - before) / lam[r]).to(I64)
    off = torch.minimum(off.clamp_min(0), star.w[r] - 1)
    pos = (star.end[r] - star.w[r]) + off
    return torch.unique(pos)
