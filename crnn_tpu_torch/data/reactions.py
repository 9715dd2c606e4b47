"""A small reaction-network language for truth models (port of
crnn_tpu/data/reactions.py).

    net = ReactionNetwork(["A", "B", "C", "D", "E"])
    net.add("A <-> B", kf=1.0, kb=1.0)
    net.add("2C -> D + E", kf=0.5)
    rhs = net.rhs()                  # f(t, y (B, ns), k) with k = net.rates()

Each reaction string is parsed once into reactant and product coefficient
columns; the RHS is the mass-action law ``rate_j = k_j * prod_i
y_i^nu_ij``, batched over lanes as the port's truths are
(``data/truth.py``): ``k`` is ``(nr,)`` or per lane ``(B, nr)``.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np
import torch

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.base import autonomous

_TERM = re.compile(r"^\s*(\d*)\s*([A-Za-z]\w*)\s*$")


def _parse_side(side: str, species_index: dict) -> np.ndarray:
    coeffs = np.zeros(len(species_index))
    for term in side.split("+"):
        term = term.strip()
        if not term or term == "0":
            continue
        m = _TERM.match(term)
        if not m:
            raise ValueError(f"cannot parse reaction term {term!r}")
        count = int(m.group(1)) if m.group(1) else 1
        name = m.group(2)
        if name not in species_index:
            raise ValueError(f"unknown species {name!r}")
        coeffs[species_index[name]] += count
    return coeffs


class ReactionNetwork:
    """Mass-action network from 'A + 2B -> C' / 'A <-> B' strings."""

    def __init__(self, species: Sequence[str]):
        self.species = list(species)
        self.index = {s: i for i, s in enumerate(self.species)}
        self._reactants: List[np.ndarray] = []
        self._products: List[np.ndarray] = []
        self._rates: List[float] = []

    def add(self, reaction: str, kf: float = 1.0,
            kb: float = None) -> "ReactionNetwork":
        if "<->" in reaction or "<-->" in reaction:
            lhs, rhs_side = re.split(r"<-+>", reaction)
            self._add_one(lhs, rhs_side, kf)
            self._add_one(rhs_side, lhs, kb if kb is not None else kf)
        else:
            lhs, rhs_side = reaction.split("->")
            if kb is not None:
                raise ValueError("kb given for an irreversible reaction")
            self._add_one(lhs, rhs_side, kf)
        return self

    def _add_one(self, lhs: str, rhs_side: str, k: float) -> None:
        self._reactants.append(_parse_side(lhs, self.index))
        self._products.append(_parse_side(rhs_side, self.index))
        self._rates.append(float(k))

    @property
    def n_reactions(self) -> int:
        return len(self._rates)

    def matrices(self, dtype=torch.float64, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(nu_react (ns, nr), nu_net (ns, nr)) stoichiometry matrices."""
        r, p = self._stoich()
        return (torch.tensor(r, dtype=dtype, device=device),
                torch.tensor(p - r, dtype=dtype, device=device))

    def rates(self, dtype=torch.float64, device="cuda") -> torch.Tensor:
        return torch.tensor(self._rates, dtype=dtype, device=device)

    def _stoich(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.stack(self._reactants, axis=1),
                np.stack(self._products, axis=1))

    def rhs(self):
        """Mass-action RHS ``f(t, y (B, ns), k) -> (B, ns)`` on ``y``'s device
        and dtype. A zero concentration takes the power law itself (no
        log-space shortcut): truth models must be exact at y = 0."""
        r, p = self._stoich()

        @autonomous
        def f(t, y, k):
            nu_react = torch.as_tensor(r, dtype=y.dtype, device=y.device)
            nu_net = torch.as_tensor(p - r, dtype=y.dtype, device=y.device)
            # rate_j = k_j * prod_i y_i^nu_react[i, j]
            powers = torch.where(
                nu_react > 0,
                clip(y, 0.0, float("inf"))[:, :, None] ** nu_react, 1.0)
            return (k * torch.prod(powers, dim=1)) @ nu_net.T

        return f
