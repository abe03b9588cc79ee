"""Solver plans (the port's slice of `repro.tuning`): `SolverPlan`, the
per-step decision vector, its lowering to a weight table and its JSON
(de)serialization, and tier-keyed plan banks (`save_bank` / `load_bank`),
which `launch.serve --plan-bank` serves. The search and its objective are
not ported yet."""

from .plans import SolverPlan, load_bank, save_bank

__all__ = ["SolverPlan", "save_bank", "load_bank"]
