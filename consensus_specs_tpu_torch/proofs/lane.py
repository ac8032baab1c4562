"""The read lane's workload as the JAX package's benches/proof_bench.py
drives it, over the port's resident loop: six uint64 registry columns,
distinct leaf queries spread round-robin over them (so every flush-sized
slice spans every column), served in flushes of 512.

Used by chip_smoke.py (phase 5f) and profile_main_path.py.
"""
from __future__ import annotations

import numpy as np

from .service import leaf_gindex, u64_column_chunks

COLUMNS = ("balances", "effective_balance", "inactivity_scores",
           "activation_epoch", "activation_eligibility_epoch", "exit_epoch")
QUERIES = 2048
FLUSH = 512
SEED = 2302


def build_queries(n_chunks: int, count: int = QUERIES, seed: int = SEED) -> list:
    """proof_bench's `_build_queries`: count // 6 distinct leaves a column
    from RandomState(seed), interleaved column by column."""
    rng = np.random.RandomState(seed)
    per_col = max(1, count // len(COLUMNS))
    picks = {name: rng.choice(n_chunks, size=min(per_col, n_chunks), replace=False)
             for name in COLUMNS}
    queries = []
    for i in range(per_col):
        for name in COLUMNS:
            if i < len(picks[name]):
                queries.append((name, leaf_gindex(int(picks[name][i]), n_chunks)))
    return queries


def column_chunks(loop, name: str) -> list:
    """The 32-byte chunks of one of the loop's columns as it stands: one
    copy of the column to the host."""
    return u64_column_chunks(getattr(loop.state, name).cpu())


def register_loop_columns(service, loop, columns=COLUMNS) -> None:
    """Register providers over the loop's columns with a ProofService: each
    reads its column once a flush."""
    for name in columns:
        service.register_column(name, lambda name=name: column_chunks(loop, name))


def prove_round(service, queries: list, flush: int = FLUSH) -> list:
    """Every query, `flush` at a time (one prove_many a slice); the
    branches in query order."""
    out = []
    for i in range(0, len(queries), flush):
        out.extend(service.prove_many(queries[i:i + flush]))
    return out
