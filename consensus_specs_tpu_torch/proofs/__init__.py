"""The light-client read lane (copies of the JAX package's proofs/): an
epoch-versioned proof cache and the serving front end over the port's
scheduler. Device work reaches the multiproof kernels (K20, K21) only
through the scheduler's "multiproof" submits."""
from .cache import ProofCache
from .service import ProofService, leaf_gindex, u64_column_chunks

__all__ = ["ProofCache", "ProofService", "leaf_gindex", "u64_column_chunks"]
