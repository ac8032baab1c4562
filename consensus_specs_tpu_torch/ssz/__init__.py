"""SSZ public API of the port (copy of the JAX package's ssz/, whose
compiled specs link against it: see compiler/spec_compiler.py).

Reference parity: eth2spec's ssz_typing re-exports + ssz_impl's four helpers
(tests/core/pyspec/eth2spec/utils/ssz/ssz_impl.py: serialize :8,
hash_tree_root :12, uint_to_bytes :16, copy :24).
"""
from .types import (  # noqa: F401
    Bitlist, Bitvector, ByteList, ByteVector, Bytes1, Bytes4, Bytes8, Bytes20,
    Bytes32, Bytes48, Bytes96, Container, List, SSZType, Union, Vector, boolean,
    byte, uint, uint8, uint16, uint32, uint64, uint128, uint256,
)
from .merkle import (  # noqa: F401
    calc_merkle_tree_from_leaves, get_merkle_proof, get_merkle_root,
    merkleize_chunks, mix_in_length, mix_in_selector, next_power_of_two,
    zerohashes,
)
from .gindex import (  # noqa: F401
    GeneralizedIndex, concat_generalized_indices, generalized_index_child,
    generalized_index_parent, generalized_index_sibling,
    get_generalized_index, get_generalized_index_bit,
    get_generalized_index_length,
)
from .proofs import (  # noqa: F401
    build_chunk_proof,
    build_multiproof,
    build_proof,
    build_proofs,
    calculate_multi_merkle_root,
    get_helper_indices,
    get_subtree_node_root,
    is_valid_merkle_branch,
    verify_multiproof,
)


def serialize(obj) -> bytes:
    return obj.encode_bytes()


def deserialize(typ, data: bytes):
    return typ.decode_bytes(data)


def hash_tree_root(obj) -> Bytes32:
    return Bytes32(obj.hash_tree_root())


def uint_to_bytes(n: uint) -> bytes:
    return n.encode_bytes()


def copy(obj):
    return obj.copy() if hasattr(obj, "copy") else obj
