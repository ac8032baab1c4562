"""Merkle proofs over typed SSZ values (copy of the JAX package's
ssz/proofs.py).

build_proof(value, gindex) produces the sibling path for a generalized index
— the role remerkleable's backing-tree build_proof plays for eth2spec's light
client tests (specs/altair/sync-protocol.md uses such branches:
`is_valid_merkle_branch` checks, FINALIZED_ROOT_INDEX / NEXT_SYNC_COMMITTEE_INDEX).

The value is expanded into a virtual node tree: subtrees beyond the real data
are zero-chunk subtrees (zerohashes), so huge-limit lists stay O(n).
"""
from __future__ import annotations

from .merkle import ZERO_CHUNK, zerohashes
from .types import (
    Bitlist, Bitvector, ByteList, ByteVector, Container, List, Union, Vector,
    _is_basic, _pack_bytes_to_chunks, boolean, uint,
)

# Node model: ("leaf", bytes32) | ("sub", leaves: list[Node], height, offset)
# | ("pair", left: Node, right: Node)


def _leaf(b: bytes):
    return ("leaf", b)


def _sub(leaves, height, offset=0):
    return ("sub", leaves, height, offset)


def _height_for(count: int) -> int:
    from .merkle import next_power_of_two
    return (next_power_of_two(max(count, 1))).bit_length() - 1


def to_node(value):
    """Typed SSZ value -> virtual Merkle node tree (chunk granularity)."""
    from .gindex import chunk_count
    typ = type(value)
    if isinstance(value, (uint, boolean)):
        return _leaf(value.hash_tree_root())
    if isinstance(value, (ByteVector, Bitvector)):
        chunks = [_leaf(c) for c in _pack_bytes_to_chunks(value.encode_bytes())]
        return _sub(chunks, _height_for(chunk_count(typ)))
    if isinstance(value, ByteList):
        chunks = [_leaf(c) for c in _pack_bytes_to_chunks(bytes(value))] if len(value) else []
        data = _sub(chunks, _height_for(chunk_count(typ)))
        return ("pair", data, _leaf(len(value).to_bytes(32, "little")))
    if isinstance(value, Bitlist):
        from .types import _bits_to_bytes
        raw = _bits_to_bytes(value._bits) if len(value) else b""
        chunks = [_leaf(c) for c in _pack_bytes_to_chunks(raw)] if raw else []
        data = _sub(chunks, _height_for(chunk_count(typ)))
        return ("pair", data, _leaf(len(value).to_bytes(32, "little")))
    if isinstance(value, List):
        if _is_basic(typ.ELEM_TYPE):
            raw = b"".join(e.encode_bytes() for e in value)
            leaves = [_leaf(c) for c in _pack_bytes_to_chunks(raw)] if raw else []
        else:
            leaves = [to_node(e) for e in value]
        data = _sub(leaves, _height_for(chunk_count(typ)))
        return ("pair", data, _leaf(len(value).to_bytes(32, "little")))
    if isinstance(value, Vector):
        if _is_basic(typ.ELEM_TYPE):
            raw = b"".join(e.encode_bytes() for e in value)
            leaves = [_leaf(c) for c in _pack_bytes_to_chunks(raw)]
        else:
            leaves = [to_node(e) for e in value]
        return _sub(leaves, _height_for(chunk_count(typ)))
    if isinstance(value, Container):
        leaves = [to_node(getattr(value, n)) for n in typ.fields()]
        return _sub(leaves, _height_for(len(leaves)))
    if isinstance(value, Union):
        inner = _leaf(ZERO_CHUNK) if value.value is None else to_node(value.value)
        return ("pair", inner, _leaf(value.selector.to_bytes(32, "little")))
    raise TypeError(f"cannot build node tree for {typ}")


def node_root(node) -> bytes:
    from ..utils.hash import hash_eth2
    tag = node[0]
    if tag == "leaf":
        return node[1]
    if tag == "pair":
        return hash_eth2(node_root(node[1]) + node_root(node[2]))
    _, leaves, height, offset = node
    if (offset << height) >= len(leaves):
        return zerohashes[height]
    if height == 0:
        return node_root(leaves[offset])
    left = node_root(("sub", leaves, height - 1, offset * 2))
    right = node_root(("sub", leaves, height - 1, offset * 2 + 1))
    return hash_eth2(left + right)


def node_child(node, right: bool):
    tag = node[0]
    if tag == "pair":
        return node[2] if right else node[1]
    if tag == "sub":
        _, leaves, height, offset = node
        if height == 0:
            return node_child(node_deref(node), right)
        return ("sub", leaves, height - 1, offset * 2 + int(right))
    # Leaf chunks have no children. Note this includes the zero-chunk padding
    # of absent composite-list slots: SSZ pads the element level with zero
    # *chunks* (ssz/simple-serialize.md merkleize), not with default-element
    # subtrees, so a gindex below an absent element has no provable subtree.
    raise ValueError(
        "cannot descend below a leaf chunk (gindex points inside a basic "
        "value or an absent zero-padded list slot)"
    )


def node_deref(node):
    """Resolve a height-0 subtree slot to the node occupying it."""
    if node[0] == "sub":
        _, leaves, height, offset = node
        if height == 0:
            return leaves[offset] if offset < len(leaves) else _leaf(ZERO_CHUNK)
    return node


def _branch_for(tree, gindex: int) -> list[bytes]:
    """Sibling walk over an already-expanded node tree, deepest first."""
    if gindex < 1:
        raise ValueError("generalized index must be >= 1")
    bits = [(gindex >> i) & 1 for i in range(gindex.bit_length() - 2, -1, -1)]
    node = tree
    proof: list[bytes] = []
    for b in bits:
        node = node_deref(node)
        sibling = node_child(node, not b)
        proof.append(node_root(sibling))
        node = node_child(node, bool(b))
    return list(reversed(proof))


def build_proof(value, gindex: int) -> list[bytes]:
    """Sibling hashes for `gindex`, ordered leaf-level first (ready for
    is_valid_merkle_branch / light-client update verification)."""
    return _branch_for(to_node(value), gindex)


def build_proofs(value, gindices) -> list[list[bytes]]:
    """Multi-query host entry: one branch per gindex, in input order, all
    walked over ONE shared `to_node` expansion (build_proof re-expands the
    typed value per call). Unlike build_multiproof's helper-set form, the
    branches are independent — duplicate or ancestor/descendant gindices
    are fine — so this is the oracle shape the device multiproof kernel
    pins against."""
    tree = to_node(value)
    return [_branch_for(tree, g) for g in gindices]


def build_chunk_proof(chunks, gindex: int) -> list[bytes]:
    """Branch for `gindex` over a raw 32-byte chunk list merkleized into
    its pow2-padded tree (merkleize_chunks semantics: zero-chunk padding,
    no length mix-in) — the host oracle and sched fallback for the device
    multiproof kernel, which serves exactly such chunk trees (registry
    columns)."""
    leaves = [_leaf(bytes(c)) for c in chunks]
    return _branch_for(_sub(leaves, _height_for(len(leaves))), gindex)


def _node_root_at(node, gindex: int) -> bytes:
    """Root of the node addressed by gindex within an already-built tree."""
    if gindex < 1:
        raise ValueError("generalized index must be >= 1")
    bits = [(gindex >> i) & 1 for i in range(gindex.bit_length() - 2, -1, -1)]
    for b in bits:
        node = node_deref(node)
        node = node_child(node, bool(b))
    return node_root(node)


def get_subtree_node_root(value, gindex: int) -> bytes:
    """Root of the node addressed by gindex (for tests / leaf extraction)."""
    return _node_root_at(to_node(value), gindex)


def is_valid_merkle_branch(leaf: bytes, branch, depth: int, index: int, root: bytes) -> bool:
    """Spec helper (specs/phase0/beacon-chain.md `is_valid_merkle_branch`)."""
    from ..utils.hash import hash_eth2
    value = bytes(leaf)
    for i in range(depth):
        if (index >> i) & 1:
            value = hash_eth2(bytes(branch[i]) + value)
        else:
            value = hash_eth2(value + bytes(branch[i]))
    return value == bytes(root)


# --- multiproofs (reference parity: ssz/merkle-proofs.md multiproof
# section — get_helper_indices / calculate_multi_merkle_root) ---------------


def get_branch_indices(tree_index: int) -> list:
    """Sibling of every node on the path from `tree_index` to the root,
    deepest first."""
    out = []
    while tree_index > 1:
        out.append(tree_index ^ 1)
        tree_index //= 2
    return out


def get_path_indices(tree_index: int) -> list:
    """`tree_index` and its ancestors, up to but excluding the root."""
    out = []
    while tree_index > 1:
        out.append(tree_index)
        tree_index //= 2
    return out


def _check_independent(indices) -> None:
    """Reject ill-formed leaf sets where one requested index is an
    ancestor of another (its subtree already contains the descendant —
    the request is contradictory, not deduplicable)."""
    index_set = set(indices)
    if len(index_set) != len(indices):
        raise ValueError("duplicate generalized indices")
    for g in indices:
        anc = g // 2
        while anc >= 1:
            if anc in index_set:
                raise ValueError(f"index {anc} is an ancestor of {g}")
            anc //= 2


def get_helper_indices(indices) -> list:
    """Minimal helper-node set for a multiproof over `indices`: every
    path sibling not itself derivable from the leaves or other helpers,
    sorted by DESCENDING generalized index (children before parents)."""
    all_helper_indices: set = set()
    all_path_indices: set = set()
    for index in indices:
        all_helper_indices.update(get_branch_indices(index))
        all_path_indices.update(get_path_indices(index))
    return sorted(all_helper_indices - all_path_indices, reverse=True)


def build_multiproof(value, gindices) -> list:
    """Helper-node hashes proving all of `gindices` at once, in
    get_helper_indices order. For a single index this degenerates to
    build_proof's branch, deepest-first. The typed node tree is built
    ONCE and every helper walk shares it."""
    _check_independent(gindices)
    tree = to_node(value)
    return [_node_root_at(tree, h) for h in get_helper_indices(gindices)]


def calculate_multi_merkle_root(leaves, proof, indices) -> bytes:
    """Root implied by (leaves at indices) + (helper hashes): recompute
    every path node bottom-up. A parent is derived the moment both its
    children are known; processing order (descending start keys, derived
    parents appended) guarantees each derivation fires exactly once."""
    from ..utils.hash import hash_eth2

    _check_independent(indices)
    helper_indices = get_helper_indices(indices)
    if len(leaves) != len(indices):
        raise ValueError("leaves/indices length mismatch")
    if len(proof) != len(helper_indices):
        raise ValueError("proof length does not match helper set")
    objects = {
        **{index: bytes(node) for index, node in zip(indices, leaves)},
        **{index: bytes(node) for index, node in zip(helper_indices, proof)},
    }
    keys = sorted(objects.keys(), reverse=True)
    pos = 0
    while pos < len(keys):
        k = keys[pos]
        if k in objects and k ^ 1 in objects and k // 2 not in objects:
            objects[k // 2] = hash_eth2(objects[k & ~1] + objects[k | 1])
            keys.append(k // 2)
        pos += 1
    if 1 not in objects:
        raise ValueError("multiproof does not resolve to a root")
    return objects[1]


def verify_multiproof(leaves, proof, indices, root: bytes) -> bool:
    try:
        return calculate_multi_merkle_root(leaves, proof, indices) == bytes(root)
    except ValueError:
        return False
