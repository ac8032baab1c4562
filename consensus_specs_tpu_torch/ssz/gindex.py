"""Generalized indices over SSZ type trees (copy of the JAX package's
ssz/gindex.py).

Reference parity: ssz/merkle-proofs.md — generalized-index definition (:58),
path -> gindex computation (:89-189), and the gindex arithmetic helpers (:190).
A generalized index g addresses the node reached from the root by reading g's
binary digits after the leading 1 (0 = left, 1 = right).
"""
from __future__ import annotations

from .merkle import next_power_of_two
from .types import (
    BYTES_PER_CHUNK, Bitlist, Bitvector, ByteList, ByteVector, Container,
    List, Vector, _is_basic,
)

GeneralizedIndex = int


def get_generalized_index_length(index: GeneralizedIndex) -> int:
    """Depth of a generalized index (log2)."""
    return index.bit_length() - 1


def get_generalized_index_bit(index: GeneralizedIndex, position: int) -> bool:
    """The bit at `position` (0 = deepest / last branch step)."""
    return (index >> position) & 1 == 1


def generalized_index_sibling(index: GeneralizedIndex) -> GeneralizedIndex:
    return index ^ 1


def generalized_index_child(index: GeneralizedIndex, right_side: bool) -> GeneralizedIndex:
    return index * 2 + int(right_side)


def generalized_index_parent(index: GeneralizedIndex) -> GeneralizedIndex:
    return index // 2


def get_power_of_two_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1) if x >= 1 else 1


def concat_generalized_indices(*indices: GeneralizedIndex) -> GeneralizedIndex:
    """Compose path gindices: the node addressed by following i1 then i2 ...
    (ssz/merkle-proofs.md concat_generalized_indices — power-of-two *floor*,
    which strips i's leading 1-bit and appends its path bits to o)."""
    o = 1
    for i in indices:
        floor = get_power_of_two_floor(i)
        o = o * floor + (i - floor)
    return o


def item_length(typ) -> int:
    """Byte length of one element when packed (basic: its size, else one chunk)."""
    if _is_basic(typ):
        return typ.type_byte_length()
    return BYTES_PER_CHUNK


def chunk_count(typ) -> int:
    """Number of data-tree chunks for a type (ssz/merkle-proofs.md:89)."""
    if _is_basic(typ):
        return 1
    if issubclass(typ, (Bitlist, Bitvector)):
        length = typ.LIMIT if issubclass(typ, Bitlist) else typ.LENGTH
        return (length + 255) // 256
    if issubclass(typ, (ByteList, ByteVector)):
        length = typ.LIMIT if issubclass(typ, ByteList) else typ.LENGTH
        return (length + 31) // 32
    if issubclass(typ, (List, Vector)):
        length = typ.LIMIT if issubclass(typ, List) else typ.LENGTH
        return (length * item_length(typ.ELEM_TYPE) + 31) // 32
    if issubclass(typ, Container):
        return len(typ.fields())
    raise TypeError(f"no chunk count for {typ}")


def _elem_type(typ):
    if issubclass(typ, (Bitlist, Bitvector)):
        from .types import boolean
        return boolean
    if issubclass(typ, (ByteList, ByteVector)):
        from .types import uint8
        return uint8
    return typ.ELEM_TYPE


def get_item_position(typ, index_or_field_name) -> tuple[int, int, int]:
    """(chunk_index, start_byte_in_chunk, end_byte_in_chunk) of a child
    (ssz/merkle-proofs.md:97)."""
    if issubclass(typ, (List, Vector, ByteList, ByteVector, Bitlist, Bitvector)):
        index = int(index_or_field_name)
        if issubclass(typ, (Bitlist, Bitvector)):
            # bits pack 256 per chunk
            return index // 256, 0, 32
        size = item_length(_elem_type(typ))
        start = index * size
        return start // BYTES_PER_CHUNK, start % BYTES_PER_CHUNK, start % BYTES_PER_CHUNK + size
    if issubclass(typ, Container):
        names = list(typ.fields().keys())
        pos = names.index(index_or_field_name)
        return pos, 0, item_length(typ.fields()[index_or_field_name])
    raise TypeError(f"cannot navigate into {typ}")


def get_generalized_index(typ, *path) -> GeneralizedIndex:
    """Generalized index of the node addressed by `path` within `typ`
    (ssz/merkle-proofs.md:143). Path elements: field names, element indices,
    or the special '__len__'."""
    root: GeneralizedIndex = 1
    for p in path:
        if p == "__len__":
            if not issubclass(typ, (List, ByteList, Bitlist)):
                raise TypeError(f"__len__ only valid on lists, not {typ}")
            typ = None
            root = root * 2 + 1
            continue
        if issubclass(typ, (List, ByteList, Bitlist)):
            root *= 2  # mix_in_length: data tree is the left child
        pos, _, _ = get_item_position(typ, p)
        base = next_power_of_two(chunk_count(typ))
        root = root * base + pos
        if issubclass(typ, Container):
            typ = typ.fields()[p]
        else:
            typ = _elem_type(typ)
    return root
