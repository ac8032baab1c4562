"""SSZ type zoo: basic and composite SimpleSerialize types (the port's copy of
the JAX package's ssz/types.py).

Built from the SSZ spec rules (reference: ssz/simple-serialize.md — serialization
:105-187, deserialization :188, merkleization :210-249) as a from-scratch type
system playing the role remerkleable plays for eth2spec
(tests/core/pyspec/eth2spec/utils/ssz/ssz_typing.py re-exports). Values are
plain mutable Python objects; Merkleization batches whole levels through the
native pair hasher (ssz/merkle.py).

Type zoo: uintN (8..256), boolean, Container, Vector[T, N], List[T, N],
Bitvector[N], Bitlist[N], ByteVector[N], ByteList[N], Union[...].
"""
from __future__ import annotations

import weakref
from typing import Any, Sequence

from .merkle import IncrementalTree, merkleize_chunks, mix_in_length, mix_in_selector

BYTES_PER_CHUNK = 32
OFFSET_BYTE_LENGTH = 4

# ---------------------------------------------------------------------------
# Incremental-Merkleization mutation tracking (remerkleable's structural-
# sharing role, eth2spec/utils/ssz/ssz_typing.py:4-9). Every mutable
# composite caches its hash_tree_root and records weak links to the parents
# holding it; any mutation invalidates the chain of caches up to the root,
# and sequences additionally record WHICH chunk went stale so their
# IncrementalTree rehashes only the dirty paths. Invariant maintained
# throughout: if a value's root cache is empty, every ancestor's cache is
# empty too — so invalidation walks stop at the first already-empty cache.
# ---------------------------------------------------------------------------

# sequences with at least this many chunks keep a materialized IncrementalTree;
# smaller ones just re-merkleize their (element-cached) chunks on demand
_TREE_MIN_CHUNKS = 32


def _attach(child, parent, chunk_index: int) -> None:
    """Record `parent` as holding `child` with the child's root feeding the
    parent's chunk `chunk_index` (sequences use it for dirty marking;
    containers ignore it). Weak links: a dropped parent must not be kept
    alive by its former children."""
    if isinstance(child, _TRACKED_TYPES):
        entries = child.__dict__.get("_parents")
        if entries is None:
            object.__setattr__(child, "_parents", [(weakref.ref(parent), chunk_index)])
            return
        # single pass: prune dead weakrefs, detect an existing identical link
        # (re-attachment is common — field reassignment, slice refresh — and
        # duplicates would make every future invalidation walk them all)
        found = False
        w = 0
        for entry in entries:
            p = entry[0]()
            if p is None:
                continue
            entries[w] = entry
            w += 1
            if p is parent and entry[1] == chunk_index:
                found = True
        del entries[w:]
        if not found:
            entries.append((weakref.ref(parent), chunk_index))


def _mark_dirty(obj) -> None:
    """Clear root caches from `obj` up through every live parent chain,
    recording dirty chunk indices on sequence parents along the way."""
    stack = [obj]
    while stack:
        o = stack.pop()
        if o.__dict__.get("_root_cache") is None:
            continue  # invariant: ancestors are already invalidated
        object.__setattr__(o, "_root_cache", None)
        for ref, idx in o.__dict__.get("_parents", ()):
            p = ref()
            if p is None:
                continue
            if isinstance(p, _Sequence):
                p._note_dirty_chunk(idx)
            stack.append(p)


def _pack_le_blob(arr, size: int) -> bytes:
    """Little-endian byte blob of a numpy column, zero-padded to a chunk
    multiple — the single packing rule shared by from_numpy's tree seeding
    and the cold-build fast path."""
    import numpy as np

    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    blob = np.ascontiguousarray(arr).astype(f"<u{size}", copy=False).tobytes()
    if len(blob) % BYTES_PER_CHUNK:
        blob += b"\x00" * (BYTES_PER_CHUNK - len(blob) % BYTES_PER_CHUNK)
    return blob


def _batch_container_roots(elems, typ) -> list | None:
    """Vectorized hash_tree_root for a homogeneous batch of FIXED-SIZE
    containers whose fields are uints/booleans/ByteVectors (<= 2 chunks
    per field) — the Validator shape. Field columns pack via numpy/C-level
    joins and every tree level hashes in ONE `hash_pairs_blob` call across
    the whole batch, replacing len(elems) Python merkleizations (the cold
    1M-validator registry build's dominant cost). Returns None when the
    shape doesn't qualify (caller falls back to per-element roots).

    Also CACHES each element's root: the incremental-merkleization
    invariant requires every element under a built tree to carry a valid
    root cache."""
    import numpy as np

    from .merkle import hash_pairs_blob

    n = len(elems)
    if n < 256 or not (isinstance(typ, type) and issubclass(typ, Container)):
        return None
    if not typ.is_fixed_size():
        return None
    fields = typ.fields()
    if len(fields) > 32:
        return None
    _np_dtypes = {1: "<u1", 2: "<u2", 4: "<u4", 8: "<u8"}
    cols = []
    for name, ft in fields.items():
        col = np.zeros((n, BYTES_PER_CHUNK), dtype=np.uint8)
        if issubclass(ft, (uint, boolean)):
            size = ft.type_byte_length()
            if size not in _np_dtypes:
                return None  # uint128/uint256: no numpy dtype
            arr = np.fromiter(
                (getattr(e, name) for e in elems), dtype=_np_dtypes[size], count=n)
            col[:, :size] = arr.view(np.uint8).reshape(n, size)
        elif issubclass(ft, ByteVector):
            length = ft.LENGTH
            blob = b"".join(getattr(e, name) for e in elems)
            raw = np.frombuffer(blob, dtype=np.uint8).reshape(n, length)
            if length <= BYTES_PER_CHUNK:
                col[:, :length] = raw
            elif length <= 2 * BYTES_PER_CHUNK:
                wide = np.zeros((n, 2 * BYTES_PER_CHUNK), dtype=np.uint8)
                wide[:, :length] = raw
                col = np.frombuffer(
                    hash_pairs_blob(wide.tobytes()), dtype=np.uint8).reshape(n, 32)
            else:
                return None
        else:
            return None
        cols.append(col)
    # (n, F, 32) with F padded to the next power of two by zero chunks
    F = 1 if len(cols) <= 1 else 1 << (len(cols) - 1).bit_length()
    mat = np.zeros((n, F, BYTES_PER_CHUNK), dtype=np.uint8)
    for k, col in enumerate(cols):
        mat[:, k, :] = col
    while F > 1:
        out = hash_pairs_blob(mat.tobytes())
        F //= 2
        mat = np.frombuffer(out, dtype=np.uint8).reshape(n, F, BYTES_PER_CHUNK)
    roots = [mat[i, 0].tobytes() for i in range(n)]
    for e, r in zip(elems, roots):
        object.__setattr__(e, "_root_cache", r)
    return roots


def _copy_merkle_state(src, dst) -> None:
    """Carry cached merkle state from `src` to its fresh copy `dst`: same
    content means same root, and the IncrementalTree clones (it is mutated
    in place, so it must not be shared)."""
    d = src.__dict__
    cached = d.get("_root_cache")
    if cached is not None:
        object.__setattr__(dst, "_root_cache", cached)
    tree = d.get("_tree")
    if tree is not None:
        object.__setattr__(dst, "_tree", tree.clone())
        if d.get("_structural"):
            object.__setattr__(dst, "_structural", True)
        dirty = d.get("_dirty")
        if dirty:
            object.__setattr__(dst, "_dirty", set(dirty))


class SSZType:
    """Mixin namespace for class-level SSZ protocol methods.

    Concrete types implement:
      is_fixed_size() -> bool
      type_byte_length() -> int            (fixed-size types only)
      min_byte_length() / max_byte_length()
      default() -> value
      coerce(v) -> value
      decode_bytes(data: bytes) -> value   (validating deserialization)
    Instances implement:
      encode_bytes() -> bytes
      hash_tree_root() -> bytes (32)
    """

    @classmethod
    def is_fixed_size(cls) -> bool:
        raise NotImplementedError

    @classmethod
    def type_byte_length(cls) -> int:
        raise NotImplementedError

    @classmethod
    def default(cls):
        raise NotImplementedError

    @classmethod
    def coerce(cls, v):
        raise NotImplementedError

    @classmethod
    def decode_bytes(cls, data: bytes):
        raise NotImplementedError

    def __deepcopy__(self, memo):
        """Route copy.deepcopy through .copy(): the default deepcopy would
        clone `_parents` weakref entries (which deepcopy atomically, still
        pointing at the ORIGINAL ancestors) together with the cached merkle
        state — so a mutation on the copy would invalidate the original's
        caches and leave the copy's root STALE. .copy() rebuilds the
        parent links and clones the merkle state correctly."""
        new = self.copy()
        memo[id(self)] = new
        return new


def _pack_bytes_to_chunks(data: bytes) -> list[bytes]:
    """Right-pad to a chunk multiple and split (spec `pack`)."""
    if len(data) % BYTES_PER_CHUNK != 0:
        data = data + b"\x00" * (BYTES_PER_CHUNK - len(data) % BYTES_PER_CHUNK)
    return [data[i:i + BYTES_PER_CHUNK] for i in range(0, len(data), BYTES_PER_CHUNK)] or []


# ---------------------------------------------------------------------------
# Basic types
# ---------------------------------------------------------------------------

class uint(int, SSZType):
    BYTE_LEN: int = 0  # overridden

    def __new__(cls, value: int = 0):
        value = int(value)
        if not 0 <= value < (1 << (cls.BYTE_LEN * 8)):
            raise ValueError(f"{cls.__name__} out of range: {value}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_size(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.BYTE_LEN

    @classmethod
    def default(cls):
        return cls(0)

    @classmethod
    def coerce(cls, v):
        if isinstance(v, bool):
            raise TypeError(f"cannot coerce bool to {cls.__name__}")
        if isinstance(v, int):
            return cls(v)
        raise TypeError(f"cannot coerce {type(v).__name__} to {cls.__name__}")

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) != cls.BYTE_LEN:
            raise ValueError(f"{cls.__name__}: expected {cls.BYTE_LEN} bytes, got {len(data)}")
        return cls(int.from_bytes(data, "little"))

    def encode_bytes(self) -> bytes:
        return int(self).to_bytes(self.BYTE_LEN, "little")

    def hash_tree_root(self) -> bytes:
        return int(self).to_bytes(self.BYTE_LEN, "little") + b"\x00" * (32 - self.BYTE_LEN)

    def copy(self):
        return self

    # Range-checked arithmetic closed over the operand's type (mirrors
    # remerkleable semantics the executable spec relies on: Slot + 1 is a
    # Slot; overflow/underflow raises instead of silently wrapping).
    def _wrap(self, value: int):
        return type(self)(value)

    def __add__(self, o): return self._wrap(int(self) + int(o))
    def __radd__(self, o): return self._wrap(int(o) + int(self))
    def __sub__(self, o): return self._wrap(int(self) - int(o))
    def __rsub__(self, o): return self._wrap(int(o) - int(self))
    def __mul__(self, o): return self._wrap(int(self) * int(o))
    def __rmul__(self, o): return self._wrap(int(o) * int(self))
    def __floordiv__(self, o): return self._wrap(int(self) // int(o))
    def __rfloordiv__(self, o): return self._wrap(int(o) // int(self))
    def __mod__(self, o): return self._wrap(int(self) % int(o))
    def __rmod__(self, o): return self._wrap(int(o) % int(self))
    def __pow__(self, o, mod=None): return self._wrap(pow(int(self), int(o), mod))
    def __lshift__(self, o): return self._wrap(int(self) << int(o))
    def __rshift__(self, o): return self._wrap(int(self) >> int(o))
    def __and__(self, o): return self._wrap(int(self) & int(o))
    def __or__(self, o): return self._wrap(int(self) | int(o))
    def __xor__(self, o): return self._wrap(int(self) ^ int(o))
    def __invert__(self): return self._wrap((1 << (self.BYTE_LEN * 8)) - 1 - int(self))


class uint8(uint):
    BYTE_LEN = 1


class uint16(uint):
    BYTE_LEN = 2


class uint32(uint):
    BYTE_LEN = 4


class uint64(uint):
    BYTE_LEN = 8


class uint128(uint):
    BYTE_LEN = 16


class uint256(uint):
    BYTE_LEN = 32


byte = uint8


class boolean(int, SSZType):
    def __new__(cls, value=False):
        value = int(value)
        if value not in (0, 1):
            raise ValueError(f"boolean must be 0 or 1, got {value}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_size(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return 1

    @classmethod
    def default(cls):
        return cls(False)

    @classmethod
    def coerce(cls, v):
        if isinstance(v, (bool, int)):
            return cls(v)
        raise TypeError(f"cannot coerce {type(v).__name__} to boolean")

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) != 1:
            raise ValueError("boolean: expected 1 byte")
        if data[0] not in (0, 1):
            raise ValueError(f"boolean: invalid byte {data[0]}")
        return cls(data[0])

    def encode_bytes(self) -> bytes:
        return bytes([int(self)])

    def hash_tree_root(self) -> bytes:
        return bytes([int(self)]) + b"\x00" * 31

    def copy(self):
        return self


# ---------------------------------------------------------------------------
# Parameterized type machinery
# ---------------------------------------------------------------------------

def _type_name(t: Any) -> str:
    return t.__name__ if hasattr(t, "__name__") else str(t)


class _ParamMeta(type):
    """Metaclass giving generic SSZ types a cached `Base[params]` syntax so
    `List[uint64, 8] is List[uint64, 8]` and isinstance checks work."""
    _cache: dict = {}

    def __getitem__(cls, params):
        if not isinstance(params, tuple):
            params = (params,)
        key = (cls, params)
        cached = _ParamMeta._cache.get(key)
        if cached is not None:
            return cached
        sub = cls._parameterize(params)
        _ParamMeta._cache[key] = sub
        return sub


# ---------------------------------------------------------------------------
# Byte types
# ---------------------------------------------------------------------------

class ByteVector(bytes, SSZType, metaclass=_ParamMeta):
    LENGTH: int = 0

    @classmethod
    def _parameterize(cls, params):
        (length,) = params
        return type(f"ByteVector[{length}]", (ByteVector,), {"LENGTH": int(length)})

    def __new__(cls, data: bytes | None = None):
        if cls.LENGTH == 0 and cls is ByteVector:
            raise TypeError("use ByteVector[N]")
        if data is None:
            data = b"\x00" * cls.LENGTH
        if isinstance(data, str):
            data = bytes.fromhex(data[2:] if data.startswith("0x") else data)
        data = bytes(data)
        if len(data) != cls.LENGTH:
            raise ValueError(f"{cls.__name__}: expected {cls.LENGTH} bytes, got {len(data)}")
        return super().__new__(cls, data)

    @classmethod
    def is_fixed_size(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.LENGTH

    @classmethod
    def default(cls):
        return cls(b"\x00" * cls.LENGTH)

    @classmethod
    def coerce(cls, v):
        if isinstance(v, (bytes, bytearray, str)):
            return cls(v)
        raise TypeError(f"cannot coerce {type(v).__name__} to {cls.__name__}")

    @classmethod
    def decode_bytes(cls, data: bytes):
        return cls(data)

    def encode_bytes(self) -> bytes:
        return bytes(self)

    def hash_tree_root(self) -> bytes:
        cached = self.__dict__.get("_root_cache")
        if cached is None:  # immutable: cache once, no invalidation needed
            cached = merkleize_chunks(_pack_bytes_to_chunks(bytes(self)))
            object.__setattr__(self, "_root_cache", cached)
        return cached

    def copy(self):
        return self


Bytes1 = ByteVector[1]
Bytes4 = ByteVector[4]
Bytes8 = ByteVector[8]
Bytes20 = ByteVector[20]
Bytes32 = ByteVector[32]
Bytes48 = ByteVector[48]
Bytes96 = ByteVector[96]


class ByteList(bytes, SSZType, metaclass=_ParamMeta):
    LIMIT: int = 0

    @classmethod
    def _parameterize(cls, params):
        (limit,) = params
        return type(f"ByteList[{limit}]", (ByteList,), {"LIMIT": int(limit)})

    def __new__(cls, data: bytes = b""):
        data = bytes(data)
        if len(data) > cls.LIMIT:
            raise ValueError(f"{cls.__name__}: {len(data)} bytes exceeds limit {cls.LIMIT}")
        return super().__new__(cls, data)

    @classmethod
    def is_fixed_size(cls) -> bool:
        return False

    @classmethod
    def default(cls):
        return cls(b"")

    @classmethod
    def coerce(cls, v):
        if isinstance(v, (bytes, bytearray)):
            return cls(v)
        raise TypeError(f"cannot coerce {type(v).__name__} to {cls.__name__}")

    @classmethod
    def decode_bytes(cls, data: bytes):
        return cls(data)

    def encode_bytes(self) -> bytes:
        return bytes(self)

    def hash_tree_root(self) -> bytes:
        cached = self.__dict__.get("_root_cache")
        if cached is None:  # immutable: cache once, no invalidation needed
            limit_chunks = (self.LIMIT + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
            root = merkleize_chunks(_pack_bytes_to_chunks(bytes(self)), limit=limit_chunks)
            cached = mix_in_length(root, len(self))
            object.__setattr__(self, "_root_cache", cached)
        return cached

    def copy(self):
        return self


# ---------------------------------------------------------------------------
# Bit types
# ---------------------------------------------------------------------------

def _bits_from_args(args) -> list[bool]:
    if len(args) == 1 and isinstance(args[0], (list, tuple)) :
        args = args[0]
    return [bool(b) for b in args]


def _bits_to_bytes(bits: Sequence[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


class Bitvector(SSZType, metaclass=_ParamMeta):
    LENGTH: int = 0

    @classmethod
    def _parameterize(cls, params):
        (length,) = params
        if int(length) <= 0:
            raise TypeError("Bitvector length must be > 0")
        return type(f"Bitvector[{length}]", (Bitvector,), {"LENGTH": int(length)})

    def __init__(self, *args):
        bits = _bits_from_args(args)
        if len(bits) == 0:
            bits = [False] * self.LENGTH
        if len(bits) != self.LENGTH:
            raise ValueError(f"{type(self).__name__}: expected {self.LENGTH} bits, got {len(bits)}")
        self._bits = bits

    @classmethod
    def is_fixed_size(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return (cls.LENGTH + 7) // 8

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, v):
        if isinstance(v, cls):
            return v
        if isinstance(v, (list, tuple)):
            return cls(v)
        if isinstance(v, Bitvector) and type(v).LENGTH == cls.LENGTH:
            return cls(v._bits)
        raise TypeError(f"cannot coerce {type(v).__name__} to {cls.__name__}")

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) != cls.type_byte_length():
            raise ValueError(f"{cls.__name__}: wrong byte length {len(data)}")
        bits = [(data[i // 8] >> (i % 8)) & 1 == 1 for i in range(cls.LENGTH)]
        # Excess high bits must be zero.
        for i in range(cls.LENGTH, len(data) * 8):
            if (data[i // 8] >> (i % 8)) & 1:
                raise ValueError(f"{cls.__name__}: non-zero padding bit {i}")
        return cls(bits)

    def encode_bytes(self) -> bytes:
        out = bytearray(self.type_byte_length())
        for i, b in enumerate(self._bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def hash_tree_root(self) -> bytes:
        cached = self.__dict__.get("_root_cache")
        if cached is not None:
            return cached
        root = merkleize_chunks(_pack_bytes_to_chunks(self.encode_bytes()))
        object.__setattr__(self, "_root_cache", root)
        return root

    def copy(self):
        return type(self)(list(self._bits))

    def __len__(self):
        return self.LENGTH

    def __getitem__(self, i):
        return self._bits[i]

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            new = list(self._bits)
            new[i] = [bool(b) for b in v]
            if len(new) != self.LENGTH:
                raise ValueError(f"{type(self).__name__}: slice assignment would change length")
            self._bits = new
        else:
            self._bits[i] = bool(v)
        _mark_dirty(self)

    def __iter__(self):
        return iter(self._bits)

    def __eq__(self, other):
        return type(self) is type(other) and self._bits == other._bits

    def __hash__(self):
        return hash((type(self).__name__, tuple(self._bits)))

    def __repr__(self):
        return f"{type(self).__name__}({''.join('1' if b else '0' for b in self._bits)})"


class Bitlist(SSZType, metaclass=_ParamMeta):
    LIMIT: int = 0

    @classmethod
    def _parameterize(cls, params):
        (limit,) = params
        return type(f"Bitlist[{limit}]", (Bitlist,), {"LIMIT": int(limit)})

    def __init__(self, *args):
        bits = _bits_from_args(args)
        if len(bits) > self.LIMIT:
            raise ValueError(f"{type(self).__name__}: {len(bits)} bits exceeds limit {self.LIMIT}")
        self._bits = bits

    @classmethod
    def is_fixed_size(cls) -> bool:
        return False

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, v):
        if isinstance(v, cls):
            return v
        if isinstance(v, (list, tuple)):
            return cls(v)
        if isinstance(v, Bitlist) and type(v).LIMIT == cls.LIMIT:
            return cls(v._bits)
        raise TypeError(f"cannot coerce {type(v).__name__} to {cls.__name__}")

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) == 0:
            raise ValueError("Bitlist: empty serialization")
        if data[-1] == 0:
            raise ValueError("Bitlist: no delimiter bit")
        total_bits = len(data) * 8
        # Position of the delimiter = highest set bit.
        last = data[-1]
        delim = (len(data) - 1) * 8 + last.bit_length() - 1
        if delim > cls.LIMIT:
            raise ValueError(f"Bitlist: length {delim} exceeds limit {cls.LIMIT}")
        bits = [(data[i // 8] >> (i % 8)) & 1 == 1 for i in range(delim)]
        for i in range(delim + 1, total_bits):
            if (data[i // 8] >> (i % 8)) & 1:
                raise ValueError(f"Bitlist: non-zero bit {i} past delimiter")
        return cls(bits)

    def encode_bytes(self) -> bytes:
        bits = list(self._bits) + [True]  # delimiter
        return _bits_to_bytes(bits)

    def hash_tree_root(self) -> bytes:
        cached = self.__dict__.get("_root_cache")
        if cached is not None:
            return cached
        limit_chunks = (self.LIMIT + 255) // 256
        chunks = _pack_bytes_to_chunks(_bits_to_bytes(self._bits)) if self._bits else []
        root = mix_in_length(merkleize_chunks(chunks, limit=limit_chunks), len(self._bits))
        object.__setattr__(self, "_root_cache", root)
        return root

    def copy(self):
        return type(self)(list(self._bits))

    def append(self, v):
        if len(self._bits) >= self.LIMIT:
            raise ValueError(f"{type(self).__name__}: append past limit")
        self._bits.append(bool(v))
        _mark_dirty(self)

    def __len__(self):
        return len(self._bits)

    def __getitem__(self, i):
        return self._bits[i]

    def __setitem__(self, i, v):
        self._bits[i] = bool(v)
        _mark_dirty(self)

    def __iter__(self):
        return iter(self._bits)

    def __eq__(self, other):
        return type(self) is type(other) and self._bits == other._bits

    def __hash__(self):
        return hash((type(self).__name__, tuple(self._bits)))

    def __repr__(self):
        return f"{type(self).__name__}({''.join('1' if b else '0' for b in self._bits)})"


# ---------------------------------------------------------------------------
# Sequence composites
# ---------------------------------------------------------------------------

def _is_basic(t) -> bool:
    return isinstance(t, type) and issubclass(t, (uint, boolean))


def _elems_from_args(args) -> list:
    if len(args) == 1 and isinstance(args[0], (list, tuple)) and not isinstance(args[0], (bytes, str)):
        return list(args[0])
    if len(args) == 1 and hasattr(args[0], "__iter__") and not isinstance(args[0], (bytes, str, int)):
        return list(args[0])
    return list(args)


class _Sequence(SSZType):
    ELEM_TYPE: type

    def _coerce_elems(self, elems):
        return [self.ELEM_TYPE.coerce(e) if not isinstance(e, self.ELEM_TYPE) else e for e in elems]

    # --- columnar backing (basic element types) -----------------------------
    # Registry-scale sequences of uints/booleans can be backed by a single
    # numpy column (`_np`) instead of a list of boxed Python ints, making the
    # engine bridge's per-epoch from_numpy/to_numpy round-trip an O(1) array
    # adoption rather than a million-element boxing pass (engine/bridge.py).
    # Boxed elements (`_list`) materialize lazily on first generic access and
    # may coexist with the column because basic elements are immutable; every
    # list-path mutation drops the column, and the in-place int __setitem__
    # updates both. Invariant: when both are present they hold equal values.

    @property
    def _elems(self):
        lst = self.__dict__.get("_list")
        if lst is None:
            col = self.__dict__.get("_np")
            et = self.ELEM_TYPE
            lst = [et(v) for v in col.tolist()] if col is not None else []
            self.__dict__["_list"] = lst
        return lst

    @_elems.setter
    def _elems(self, value):
        self.__dict__["_list"] = value
        self.__dict__["_np"] = None

    # --- incremental-merkleization bookkeeping ------------------------------

    @classmethod
    def _elems_tracked(cls) -> bool:
        """Whether elements are mutable composites needing parent links
        (uints/booleans/bytes are immutable: only __setitem__ can change
        their chunk, which marks it directly)."""
        t = cls.__dict__.get("_elems_tracked_cache")
        if t is None:
            t = isinstance(cls.ELEM_TYPE, type) and issubclass(cls.ELEM_TYPE, _TRACKED_TYPES)
            cls._elems_tracked_cache = t
        return t

    @classmethod
    def _chunk_index(cls, i: int) -> int:
        et = cls.ELEM_TYPE
        if _is_basic(et):
            return (i * et.type_byte_length()) // BYTES_PER_CHUNK
        return i

    def _attach_all(self) -> None:
        if self._elems_tracked():
            for i, e in enumerate(self._elems):
                _attach(e, self, self._chunk_index(i))

    def _note_dirty_chunk(self, ci: int) -> None:
        d = self.__dict__.get("_dirty")
        if d is None:
            d = set()
            object.__setattr__(self, "_dirty", d)
        d.add(ci)

    def _mark_structural(self) -> None:
        """Length/layout changed: the IncrementalTree rebuilds at next hash
        (element root caches still make the rebuild cheap)."""
        object.__setattr__(self, "_structural", True)
        _mark_dirty(self)

    def _chunk_bytes(self, ci: int) -> bytes | None:
        """Current 32-byte value of chunk `ci`, or None if out of range
        (stale dirty mark from a since-removed element)."""
        et = self.ELEM_TYPE
        if _is_basic(et):
            per = BYTES_PER_CHUNK // et.type_byte_length()
            col = self.__dict__.get("_np")
            if col is not None:
                seg = col[ci * per:(ci + 1) * per]
                if len(seg) == 0:
                    return None
                return _pack_le_blob(seg, et.type_byte_length())
            seg = self._elems[ci * per:(ci + 1) * per]
            if not seg:
                return None
            data = b"".join(e.encode_bytes() for e in seg)
            return data + b"\x00" * (BYTES_PER_CHUNK - len(data))
        if ci >= len(self._elems):
            return None
        return self._elems[ci].hash_tree_root()

    def _pack_blob_fast(self):
        """Chunk blob for big basic-element sequences via one numpy pass
        (1M Python encode_bytes calls otherwise dominate cold builds);
        None when the element dtype has no numpy representation."""
        et = self.ELEM_TYPE
        if not _is_basic(et):
            return None
        size = et.type_byte_length()
        if size not in (1, 2, 4, 8):
            return None
        col = self.__dict__.get("_np")
        if col is not None:
            return _pack_le_blob(col, size)
        if len(self._elems) < 1024:
            return None
        return _pack_le_blob(self.to_numpy(), size)

    def _merkle_root(self, limit_chunks: int | None) -> bytes:
        """Chunk-tree root (before any length mix-in), maintained
        incrementally: dirty chunks rehash O(dirty · log n) through the
        cached IncrementalTree; structural changes rebuild it."""
        tree = self.__dict__.get("_tree")
        if tree is not None and not self.__dict__.get("_structural"):
            dirty = self.__dict__.get("_dirty")
            if dirty:
                updates = {}
                for ci in dirty:
                    v = self._chunk_bytes(ci)
                    if v is not None:
                        updates[ci] = v
                tree.update(updates)
                dirty.clear()
            return tree.root()
        blob = self._pack_blob_fast()
        if blob is None:
            chunks = self._chunks()
            blob = b"".join(chunks)
            n_chunks = len(chunks)
        else:
            chunks = None
            n_chunks = len(blob) // BYTES_PER_CHUNK
        dirty = self.__dict__.get("_dirty")
        if dirty:
            dirty.clear()
        object.__setattr__(self, "_structural", False)
        if n_chunks >= _TREE_MIN_CHUNKS:
            tree = IncrementalTree(
                blob, n_chunks if limit_chunks is None else limit_chunks)
            object.__setattr__(self, "_tree", tree)
            return tree.root()
        # small sequence (columnar ones can land here at any length)
        if chunks is None:
            chunks = [blob[i:i + BYTES_PER_CHUNK]
                      for i in range(0, len(blob), BYTES_PER_CHUNK)]
        object.__setattr__(self, "_tree", None)
        return merkleize_chunks(chunks, limit=limit_chunks)

    def __len__(self):
        lst = self.__dict__.get("_list")
        if lst is not None:
            return len(lst)
        col = self.__dict__.get("_np")
        return len(col) if col is not None else 0

    def __iter__(self):
        return iter(self._elems)

    def __getitem__(self, i):
        if isinstance(i, slice):
            lst = self.__dict__.get("_list")
            if lst is None:
                col = self.__dict__.get("_np")
                if col is not None:
                    et = self.ELEM_TYPE
                    return [et(v) for v in col[i].tolist()]
            return self._elems[i]
        lst = self.__dict__.get("_list")
        if lst is not None:
            return lst[i]
        col = self.__dict__.get("_np")
        if col is not None:
            return self.ELEM_TYPE(col[i].item())
        raise IndexError(f"{type(self).__name__} index out of range")

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            new = list(self._elems)
            new[i] = self._coerce_elems(v)
            self._check_length(len(new))
            self._elems = new
            # positions may have shifted: refresh every parent link (stale
            # old-index links only cause spurious rehashes, never staleness)
            self._attach_all()
            self._mark_structural()
        else:
            value = v if isinstance(v, self.ELEM_TYPE) else self.ELEM_TYPE.coerce(v)
            lst = self.__dict__.get("_list")
            col = self.__dict__.get("_np")
            if lst is not None:
                lst[i] = value
            if col is not None:
                col[i] = value  # keeps the column coherent with the list
            if lst is None and col is None:
                raise IndexError(f"{type(self).__name__} assignment index out of range")
            if i < 0:
                i += len(self)
            ci = self._chunk_index(i)
            _attach(value, self, ci)
            self._note_dirty_chunk(ci)
            _mark_dirty(self)

    def _check_length(self, n: int) -> None:
        raise NotImplementedError

    def __eq__(self, other):
        if isinstance(other, (list, tuple)):
            # Spec code compares SSZ sequences against plain-list literals.
            return len(self._elems) == len(other) and all(
                a == b for a, b in zip(self._elems, other))
        if type(self) is not type(other):
            return False
        a, b = self.__dict__.get("_np"), other.__dict__.get("_np")
        if a is not None and b is not None:
            import numpy as np

            return bool(np.array_equal(a, b))
        return self._elems == other._elems

    def __hash__(self):
        return hash((type(self).__name__, tuple(self._elems)))

    def __repr__(self):
        return f"{type(self).__name__}({self._elems!r})"

    def index(self, v):
        return self._elems.index(v)

    def count(self, v):
        return self._elems.count(v)

    def __contains__(self, v):
        return v in self._elems

    # --- bulk columnar paths (engine bridge / registry-scale IO) ------------

    def to_numpy(self):
        """uint/boolean sequence -> numpy array in one C-driven pass (uints
        subclass int, so np.fromiter reads them without per-element Python).
        The registry-scale bridge (engine/bridge.py) depends on this being
        O(n) C work, not O(n) interpreter work."""
        import numpy as np

        et = self.ELEM_TYPE
        _dtypes = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
        if issubclass(et, boolean):
            dtype = np.bool_
        elif issubclass(et, uint) and et.type_byte_length() in _dtypes:
            dtype = _dtypes[et.type_byte_length()]
        else:
            raise TypeError(f"to_numpy: {et.__name__} has no numpy dtype")
        col = self.__dict__.get("_np")
        if col is not None:
            return col.copy()
        return np.fromiter(self._elems, dtype=dtype, count=len(self._elems))

    @classmethod
    def from_values(cls, values):
        """Bulk-construct from raw ints/bools: one boxing pass, no per-element
        coerce dispatch. `values` may be any iterable of in-range values
        (numpy arrays: pass arr.tolist() — iterating numpy scalars is slow)."""
        et = cls.ELEM_TYPE
        if issubclass(et, uint) and not issubclass(et, boolean):
            # preserve coerce()'s bool rejection (bool subclasses int): a
            # numpy bool column fed into a uint list must fail loudly
            values = list(values)
            if any(type(v) is bool for v in values):
                raise TypeError(f"cannot build {cls.__name__} from bools")
        out = cls.__new__(cls)
        out._elems = [et(v) for v in values]
        out._check_length(len(out._elems))
        out._attach_all()  # no-op for basic elems; REQUIRED for tracked ones
        return out

    @classmethod
    def from_numpy(cls, arr):
        """Adopt a numpy column as the sequence's backing storage — no
        per-element boxing — and pre-seed the merkle tree straight from the
        column's bytes. The registry-scale write-back (engine/bridge)
        replaces whole basic-element lists per epoch; this makes that an
        O(n) memcpy + one native hashing pass instead of a million-element
        Python boxing pass."""
        import numpy as np

        et = cls.ELEM_TYPE
        if not _is_basic(et):
            raise TypeError("from_numpy: basic element types only")
        size = et.type_byte_length()
        if size not in (1, 2, 4, 8):
            raise TypeError(f"from_numpy: {et.__name__} has no numpy dtype")
        arr = np.ascontiguousarray(arr)
        if issubclass(et, boolean):
            if arr.dtype != np.bool_:
                if arr.dtype.kind not in ("u", "i") or (
                        len(arr) and int(arr.max()) > 1 or len(arr) and int(arr.min()) < 0):
                    raise TypeError(f"cannot build {cls.__name__} from dtype {arr.dtype}")
                arr = arr.astype(np.bool_)
            col = np.array(arr, dtype=np.bool_)
        else:
            if arr.dtype.kind == "b":
                # preserve from_values' bool rejection: a numpy bool column
                # fed into a uint list must fail loudly
                raise TypeError(f"cannot build {cls.__name__} from bools")
            if arr.dtype.kind not in ("u", "i"):
                raise TypeError(f"cannot build {cls.__name__} from dtype {arr.dtype}")
            if len(arr):
                lo, hi = int(arr.min()), int(arr.max())
                if lo < 0 or hi >> (8 * size):
                    raise OverflowError(
                        f"{cls.__name__}: value out of range for {et.__name__}")
            col = np.array(arr, dtype=f"u{size}")
        out = cls.__new__(cls)
        out.__dict__["_np"] = col
        out.__dict__["_list"] = None
        out._check_length(len(col))
        # No eager tree seeding: _merkle_root's cold path packs the chunk
        # blob straight from the column, so the IncrementalTree builds lazily
        # on the first hash_tree_root — columns that are never hashed
        # (intermediate bridge states) cost nothing.
        return out

    @classmethod
    def _decode_columnar(cls, data: bytes):
        """Columnar decode for large basic-element payloads: one frombuffer
        pass instead of len/size boxed `decode_bytes` calls (registry-scale
        state loads). None when inapplicable; the caller falls back to the
        per-element path."""
        import numpy as np

        et = cls.ELEM_TYPE
        if not _is_basic(et):
            return None
        size = et.type_byte_length()
        if size not in (1, 2, 4, 8) or len(data) < 1024 * size:
            return None
        if len(data) % size != 0:
            raise ValueError(
                f"{cls.__name__}: byte length {len(data)} not a multiple of {size}")
        arr = np.frombuffer(data, dtype=f"<u{size}")
        if issubclass(et, boolean):
            if len(arr) and int(arr.max()) > 1:
                raise ValueError(f"{cls.__name__}: invalid boolean byte")
            arr = arr.astype(np.bool_)
        return cls.from_numpy(arr)

    # --- shared serialization over self._elems ---

    def encode_bytes(self) -> bytes:
        import numpy as np

        et = self.ELEM_TYPE
        col = self.__dict__.get("_np")
        if col is not None and _is_basic(et):
            size = et.type_byte_length()
            a = col.astype(np.uint8) if col.dtype == np.bool_ else col
            return np.ascontiguousarray(a).astype(f"<u{size}", copy=False).tobytes()
        if et.is_fixed_size():
            return b"".join(e.encode_bytes() for e in self._elems)
        parts = [e.encode_bytes() for e in self._elems]
        offset = OFFSET_BYTE_LENGTH * len(parts)
        out = bytearray()
        for p in parts:
            out += offset.to_bytes(OFFSET_BYTE_LENGTH, "little")
            offset += len(p)
        for p in parts:
            out += p
        return bytes(out)

    @classmethod
    def _decode_elems(cls, data: bytes) -> list:
        et = cls.ELEM_TYPE
        if et.is_fixed_size():
            size = et.type_byte_length()
            if len(data) % size != 0:
                raise ValueError(f"{cls.__name__}: byte length {len(data)} not a multiple of {size}")
            return [et.decode_bytes(data[i:i + size]) for i in range(0, len(data), size)]
        if len(data) == 0:
            return []
        first_offset = int.from_bytes(data[:OFFSET_BYTE_LENGTH], "little")
        if first_offset % OFFSET_BYTE_LENGTH != 0 or first_offset == 0 or first_offset > len(data):
            raise ValueError(f"{cls.__name__}: invalid first offset {first_offset}")
        count = first_offset // OFFSET_BYTE_LENGTH
        offsets = [int.from_bytes(data[i * 4:(i + 1) * 4], "little") for i in range(count)]
        offsets.append(len(data))
        elems = []
        for i in range(count):
            if offsets[i] > offsets[i + 1] or offsets[i] > len(data):
                raise ValueError(f"{cls.__name__}: offsets not monotonic")
            elems.append(et.decode_bytes(data[offsets[i]:offsets[i + 1]]))
        return elems

    def _chunks(self) -> list[bytes]:
        et = self.ELEM_TYPE
        if _is_basic(et):
            return _pack_bytes_to_chunks(b"".join(e.encode_bytes() for e in self._elems))
        batched = _batch_container_roots(self._elems, et)
        if batched is not None:
            return batched
        return [e.hash_tree_root() for e in self._elems]


class Vector(_Sequence, metaclass=_ParamMeta):
    LENGTH: int = 0

    @classmethod
    def _parameterize(cls, params):
        elem_type, length = params
        if int(length) <= 0:
            raise TypeError("Vector length must be > 0")
        return type(
            f"Vector[{_type_name(elem_type)},{length}]", (Vector,),
            {"ELEM_TYPE": elem_type, "LENGTH": int(length)},
        )

    def __init__(self, *args):
        elems = _elems_from_args(args)
        if len(elems) == 0:
            elems = [self.ELEM_TYPE.default() for _ in range(self.LENGTH)]
        if len(elems) != self.LENGTH:
            raise ValueError(f"{type(self).__name__}: expected {self.LENGTH} elements, got {len(elems)}")
        self._elems = self._coerce_elems(elems)
        self._attach_all()

    def _check_length(self, n: int) -> None:
        if n != self.LENGTH:
            raise ValueError(f"{type(self).__name__}: mutation would change length to {n}")

    @classmethod
    def chunk_count(cls) -> int:
        if _is_basic(cls.ELEM_TYPE):
            return (cls.LENGTH * cls.ELEM_TYPE.type_byte_length()
                    + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        return cls.LENGTH

    @classmethod
    def is_fixed_size(cls) -> bool:
        return cls.ELEM_TYPE.is_fixed_size()

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.ELEM_TYPE.type_byte_length() * cls.LENGTH

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, v):
        if isinstance(v, cls):
            return v
        if isinstance(v, (list, tuple)) or (isinstance(v, _Sequence)):
            return cls(list(v))
        raise TypeError(f"cannot coerce {type(v).__name__} to {cls.__name__}")

    @classmethod
    def decode_bytes(cls, data: bytes):
        fast = cls._decode_columnar(data)
        if fast is not None:
            return fast  # from_numpy already enforced LENGTH
        elems = cls._decode_elems(data)
        if len(elems) != cls.LENGTH:
            raise ValueError(f"{cls.__name__}: decoded {len(elems)} elements, expected {cls.LENGTH}")
        return cls(elems)

    def hash_tree_root(self) -> bytes:
        cached = self.__dict__.get("_root_cache")
        if cached is not None:
            return cached
        root = self._merkle_root(self.chunk_count())
        object.__setattr__(self, "_root_cache", root)
        return root

    def copy(self):
        col = self.__dict__.get("_np")
        if col is not None and self.__dict__.get("_list") is None:
            new = type(self).__new__(type(self))
            new.__dict__["_np"] = col.copy()
            new.__dict__["_list"] = None
            _copy_merkle_state(self, new)
            return new
        new = type(self)([e.copy() if hasattr(e, "copy") else e for e in self._elems])
        _copy_merkle_state(self, new)
        return new


class List(_Sequence, metaclass=_ParamMeta):
    LIMIT: int = 0

    @classmethod
    def _parameterize(cls, params):
        elem_type, limit = params
        return type(
            f"List[{_type_name(elem_type)},{limit}]", (List,),
            {"ELEM_TYPE": elem_type, "LIMIT": int(limit)},
        )

    def __init__(self, *args):
        elems = _elems_from_args(args)
        if len(elems) > self.LIMIT:
            raise ValueError(f"{type(self).__name__}: {len(elems)} elements exceeds limit {self.LIMIT}")
        self._elems = self._coerce_elems(elems)
        self._attach_all()

    def _check_length(self, n: int) -> None:
        if n > self.LIMIT:
            raise ValueError(f"{type(self).__name__}: mutation would exceed limit ({n} > {self.LIMIT})")

    @classmethod
    def is_fixed_size(cls) -> bool:
        return False

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, v):
        if isinstance(v, cls):
            return v
        if isinstance(v, (list, tuple)) or isinstance(v, _Sequence):
            return cls(list(v))
        raise TypeError(f"cannot coerce {type(v).__name__} to {cls.__name__}")

    @classmethod
    def decode_bytes(cls, data: bytes):
        fast = cls._decode_columnar(data)
        if fast is not None:
            return fast  # from_numpy already enforced LIMIT
        elems = cls._decode_elems(data)
        if len(elems) > cls.LIMIT:
            raise ValueError(f"{cls.__name__}: {len(elems)} elements exceeds limit")
        return cls(elems)

    @classmethod
    def chunk_limit(cls) -> int:
        if _is_basic(cls.ELEM_TYPE):
            return (cls.LIMIT * cls.ELEM_TYPE.type_byte_length() + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        return cls.LIMIT

    def hash_tree_root(self) -> bytes:
        cached = self.__dict__.get("_root_cache")
        if cached is not None:
            return cached
        root = mix_in_length(self._merkle_root(self.chunk_limit()), len(self))
        object.__setattr__(self, "_root_cache", root)
        return root

    def copy(self):
        col = self.__dict__.get("_np")
        if col is not None and self.__dict__.get("_list") is None:
            new = type(self).__new__(type(self))
            new.__dict__["_np"] = col.copy()
            new.__dict__["_list"] = None
            _copy_merkle_state(self, new)
            return new
        new = type(self)([e.copy() if hasattr(e, "copy") else e for e in self._elems])
        _copy_merkle_state(self, new)
        return new

    def append(self, v):
        if len(self) >= self.LIMIT:
            raise ValueError(f"{type(self).__name__}: append past limit")
        value = v if isinstance(v, self.ELEM_TYPE) else self.ELEM_TYPE.coerce(v)
        self._elems.append(value)
        self.__dict__["_np"] = None  # list path is now authoritative
        _attach(value, self, self._chunk_index(len(self._elems) - 1))
        self._mark_structural()

    def pop(self):
        if not self._elems:
            raise IndexError("pop from empty List")
        value = self._elems.pop()
        self.__dict__["_np"] = None  # list path is now authoritative
        self._mark_structural()
        return value


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------

class Container(SSZType):
    """SSZ container; fields declared as class annotations:

        class Checkpoint(Container):
            epoch: uint64
            root: Bytes32
    """
    _fields_cache: dict | None = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._fields_cache = None

    @classmethod
    def fields(cls) -> dict:
        if cls.__dict__.get("_fields_cache") is None:
            fields: dict = {}
            for klass in reversed(cls.__mro__):
                ann = klass.__dict__.get("__annotations__", {})
                for name, typ in ann.items():
                    if name.startswith("_"):
                        continue
                    fields[name] = typ
            cls._fields_cache = fields
        return cls._fields_cache

    def __init__(self, **kwargs):
        fields = self.fields()
        for name in kwargs:
            if name not in fields:
                raise TypeError(f"{type(self).__name__}: unknown field {name}")
        for name, typ in fields.items():
            if name in kwargs:
                v = kwargs[name]
                value = v if isinstance(v, typ) else typ.coerce(v)
            else:
                value = typ.default()
            object.__setattr__(self, name, value)
            _attach(value, self, 0)

    def __setattr__(self, name, value):
        fields = self.fields()
        if name in fields:
            typ = fields[name]
            if not isinstance(value, typ):
                value = typ.coerce(value)
            object.__setattr__(self, name, value)
            _attach(value, self, 0)
            _mark_dirty(self)
            return
        object.__setattr__(self, name, value)

    @classmethod
    def is_fixed_size(cls) -> bool:
        return all(t.is_fixed_size() for t in cls.fields().values())

    @classmethod
    def type_byte_length(cls) -> int:
        if not cls.is_fixed_size():
            raise TypeError(f"{cls.__name__} is variable-size")
        return sum(t.type_byte_length() for t in cls.fields().values())

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, v):
        if isinstance(v, cls):
            return v
        # Structural coercion: same field names => rebuild field-by-field
        # (each field recursively coerced). Needed for cross-fork/cross-module
        # upgrades where equivalent container classes are distinct objects.
        if isinstance(v, Container) and list(type(v).fields().keys()) == list(cls.fields().keys()):
            return cls(**{n: getattr(v, n) for n in cls.fields()})
        raise TypeError(f"cannot coerce {type(v).__name__} to {cls.__name__}")

    def encode_bytes(self) -> bytes:
        fields = self.fields()
        fixed_parts: list[bytes | None] = []
        variable_parts: list[bytes] = []
        for name, typ in fields.items():
            v = getattr(self, name)
            if typ.is_fixed_size():
                fixed_parts.append(v.encode_bytes())
            else:
                fixed_parts.append(None)
                variable_parts.append(v.encode_bytes())
        fixed_len = sum(len(p) if p is not None else OFFSET_BYTE_LENGTH for p in fixed_parts)
        out = bytearray()
        offset = fixed_len
        var_iter = iter(variable_parts)
        for p in fixed_parts:
            if p is None:
                out += offset.to_bytes(OFFSET_BYTE_LENGTH, "little")
                offset += len(next(var_iter))
            else:
                out += p
        for p in variable_parts:
            out += p
        return bytes(out)

    @classmethod
    def decode_bytes(cls, data: bytes):
        fields = cls.fields()
        fixed_len = sum(
            t.type_byte_length() if t.is_fixed_size() else OFFSET_BYTE_LENGTH
            for t in fields.values()
        )
        if len(data) < fixed_len:
            raise ValueError(f"{cls.__name__}: {len(data)} bytes < fixed part {fixed_len}")
        pos = 0
        offsets: list[tuple[str, int]] = []
        values: dict = {}
        for name, typ in fields.items():
            if typ.is_fixed_size():
                size = typ.type_byte_length()
                values[name] = typ.decode_bytes(data[pos:pos + size])
                pos += size
            else:
                off = int.from_bytes(data[pos:pos + OFFSET_BYTE_LENGTH], "little")
                offsets.append((name, off))
                pos += OFFSET_BYTE_LENGTH
        if offsets:
            if offsets[0][1] != fixed_len:
                raise ValueError(f"{cls.__name__}: first offset {offsets[0][1]} != fixed length {fixed_len}")
            bounds = [off for _, off in offsets] + [len(data)]
            for i, (name, off) in enumerate(offsets):
                if bounds[i] > bounds[i + 1]:
                    raise ValueError(f"{cls.__name__}: offsets not monotonic")
                values[name] = fields[name].decode_bytes(data[bounds[i]:bounds[i + 1]])
        elif pos != len(data):
            raise ValueError(f"{cls.__name__}: {len(data) - pos} trailing bytes")
        return cls(**values)

    def hash_tree_root(self) -> bytes:
        cached = self.__dict__.get("_root_cache")
        if cached is not None:
            return cached
        chunks = [getattr(self, name).hash_tree_root() for name in self.fields()]
        root = merkleize_chunks(chunks)
        object.__setattr__(self, "_root_cache", root)
        return root

    def copy(self):
        new = type(self)(**{
            name: (v.copy() if hasattr(v, "copy") else v)
            for name in self.fields()
            for v in [getattr(self, name)]
        })
        cached = self.__dict__.get("_root_cache")
        if cached is not None:  # identical content, identical root
            object.__setattr__(new, "_root_cache", cached)
        return new

    def __eq__(self, other):
        # Structural, not nominal (remerkleable parity): every compiled
        # fork/preset spec module defines its own Container classes, and
        # cross-fork spec code compares values across that boundary — e.g.
        # upgrade_to_altair's translate_participation matches a phase0
        # attestation's `data.source` against the post state's checkpoint.
        if type(self) is not type(other):
            if not isinstance(other, Container):
                return NotImplemented
            if list(self.fields()) != list(other.fields()):
                return False
        return all(
            getattr(self, n) == getattr(other, n) for n in self.fields()
        )

    def __hash__(self):
        return hash(self.hash_tree_root())

    def __repr__(self):
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self.fields())
        return f"{type(self).__name__}({inner})"


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------

class Union(SSZType, metaclass=_ParamMeta):
    OPTIONS: tuple = ()

    @classmethod
    def _parameterize(cls, params):
        names = ",".join("None" if p is type(None) or p is None else _type_name(p) for p in params)
        opts = tuple(None if p is type(None) else p for p in params)
        if opts and opts[0] is None and len(opts) == 1:
            raise TypeError("Union[None] alone is invalid")
        if any(o is None for o in opts[1:]):
            raise TypeError("Union: None only allowed as the first option (SSZ rule)")
        return type(f"Union[{names}]", (Union,), {"OPTIONS": opts})

    def __init__(self, selector: int, value=None):
        opts = self.OPTIONS
        if not 0 <= selector < len(opts):
            raise ValueError(f"Union selector {selector} out of range")
        typ = opts[selector]
        if typ is None:
            if value is not None:
                raise ValueError("Union: selector 0 (None) must have no value")
        else:
            value = value if isinstance(value, typ) else typ.coerce(value)
        self.selector = selector
        self.value = value

    @classmethod
    def is_fixed_size(cls) -> bool:
        return False

    @classmethod
    def default(cls):
        typ = cls.OPTIONS[0]
        return cls(0, None if typ is None else typ.default())

    @classmethod
    def coerce(cls, v):
        if isinstance(v, cls):
            return v
        raise TypeError(f"cannot coerce {type(v).__name__} to {cls.__name__}")

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) == 0:
            raise ValueError("Union: empty serialization")
        selector = data[0]
        if selector >= len(cls.OPTIONS):
            raise ValueError(f"Union: invalid selector {selector}")
        typ = cls.OPTIONS[selector]
        if typ is None:
            if len(data) != 1:
                raise ValueError("Union: trailing bytes after None selector")
            return cls(0, None)
        return cls(selector, typ.decode_bytes(data[1:]))

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name == "value":
            _attach(value, self, 0)
        if name in ("selector", "value"):
            _mark_dirty(self)

    def encode_bytes(self) -> bytes:
        body = b"" if self.value is None else self.value.encode_bytes()
        return bytes([self.selector]) + body

    def hash_tree_root(self) -> bytes:
        cached = self.__dict__.get("_root_cache")
        if cached is not None:
            return cached
        root = b"\x00" * 32 if self.value is None else self.value.hash_tree_root()
        root = mix_in_selector(root, self.selector)
        object.__setattr__(self, "_root_cache", root)
        return root

    def change(self, selector: int, value=None):
        """In-place re-tag (the sharding spec's `status.change(...)` idiom on
        `ShardWork` cells, reference specs/sharding/beacon-chain.md:660-668)."""
        replacement = type(self)(selector, value)
        self.selector = replacement.selector
        self.value = replacement.value

    def copy(self):
        v = self.value
        return type(self)(self.selector, v.copy() if hasattr(v, "copy") else v)

    def __eq__(self, other):
        return type(self) is type(other) and self.selector == other.selector and self.value == other.value

    def __hash__(self):
        return hash((type(self).__name__, self.selector, self.value))

    def __repr__(self):
        return f"{type(self).__name__}(selector={self.selector}, value={self.value!r})"


# Mutable composites participating in invalidation tracking (immutable
# values — uints, booleans, byte types — need no parent links: only the
# holder's own __setitem__/__setattr__ can change their slot).
_TRACKED_TYPES = (Container, _Sequence, Bitvector, Bitlist, Union)
