"""A reader and writer for the subset of msgpack that flax writes
(counterpart of flax/serialization.py msgpack_serialize / msgpack_restore,
flax 0.12.3 :236-434), so the port reads and writes the JAX package's
`.msgpack` and `.ckpt` files without the msgpack package.

The subset: maps, arrays, str, bin, int, float, bool and nil, plus two
extension types. Ext 1 is an ndarray and ext 3 a numpy scalar; the payload
of both is itself msgpack, the array `(shape, dtype name, C-order bytes)`.
Leaves larger than MAX_CHUNK_SIZE bytes are written, as flax writes them,
as a `__msgpack_chunked_array__` map of flat chunks, and joined on reading.

bfloat16: numpy has no bfloat16, so a `bfloat16` leaf is read as its
16-bit words and widened exactly to float32 (`<< 16`). A torch.bfloat16
tensor leaf is written as `bfloat16` with its raw words; any other torch
tensor is written as its numpy array.

Arrays read back are read-only views into the bytes that were read.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax's limit: leaves above it are chunked
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"

# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _head(out: List[bytes], n: int, fix: int, fix_max: int, codes) -> None:
    """A length-prefixed header: fixed form below fix_max, else the
    8/16/32-bit forms in `codes` (None where the type has no such form)."""
    if n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit 64 bits")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000), (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if v >= limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit 64 bits")


def _pack_str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    _head(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out.append(b)


def _pack_bin(out: List[bytes], b: bytes) -> None:
    _head(out, len(b), 0, 0, (0xC4, 0xC5, 0xC6))
    out.append(b)


def _pack_ext(out: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n <= 0xFF:
        out.append(bytes([0xC7, n, code]))
    elif n <= 0xFFFF:
        out.append(b"\xc8" + struct.pack(">H", n) + bytes([code]))
    else:
        out.append(b"\xc9" + struct.pack(">I", n) + bytes([code]))
    out.append(payload)


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    """The ext payload: msgpack of (shape, dtype name, C-order bytes)."""
    out: List[bytes] = []
    _head(out, 3, 0x90, 16, (None, 0xDC, 0xDD))
    _head(out, len(shape), 0x90, 16, (None, 0xDC, 0xDD))
    for d in shape:
        _pack_int(out, int(d))
    _pack_str(out, dtype_name)
    _pack_bin(out, data)
    return b"".join(out)


def _leaf_bytes(x):
    """(shape, dtype name, bytes) of an ndarray or a tensor leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return x.shape, x.dtype.name, x.tobytes("C")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x) -> dict:
    """flax's `_chunk`: a leaf over MAX_CHUNK_SIZE bytes as flat chunks."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _pack(out: List[bytes], obj: Any, sort: bool = True) -> None:
    """Append obj's msgpack. Map keys go out sorted, as flax's copy of the
    tree (jax.tree_util.tree_map) sorts them, except in the chunk maps,
    which flax builds after that copy."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.generic):  # before int and float: np.float64 is a float
        _pack_ext(out, EXT_NPSCALAR, _array_payload(*_leaf_bytes(np.asarray(obj))))
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(*_leaf_bytes(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        _pack_str(out, obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(out, bytes(obj))
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k in sorted(obj) if sort else obj:
            v = obj[k]
            _pack(out, k)
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                _pack(out, _chunk(v), sort=False)
            else:
                _pack(out, v, sort)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v, sort)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def msgpack_serialize(tree) -> bytes:
    """A tree of dicts, lists, Python scalars, numpy arrays and scalars and
    torch tensors -> msgpack bytes, laid out as flax lays them out."""
    out: List[bytes] = []
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        _pack(out, _chunk(tree), sort=False)
    else:
        _pack(out, tree)
    return b"".join(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _array_from_payload(payload: memoryview) -> np.ndarray:
    shape, name, data = _Reader(payload, views=True).read()
    name = str(name, "utf-8") if isinstance(name, memoryview) else name
    if name == "bfloat16":
        words = np.frombuffer(data, dtype="<u2").astype(np.uint32) << 16
        return words.view(np.float32).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    """One pass over msgpack bytes. bin values come back as bytes, or, with
    `views`, as memoryviews into the input (an array's data, uncopied)."""

    def __init__(self, data, views: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.views = views

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def _unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self._take(n))[0]

    def _length(self, code: int, base: int) -> int:
        """Length of an 8/16/32-bit form: `code - base` is 0, 1 or 2."""
        return self._unpack((">B", ">H", ">I")[code - base], 1 << (code - base))

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def _ext(self, n: int):
        code = self._unpack(">b", 1)
        payload = self._take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(payload)
        if code == EXT_NPSCALAR:
            return _array_from_payload(payload)[()]
        raise ValueError(f"msgpack extension type {code} is not one flax writes for arrays")

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:
            data = self._take(self._length(b, 0xC4))
            return data if self.views else bytes(data)
        if 0xC7 <= b <= 0xC9:
            return self._ext(self._length(b, 0xC7))
        if b == 0xCA:
            return self._unpack(">f", 4)
        if b == 0xCB:
            return self._unpack(">d", 8)
        if 0xCC <= b <= 0xD3:
            fmt, n = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
                      0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}[b]
            return self._unpack(fmt, n)
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return str(self._take(self._length(b, 0xD9)), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self._length(b + 1, 0xDC))]
        if b in (0xDE, 0xDF):
            return self._map(self._length(b + 1, 0xDE))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the subset flax writes")


def _unchunk(d: dict) -> np.ndarray:
    """flax's `_unchunk`: join the flat chunks and reshape."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def msgpack_restore(data) -> Any:
    """msgpack bytes (as flax writes them) -> the tree: dicts with str keys,
    lists, Python scalars, numpy arrays (bfloat16 widened to float32) and
    numpy scalars. Chunked leaves come back joined."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes after the msgpack object")
    return tree
