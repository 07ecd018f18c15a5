"""Read and write flax's msgpack variable files without flax, msgpack or
ml_dtypes (the card's machine has none of them).

Covers the subset that ``flax.serialization.msgpack_serialize`` produces
for variable trees:

- msgpack maps with str keys, arrays, ints, floats, nil, bools, str and
  bin;
- ext type 1, an ndarray: a packed ``(shape, dtype name, raw C-order
  bytes)``; ext type 3, a numpy scalar in the same encoding;
- flax's chunked arrays, ``{"__msgpack_chunked_array__": True, "shape":
  {"0": ...}, "chunks": {"0": ...}}``, for arrays over
  ``MAX_CHUNK_SIZE`` bytes.

Arrays are read into CPU torch tensors (bfloat16 straight from its bytes
to ``torch.bfloat16``) and numpy scalars into Python numbers.  The writer
takes nested dicts of torch tensors, numpy arrays and Python scalars.
Dtypes: float32, float16, bfloat16, int32, int64, uint8 and bool; any
other dtype, ext type or msgpack format raises and names what it found.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: msgpack's 2**31 - 1 byte limit per
# object, less a margin
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

# dtype name (numpy's, as flax writes it) -> (little-endian numpy dtype
# of the bytes, torch dtype); bfloat16's bytes are read as int16 and
# reinterpreted
DTYPES = {
    "float32": ("<f4", torch.float32),
    "float16": ("<f2", torch.float16),
    "bfloat16": ("<i2", torch.bfloat16),
    "int32": ("<i4", torch.int32),
    "int64": ("<i8", torch.int64),
    "uint8": ("u1", torch.uint8),
    "bool": ("?", torch.bool),
}
_TORCH_NAMES = {td: name for name, (_, td) in DTYPES.items()}


# ------------------------------------------------------------------ decode
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wanted {n} of {len(self.data) - self.pos})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin),
                 0xC6: (">I", self.bin), 0xD9: (">B", self.str),
                 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map),
                 0xC7: (">B", self.ext), 0xC8: (">H", self.ext),
                 0xC9: (">I", self.ext)}
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        if 0xD4 <= b <= 0xD8:               # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"msgpack: unsupported format byte 0x{b:02x} at "
                         f"byte {self.pos - 1}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from_bytes(payload)
        if code == EXT_NPSCALAR:
            return _array_from_bytes(payload).item()
        raise ValueError(f"msgpack: unsupported ext type {code} (flax "
                         f"writes 1 for arrays, 3 for numpy scalars)")


def _array_from_bytes(payload: bytes) -> torch.Tensor:
    r = _Reader(payload)
    shape, name, raw = r.obj()
    if name not in DTYPES:
        raise ValueError(f"msgpack: unsupported array dtype {name!r} "
                         f"(supported: {sorted(DTYPES)})")
    np_dtype, torch_dtype = DTYPES[name]
    arr = np.frombuffer(raw, dtype=np_dtype).copy().reshape(shape)
    out = torch.from_numpy(arr)
    return out.view(torch_dtype) if torch_dtype == torch.bfloat16 else out


def _unchunk(node):
    if isinstance(node, dict):
        if node.get(_CHUNKED):
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def msgpack_restore(data: bytes) -> Any:
    """Bytes written by ``flax.serialization.msgpack_serialize`` (or by
    :func:`msgpack_serialize`) -> the tree, arrays as CPU tensors."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return _unchunk(out)


# ------------------------------------------------------------------ encode
def _pack_len(n: int, fix_base: int, fix_limit: int, fmts) -> bytes:
    if n < fix_limit:
        return bytes([fix_base | n])
    for limit, head, fmt in fmts:
        if n < limit:
            return struct.pack(">B" + fmt, head, n)
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for limit, head, fmt in ((1 << 8, 0xCC, "B"), (1 << 16, 0xCD, "H"),
                                 (1 << 32, 0xCE, "I"), (1 << 64, 0xCF, "Q")):
            if n < limit:
                return struct.pack(">B" + fmt, head, n)
    else:
        for limit, head, fmt in ((1 << 7, 0xD0, "b"), (1 << 15, 0xD1, "h"),
                                 (1 << 31, 0xD2, "i"), (1 << 63, 0xD3, "q")):
            if n >= -limit:
                return struct.pack(">B" + fmt, head, n)
    raise ValueError(f"msgpack: int {n} out of range")


def _pack_bin(b: bytes) -> bytes:
    n = len(b)
    for limit, head, fmt in ((1 << 8, 0xC4, "B"), (1 << 16, 0xC5, "H"),
                             (1 << 32, 0xC6, "I")):
        if n < limit:
            return struct.pack(">B" + fmt, head, n) + b
    raise ValueError(f"msgpack: bin of {n} bytes too large")


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _pack_len(len(b), 0xA0, 32, ((1 << 8, 0xD9, "B"),
                                        (1 << 16, 0xDA, "H"),
                                        (1 << 32, 0xDB, "I"))) + b


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack(">Bb", fixed[n], code)
    else:
        for limit, byte, fmt in ((1 << 8, 0xC7, "B"), (1 << 16, 0xC8, "H"),
                                 (1 << 32, 0xC9, "I")):
            if n < limit:
                head = struct.pack(">B" + fmt + "b", byte, n, code)
                break
        else:
            raise ValueError(f"msgpack: ext of {n} bytes too large")
    return head + payload


def _array_bytes(x) -> tuple:
    """(shape, dtype name, C-order little-endian bytes) of a tensor or a
    numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype not in _TORCH_NAMES:
            raise ValueError(f"msgpack: unsupported tensor dtype {x.dtype}")
        name = _TORCH_NAMES[x.dtype]
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        arr = x.numpy()
    else:
        arr = np.asarray(x)
        name = arr.dtype.name
        if name not in DTYPES:
            raise ValueError(f"msgpack: unsupported array dtype {name!r}")
        if name == "bfloat16":
            arr = arr.view(np.int16)
    raw = np.ascontiguousarray(arr).astype(DTYPES[name][0], copy=False)
    return tuple(arr.shape), name, raw.tobytes("C")


def _pack_array(x, code: int = EXT_NDARRAY) -> bytes:
    shape, name, raw = _array_bytes(x)
    tpl = (_pack_len(len(shape), 0x90, 16, ((1 << 16, 0xDC, "H"),
                                            (1 << 32, 0xDD, "I")))
           + b"".join(_pack_int(int(d)) for d in shape)
           + _pack_str(name) + _pack_bin(raw))
    return _pack_ext(code, b"\x93" + tpl)


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize


def _chunked(x) -> dict:
    """flax's chunked form of an array over ``MAX_CHUNK_SIZE`` bytes."""
    flat = x.reshape(-1)
    per = max(1, MAX_CHUNK_SIZE // _itemsize(x))
    chunks = [flat[i:i + per] for i in range(0, flat.shape[0], per)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(x, out: list) -> None:
    if isinstance(x, dict):
        out.append(_pack_len(len(x), 0x80, 16, ((1 << 16, 0xDE, "H"),
                                                (1 << 32, 0xDF, "I"))))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map key {k!r} is not a str")
            out.append(_pack_str(k))
            _pack(v, out)
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        if int(np.prod(x.shape)) * _itemsize(x) > MAX_CHUNK_SIZE:
            _pack(_chunked(x), out)
        else:
            out.append(_pack_array(x))
    elif isinstance(x, np.generic):
        out.append(_pack_array(np.asarray(x), EXT_NPSCALAR))
    elif x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_pack_int(x))
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        out.append(_pack_str(x))
    elif isinstance(x, bytes):
        out.append(_pack_bin(x))
    else:
        raise TypeError(f"msgpack: cannot write {type(x).__name__}")


def msgpack_serialize(tree: Dict[str, Any]) -> bytes:
    """A tree of str-keyed dicts with array or scalar leaves -> bytes that
    ``flax.serialization.msgpack_restore`` reads."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)
