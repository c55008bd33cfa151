"""Wire codec: a restricted, numpy-aware binary value encoding.

The process-split deployment (kernel/wire.py) needs the same records the
in-proc bus carries — columnar batches, tenant configs, per-event
dataclasses — to cross a socket. The reference serializes with protobuf
plus ~25k lines of generated code and hand-written converters
[SURVEY.md §2.1 "Protobuf wire model"]; this codec gets the same
capability from the dataclass definitions themselves:

- scalars/str/bytes/list/dict encode with explicit tags (little-endian,
  length-prefixed) — no pickle, ever;
- numpy arrays encode as dtype + shape + raw buffer (the columnar hot
  path stays columnar on the wire: one header + one memcpy per column);
- dataclasses and enums encode by REGISTERED name + field dict. Decode
  only constructs classes that were explicitly registered, so a hostile
  peer cannot instantiate arbitrary types (the classic pickle hole).

Registration covers the domain model, batches, events, and config
(`register_module` scans a module once at import).

Zero-copy fast path (docs/PERFORMANCE.md wire fast path): the wire
layer encodes through `encode_segments`, which emits the value as a
LIST of buffers — small scalars/headers accumulate in shared bytearray
segments while each large contiguous ndarray column rides as a bare
memoryview over the array's own buffer (no per-column `tobytes()`
copy); `StreamWriter.writelines` then hands the whole list to the
transport in one scatter-gather write. Decode mirrors it:
`decode(payload, copy_arrays=False)` returns ndarrays as read-only
`np.frombuffer` views over the received frame — copy only if the
consumer actually needs to mutate (`np.array(a)` at the mutation
site). The hot pipeline never mutates decoded columns in place, so
the common case is zero copies on either side of the socket.

Hostile-input contract: every malformed frame — truncated buffer,
bogus tag, length prefix past the frame or `MAX_FRAME`, a dtype header
lying about its payload size, an unregistered class name — raises the
TYPED `WireFormatError` (a ValueError) BEFORE any partial object
escapes; decode never constructs a class the frame merely names
(tests/test_codec_hardening.py pins the suite in both copy modes).
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Any, Optional

import numpy as np

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

# one bound for the whole wire plane: frame readers (kernel/wire.py)
# refuse bodies past this, and decode refuses any INNER length prefix
# past it too — a 5-byte frame claiming a 4 GiB string dies on the
# prefix check, never on an allocation
MAX_FRAME = 256 * 1024 * 1024

# contiguous ndarray buffers at/above this many bytes ride the
# scatter-gather path as their own segment (below it, the memcpy into
# the shared segment is cheaper than another writev iovec)
_SG_MIN_BYTES = 1024

# decode sanity bounds (hostile headers, not honest payloads)
_MAX_NDIM = 32

# tags
T_NONE, T_TRUE, T_FALSE, T_INT, T_FLOAT = 0, 1, 2, 3, 4
T_STR, T_BYTES, T_LIST, T_DICT, T_NDARRAY = 5, 6, 7, 8, 9
T_DATACLASS, T_ENUM, T_TUPLE = 10, 11, 12

_CLASSES: dict[str, type] = {}
_ENUMS: dict[str, type] = {}
_defaults_loaded = False

# per-class field-name cache: `dataclasses.fields()` rebuilds its tuple
# from the class dict on every call — measurable per record at wire
# rates. One resolution per class, ever.
_FIELD_NAMES: dict[type, tuple[str, ...]] = {}


class WireFormatError(ValueError):
    """Malformed or hostile wire bytes. Raised by `decode` before any
    partially-constructed value can escape; subclasses ValueError so
    pre-existing `except ValueError` wire paths keep catching it."""


def register_class(cls: type) -> type:
    """Allow `cls` (a dataclass) on the wire.

    The registry is keyed by bare class name (the wire format's type
    tag); two DIFFERENT classes with one name would make decode
    construct the wrong type, so a collision fails loudly at import."""
    prev = _CLASSES.get(cls.__name__)
    if prev is not None and prev is not cls:
        raise ValueError(
            f"wire name collision: {cls.__name__!r} already registered "
            f"for {prev.__module__}.{prev.__qualname__}; cannot also map "
            f"to {cls.__module__}.{cls.__qualname__}")
    _CLASSES[cls.__name__] = cls
    return cls


def register_enum(cls: type) -> type:
    prev = _ENUMS.get(cls.__name__)
    if prev is not None and prev is not cls:
        raise ValueError(
            f"wire name collision: enum {cls.__name__!r} already "
            f"registered for {prev.__module__}.{prev.__qualname__}")
    _ENUMS[cls.__name__] = cls
    return cls


def register_module(mod) -> None:
    """Register every dataclass and Enum defined in `mod`."""
    for name in dir(mod):
        obj = getattr(mod, name)
        if not isinstance(obj, type) or obj.__module__ != mod.__name__:
            continue
        if dataclasses.is_dataclass(obj):
            register_class(obj)
        elif issubclass(obj, enum.Enum):
            register_enum(obj)


def _register_defaults() -> None:
    global _defaults_loaded
    if _defaults_loaded:
        return
    _defaults_loaded = True
    from sitewhere_tpu_torch import config as _config
    from sitewhere_tpu_torch.domain import batch as _batch
    from sitewhere_tpu_torch.domain import events as _events
    from sitewhere_tpu_torch.domain import model as _model

    for mod in (_batch, _events, _model, _config):
        register_module(mod)


def _field_names(cls: type) -> tuple[str, ...]:
    names = _FIELD_NAMES.get(cls)
    if names is None:
        names = _FIELD_NAMES[cls] = tuple(
            f.name for f in dataclasses.fields(cls))
    return names


def _w_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    out += _U32.pack(len(b))
    out += b


def _encode_into(out: bytearray, v: Any,
                 segs: Optional[list]) -> bytearray:
    """Append `v`'s encoding. With `segs` (the scatter-gather sink),
    large ndarray buffers are attached as zero-copy memoryview segments
    and a FRESH bytearray becomes the current tail — the (possibly new)
    tail is returned, so recursive calls must thread it."""
    if v is None:
        out.append(T_NONE)
    elif v is True:
        out.append(T_TRUE)
    elif v is False:
        out.append(T_FALSE)
    elif isinstance(v, int) and not isinstance(v, enum.Enum):
        out.append(T_INT)
        out += _I64.pack(v)
    elif isinstance(v, float):
        out.append(T_FLOAT)
        out += _F64.pack(v)
    elif isinstance(v, str):
        out.append(T_STR)
        _w_str(out, v)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        out.append(T_BYTES)
        b = bytes(v)
        out += _U32.pack(len(b))
        out += b
    elif isinstance(v, np.ndarray):
        out.append(T_NDARRAY)
        a = np.ascontiguousarray(v)
        _w_str(out, a.dtype.str)
        out += _U32.pack(a.ndim)
        for d in a.shape:
            out += _U32.pack(d)
        out += _U32.pack(a.nbytes)
        if segs is not None and a.nbytes >= _SG_MIN_BYTES:
            # zero-copy column: the array's OWN buffer becomes a wire
            # segment (writev-style) — no intermediate bytes object.
            # `a` is kept alive by the memoryview until the transport
            # consumes it.
            segs.append(out)
            segs.append(memoryview(a).cast("B"))
            out = bytearray()
        else:
            # one memcpy straight into the frame (the old path paid
            # two: tobytes() then +=)
            out += memoryview(a).cast("B")
    elif isinstance(v, (np.integer,)):
        out.append(T_INT)
        out += _I64.pack(int(v))
    elif isinstance(v, (np.floating,)):
        out.append(T_FLOAT)
        out += _F64.pack(float(v))
    elif isinstance(v, enum.Enum):
        cls_name = type(v).__name__
        if cls_name not in _ENUMS:
            raise TypeError(f"enum {cls_name} not registered for the wire")
        out.append(T_ENUM)
        _w_str(out, cls_name)
        out = _encode_into(out, v.value, segs)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        cls = type(v)
        cls_name = cls.__name__
        if cls_name not in _CLASSES:
            raise TypeError(f"dataclass {cls_name} not registered for the wire")
        out.append(T_DATACLASS)
        _w_str(out, cls_name)
        names = _field_names(cls)
        out += _U32.pack(len(names))
        for name in names:
            _w_str(out, name)
            out = _encode_into(out, getattr(v, name), segs)
    elif isinstance(v, tuple):
        out.append(T_TUPLE)
        out += _U32.pack(len(v))
        for item in v:
            out = _encode_into(out, item, segs)
    elif isinstance(v, list):
        out.append(T_LIST)
        out += _U32.pack(len(v))
        for item in v:
            out = _encode_into(out, item, segs)
    elif isinstance(v, dict):
        out.append(T_DICT)
        out += _U32.pack(len(v))
        for k, item in v.items():
            out = _encode_into(out, k, segs)
            out = _encode_into(out, item, segs)
    else:
        raise TypeError(f"type {type(v).__name__} not encodable for the wire")
    return out


def encode(v: Any) -> bytes:
    _register_defaults()
    out = bytearray()
    out = _encode_into(out, v, None)
    return bytes(out)


def encode_segments(v: Any) -> tuple[list, int]:
    """Encode `v` as an ordered list of wire segments plus the total
    byte length — the scatter-gather form `WireClient`/`WireServer`
    hand to `StreamWriter.writelines` after the frame header. Small
    values land in one bytearray segment (identical bytes to
    `encode`); large ndarray columns ride as zero-copy memoryviews."""
    _register_defaults()
    segs: list = []
    out = _encode_into(bytearray(), v, segs)
    if out:
        segs.append(out)
    return segs, sum(len(s) for s in segs)


def _need(mv: memoryview, o: int, n: int) -> None:
    """Bounds gate: the next `n` bytes must exist inside the frame."""
    if n < 0 or n > MAX_FRAME or o + n > len(mv):
        raise WireFormatError(
            f"wire value truncated or length prefix lies ({n} bytes "
            f"claimed at offset {o} of {len(mv)})")


def _ru32(mv: memoryview, o: int) -> tuple[int, int]:
    _need(mv, o, 4)
    return _U32.unpack_from(mv, o)[0], o + 4


def _r_str(mv: memoryview, o: int) -> tuple[str, int]:
    n, o = _ru32(mv, o)
    _need(mv, o, n)
    try:
        s = bytes(mv[o:o + n]).decode("utf-8")
    except UnicodeDecodeError as exc:
        raise WireFormatError(f"wire string is not UTF-8: {exc}") from None
    return s, o + n


def _decode_from(mv: memoryview, o: int,
                 copy_arrays: bool) -> tuple[Any, int]:
    _need(mv, o, 1)
    tag = mv[o]
    o += 1
    if tag == T_NONE:
        return None, o
    if tag == T_TRUE:
        return True, o
    if tag == T_FALSE:
        return False, o
    if tag == T_INT:
        _need(mv, o, 8)
        return _I64.unpack_from(mv, o)[0], o + 8
    if tag == T_FLOAT:
        _need(mv, o, 8)
        return _F64.unpack_from(mv, o)[0], o + 8
    if tag == T_STR:
        return _r_str(mv, o)
    if tag == T_BYTES:
        n, o = _ru32(mv, o)
        _need(mv, o, n)
        return bytes(mv[o:o + n]), o + n
    if tag == T_NDARRAY:
        dtype_s, o = _r_str(mv, o)
        try:
            dtype = np.dtype(dtype_s)
        except (TypeError, ValueError) as exc:
            raise WireFormatError(
                f"bad wire dtype {dtype_s!r}: {exc}") from None
        if dtype.hasobject:
            raise WireFormatError(
                f"object dtype {dtype_s!r} refused on the wire")
        ndim, o = _ru32(mv, o)
        if ndim > _MAX_NDIM:
            raise WireFormatError(f"ndarray claims {ndim} dims")
        shape = []
        count = 1
        for _ in range(ndim):
            d, o = _ru32(mv, o)
            shape.append(d)
            count *= d
        nbytes, o = _ru32(mv, o)
        # the header must agree with itself BEFORE any buffer is
        # touched: a dtype/shape pair lying about the payload size is a
        # hostile frame, not a short read
        if count * dtype.itemsize != nbytes:
            raise WireFormatError(
                f"ndarray header lies: shape {tuple(shape)} × "
                f"{dtype_s} = {count * dtype.itemsize} bytes, "
                f"header claims {nbytes}")
        _need(mv, o, nbytes)
        a = np.frombuffer(mv[o:o + nbytes], dtype).reshape(shape)
        if copy_arrays:
            a = a.copy()  # own the memory past the frame
        # else: read-only view over the received frame (zero-copy);
        # the frame buffer stays alive exactly as long as the array
        return a, o + nbytes
    if tag in (T_LIST, T_TUPLE):
        n, o = _ru32(mv, o)
        _need(mv, o, n)  # every element costs ≥1 tag byte
        items = []
        for _ in range(n):
            item, o = _decode_from(mv, o, copy_arrays)
            items.append(item)
        return (tuple(items) if tag == T_TUPLE else items), o
    if tag == T_DICT:
        n, o = _ru32(mv, o)
        _need(mv, o, n)
        d = {}
        for _ in range(n):
            k, o = _decode_from(mv, o, copy_arrays)
            v, o = _decode_from(mv, o, copy_arrays)
            d[k] = v
        return d, o
    if tag == T_ENUM:
        cls_name, o = _r_str(mv, o)
        value, o = _decode_from(mv, o, copy_arrays)
        cls = _ENUMS.get(cls_name)
        if cls is None:
            raise WireFormatError(
                f"enum {cls_name} not registered (wire decode refuses "
                "unknown types)")
        try:
            return cls(value), o
        except ValueError as exc:
            raise WireFormatError(
                f"enum {cls_name} has no value {value!r}: {exc}") from None
    if tag == T_DATACLASS:
        cls_name, o = _r_str(mv, o)
        n, o = _ru32(mv, o)
        _need(mv, o, n)
        # resolve the class BEFORE decoding fields: a frame naming an
        # unregistered class must die without its payload being walked
        cls = _CLASSES.get(cls_name)
        if cls is None:
            raise WireFormatError(
                f"dataclass {cls_name} not registered (wire decode "
                "refuses unknown types)")
        kwargs = {}
        for _ in range(n):
            name, o = _r_str(mv, o)
            value, o = _decode_from(mv, o, copy_arrays)
            kwargs[name] = value
        try:
            return cls(**kwargs), o
        except TypeError as exc:
            raise WireFormatError(
                f"dataclass {cls_name} field mismatch: {exc}") from None
    raise WireFormatError(f"bad wire tag {tag}")


def decode(payload: bytes | bytearray | memoryview, *,
           copy_arrays: bool = True) -> Any:
    """Decode one wire value. `copy_arrays=False` is the zero-copy fast
    path (wire rx loops): ndarrays come back as read-only views over
    `payload`, which must outlive them — it does by construction, since
    the view holds the buffer. Raises `WireFormatError` on any
    malformed frame, before any partial object escapes."""
    _register_defaults()
    mv = memoryview(payload)
    try:
        v, o = _decode_from(mv, 0, copy_arrays)
    except struct.error as exc:  # belt-and-braces: bounds gates come first
        raise WireFormatError(f"wire value truncated: {exc}") from None
    if o != len(mv):
        raise WireFormatError(
            f"trailing bytes after wire value ({len(mv) - o})")
    return v
