"""MessagePack, the subset the index artifacts use, with bulk paths for
the BM25 sections.

``pack(obj)`` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
and ``unpack(data)`` the object of ``msgpack.unpackb(data, raw=False,
strict_map_key=False)`` for None, bool, int (every width), float (as
float64), str, bytes, list/tuple and dict. No ``msgpack`` package is
needed: this module is the port's only MessagePack codec.

The BM25 postings and row maps are the bulk of a large artifact (60M
``str(row) -> tf`` entries at 1M chunks), and an encoder that takes one
Python step per entry costs minutes there. :func:`pack_int_map` and
:func:`pack_postings` write those maps from numpy arrays into the same
bytes ``pack`` would give for the equivalent dicts (a :class:`Raw` spliced
into the surrounding object), and :func:`unpack` takes ``hooks`` that
decode a map at a given key path in bulk (:func:`postings_hook`).
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_D = struct.Struct(">d")
_F = struct.Struct(">f")


class Raw:
    """Bytes already in MessagePack form: :func:`pack` splices them in
    verbatim where the object stands."""

    __slots__ = ("data",)

    def __init__(self, data) -> None:
        self.data = data


# -- headers -----------------------------------------------------------------


def _int_bytes(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes((v,))
        if v < 0x100:
            return b"\xcc" + bytes((v,))
        if v < 0x10000:
            return b"\xcd" + v.to_bytes(2, "big")
        if v < 0x100000000:
            return b"\xce" + v.to_bytes(4, "big")
        if v < 0x10000000000000000:
            return b"\xcf" + v.to_bytes(8, "big")
        raise OverflowError("Integer value out of range")
    if v >= -32:
        return bytes((v & 0xFF,))
    if v >= -0x80:
        return b"\xd0" + v.to_bytes(1, "big", signed=True)
    if v >= -0x8000:
        return b"\xd1" + v.to_bytes(2, "big", signed=True)
    if v >= -0x80000000:
        return b"\xd2" + v.to_bytes(4, "big", signed=True)
    if v >= -0x8000000000000000:
        return b"\xd3" + v.to_bytes(8, "big", signed=True)
    raise OverflowError("Integer value out of range")


def _sized(n: int, fix: int, fix_limit: int, codes: bytes, what: str) -> bytes:
    """A length header: ``fix | n`` below ``fix_limit`` (0 = none), else the
    8/16/32-bit form of ``codes`` (an 8-bit code of 0 = none)."""
    if n < fix_limit:
        return bytes((fix | n,))
    if codes[0] and n < 0x100:
        return bytes((codes[0], n))
    if n < 0x10000:
        return bytes((codes[1],)) + n.to_bytes(2, "big")
    if n < 0x100000000:
        return bytes((codes[2],)) + n.to_bytes(4, "big")
    raise ValueError(f"{what} is too large")


def _str_header(n: int) -> bytes:
    return _sized(n, 0xA0, 32, b"\xd9\xda\xdb", "unicode string")


def _bin_header(n: int) -> bytes:
    return _sized(n, 0, 0, b"\xc4\xc5\xc6", "memoryview")


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 16, b"\x00\xdc\xdd", "list")


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, b"\x00\xde\xdf", "dict")


# -- pack ----------------------------------------------------------------------

_SMALL_INTS = [bytes((i,)) for i in range(0x80)]
_STR_HEADERS = [_str_header(n) for n in range(0x100)]


def pack_str(s: str) -> bytes:
    """``pack(s)`` for a str."""
    raw = s.encode("utf-8")
    return (_STR_HEADERS[len(raw)] if len(raw) < 0x100 else _str_header(len(raw))) + raw


def pack_int(v: int) -> bytes:
    """``pack(v)`` for an int."""
    return _SMALL_INTS[v] if 0 <= v < 0x80 else _int_bytes(v)


def pack(obj: Any) -> bytes:
    """``obj`` as MessagePack: the bytes of ``msgpack.packb(obj,
    use_bin_type=True)``. Raises TypeError for other types (as msgpack
    does), ValueError for oversized values and OverflowError for ints
    outside 64 bits."""
    out: List[bytes] = []
    put = out.append

    def enc(o) -> None:
        t = type(o)
        if t is str:
            put(pack_str(o))
        elif t is int:
            put(pack_int(o))
        elif t is dict:
            put(_map_header(len(o)))
            for k, v in o.items():
                enc(k)
                enc(v)
        elif t is list or t is tuple:
            put(_array_header(len(o)))
            for v in o:
                enc(v)
        elif o is None:
            put(b"\xc0")
        elif t is bool:
            put(b"\xc3" if o else b"\xc2")
        elif t is float:
            put(b"\xcb" + _D.pack(o))
        elif t is bytes:
            put(_bin_header(len(o)) + o)
        elif t is Raw:
            put(o.data)
        else:
            enc_subclass(o)

    def enc_subclass(o) -> None:
        # subclasses of the supported types pack as their base type
        if isinstance(o, bool):
            put(b"\xc3" if o else b"\xc2")
        elif isinstance(o, int):
            put(_int_bytes(int(o)))
        elif isinstance(o, float):
            put(b"\xcb" + _D.pack(float(o)))
        elif isinstance(o, str):
            put(pack_str(str(o)))
        elif isinstance(o, (bytes, bytearray, memoryview)):
            raw = bytes(o)
            put(_bin_header(len(raw)) + raw)
        elif isinstance(o, dict):
            put(_map_header(len(o)))
            for k, v in o.items():
                enc(k)
                enc(v)
        elif isinstance(o, (list, tuple)):
            put(_array_header(len(o)))
            for v in o:
                enc(v)
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} object")

    enc(obj)
    return b"".join(out)


# -- unpack --------------------------------------------------------------------

Hook = Callable[[bytes, int], Tuple[Any, int]]


class _Truncated(ValueError):
    pass


def _need(data: bytes, end: int) -> None:
    if end > len(data):
        raise _Truncated("Unpack failed: incomplete input")


def _unpack_at(data: bytes, pos: int, hooks=None, path=()) -> Tuple[Any, int]:
    """The object at ``pos`` → (object, position after it). ``hooks``
    maps key paths (tuples of map keys from the top) to bulk decoders."""
    if pos >= len(data):
        raise _Truncated("Unpack failed: incomplete input")
    b = data[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        end = pos + (b & 0x1F)
        _need(data, end)
        return data[pos:end].decode("utf-8"), end
    if 0x80 <= b <= 0x8F:
        return _unpack_map(data, pos, b & 0x0F, hooks, path)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(data, pos, b & 0x0F, hooks)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if 0xCC <= b <= 0xD3:
        width = (1, 2, 4, 8)[(b - 0xCC) & 3]
        end = pos + width
        _need(data, end)
        return int.from_bytes(data[pos:end], "big", signed=b >= 0xD0), end
    if b == 0xCB:
        _need(data, pos + 8)
        return _D.unpack_from(data, pos)[0], pos + 8
    if b == 0xCA:
        _need(data, pos + 4)
        return _F.unpack_from(data, pos)[0], pos + 4
    if b in (0xD9, 0xDA, 0xDB, 0xC4, 0xC5, 0xC6):
        width = {0xD9: 1, 0xDA: 2, 0xDB: 4, 0xC4: 1, 0xC5: 2, 0xC6: 4}[b]
        _need(data, pos + width)
        n = int.from_bytes(data[pos:pos + width], "big")
        pos += width
        end = pos + n
        _need(data, end)
        if b >= 0xD9:
            return data[pos:end].decode("utf-8"), end
        return bytes(data[pos:end]), end
    if b in (0xDC, 0xDD, 0xDE, 0xDF):
        width = 2 if b in (0xDC, 0xDE) else 4
        _need(data, pos + width)
        n = int.from_bytes(data[pos:pos + width], "big")
        pos += width
        if b >= 0xDE:
            return _unpack_map(data, pos, n, hooks, path)
        return _unpack_array(data, pos, n, hooks)
    raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")


def _unpack_array(data, pos, n, hooks):
    out = []
    for _ in range(n):
        v, pos = _unpack_at(data, pos, hooks, None)
        out.append(v)
    return out, pos


def _unpack_map(data, pos, n, hooks, path):
    out = {}
    for _ in range(n):
        k, pos = _unpack_at(data, pos, None, None)
        sub = None
        if hooks is not None and path is not None:
            sub = path + (k,)
            hook = hooks.get(sub)
            if hook is not None:
                out[k], pos = hook(data, pos)
                continue
            if not any(p[: len(sub)] == sub for p in hooks):
                sub = None
        v, pos = _unpack_at(data, pos, hooks if sub is not None else None, sub)
        out[k] = v
    return out, pos


def unpack(data, hooks: Optional[Dict[tuple, Hook]] = None) -> Any:
    """The object of ``msgpack.unpackb(data, raw=False,
    strict_map_key=False)``. ``hooks``: ``{key path: decoder}``, where a
    decoder ``(data, pos) -> (value, pos after the map)`` replaces the
    generic decoding of the value at that path. Raises ValueError
    (incomplete input, extra data, an unsupported type) or
    UnicodeDecodeError."""
    data = bytes(data)
    obj, pos = _unpack_at(data, 0, hooks, () if hooks else None)
    if pos != len(data):
        raise ValueError("Unpack failed: extra data")
    return obj


# -- bulk int maps ---------------------------------------------------------------

_POW10 = np.array([10 ** i for i in range(19)], dtype=np.int64)


def _key_matrix(keys: np.ndarray, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """``str(k)`` as fixstr MessagePack for non-negative int64 keys of at
    most ``width`` digits → (bytes [n, 8·q] uint8, left-aligned, padded to
    whole 8-byte words, each key's byte length)."""
    nd = np.ones(len(keys), dtype=np.int64)
    for i in range(1, width):
        nd += keys >= _POW10[i]
    out = np.zeros((len(keys), 8 * (-(-(1 + width) // 8))), dtype=np.uint8)
    out[:, 0] = 0xA0 | nd
    for j in range(width):
        out[:, 1 + j] = (keys // _POW10[np.maximum(nd - 1 - j, 0)]) % 10 + 0x30
    return out, 1 + nd


def _val_matrix(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Non-negative ints as MessagePack (fixint or uint8/16/32/64) → (bytes
    [n, widest] uint8, padded, each value's byte length)."""
    if not len(vals) or vals.max() < 0x80:
        return vals.astype(np.uint8)[:, None], np.ones(len(vals), dtype=np.int64)
    vlen = np.where(vals < 0x80, 1, np.where(vals < 0x100, 2, np.where(
        vals < 0x10000, 3, np.where(vals < 0x100000000, 5, 9))))
    width = int(vlen.max())
    out = np.zeros((len(vals), width), dtype=np.uint8)
    code = np.select([vlen == 2, vlen == 3, vlen == 5, vlen == 9], [0xCC, 0xCD, 0xCE, 0xCF], 0)
    out[:, 0] = np.where(vlen == 1, vals, code)
    for j in range(1, width):  # big-endian payload
        out[:, j] = np.where(j < vlen, (vals >> (8 * np.maximum(vlen - 1 - j, 0))) & 0xFF, 0)
    return out, vlen


def _key_table(kmax: int):
    """The fixstr bytes of every key in ``[0, kmax]`` as 8-byte words →
    (words [kmax + 1, q] uint64, byte lengths)."""
    table, tlen = _key_matrix(np.arange(kmax + 1, dtype=np.int64), len(str(kmax)))
    return table.view("<u8"), tlen


def _int_entries(keys: np.ndarray, vals: np.ndarray, table=None) -> Tuple[np.ndarray, np.ndarray]:
    """The MessagePack bytes of the map entries ``str(key): val`` (keys
    and values non-negative) → (bytes uint8, each entry's end offset).
    Keys repeat in postings (a row per term it holds), so their bytes come
    from ``table`` (:func:`_key_table` over the key range) when given."""
    keys = np.asarray(keys, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.int64)
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    if keys.min() < 0 or vals.min() < 0:
        raise ValueError("bulk int maps take non-negative keys and values")
    if table is not None and int(keys.max()) < len(table[0]):
        kb, klen = table[0][keys].view(np.uint8).reshape(n, -1), table[1][keys]
    else:
        kb, klen = _key_matrix(keys, len(str(int(keys.max()))))
    vb, vlen = _val_matrix(vals)
    mask = np.concatenate([np.arange(kb.shape[1]) < klen[:, None],
                           np.arange(vb.shape[1]) < vlen[:, None]], axis=1)
    out = np.concatenate([kb, vb], axis=1)[mask]
    return out, np.cumsum(klen + vlen)


WORKERS = min(8, os.cpu_count() or 1)  # threads of the bulk codecs


def map_slabs(fn, items):
    """``[fn(x) for x in items]`` on a thread pool of :data:`WORKERS`
    (numpy and zlib release the GIL in the work of the bulk codecs)."""
    if len(items) < 2:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(max_workers=WORKERS) as pool:
        return list(pool.map(fn, items))


def pack_int_map(keys, vals) -> Raw:
    """``{str(k): v for k, v in zip(keys, vals)}`` (non-negative ints) as
    MessagePack, built from the arrays in bulk."""
    body, _ = _int_entries(keys, vals)
    return Raw(_map_header(len(keys)) + body.tobytes())


def pack_postings(terms: Sequence[str], indptr, rows, tfs, slab: int = 1 << 20) -> Raw:
    """``{term: {str(row): tf, ...}, ...}`` — term ``i``'s entries are
    ``rows[indptr[i]:indptr[i+1]]`` with their ``tfs`` — as MessagePack,
    the entries built in bulk, about ``slab`` postings per task."""
    indptr = np.asarray(indptr, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    tfs = np.asarray(tfs, dtype=np.int64)
    table = None
    if len(rows) and rows.min() >= 0 and int(rows.max()) < max(1 << 22, 4 * len(rows)):
        table = _key_table(int(rows.max()))
    spans, t0 = [], 0
    while t0 < len(terms):
        t1 = int(np.searchsorted(indptr, indptr[t0] + slab, side="right")) - 1
        t1 = min(max(t1, t0 + 1), len(terms))
        spans.append((t0, t1))
        t0 = t1

    def build(span):
        a, b = span
        return _int_entries(rows[indptr[a]:indptr[b]], tfs[indptr[a]:indptr[b]], table)

    pieces: List = [_map_header(len(terms))]
    for (a, b), (body, ends) in zip(spans, map_slabs(build, spans)):
        view, lo = memoryview(body), int(indptr[a])
        for t in range(a, b):
            x, y = int(indptr[t]) - lo, int(indptr[t + 1]) - lo
            pieces.append(pack_str(terms[t]) + _map_header(y - x))
            pieces.append(view[(int(ends[x - 1]) if x else 0):(int(ends[y - 1]) if y else 0)])
    return Raw(b"".join(pieces))


def _container_len(data: bytes, pos: int, fix: int, codes: bytes, what: str) -> Tuple[int, int]:
    if pos >= len(data):
        raise _Truncated("Unpack failed: incomplete input")
    b = data[pos]
    if fix <= b <= fix + 0x0F:
        return b & 0x0F, pos + 1
    if b in codes:
        width = 2 if b == codes[0] else 4
        _need(data, pos + 1 + width)
        return int.from_bytes(data[pos + 1:pos + 1 + width], "big"), pos + 1 + width
    raise ValueError(f"expected {what}")


def _map_len(data: bytes, pos: int) -> Tuple[int, int]:
    """A map header at ``pos`` → (entries, position after the header)."""
    return _container_len(data, pos, 0x80, b"\xde\xdf", "a map")


def array_len(data: bytes, pos: int) -> Tuple[int, int]:
    """An array header at ``pos`` → (elements, position after the header)."""
    return _container_len(data, pos, 0x90, b"\xdc\xdd", "an array")


array_header = _array_header
unpack_at = _unpack_at


def _swar_digits(word: np.ndarray, length: np.ndarray) -> Optional[np.ndarray]:
    """Decimal strings of 1-8 ASCII digits, each read as the 8 bytes that
    start it (``word``, little-endian: the first digit in the low byte;
    bytes past ``length`` are ignored) → their int64 values, or None when
    a byte inside a string is no digit. Eight digits fold in three
    multiply-shift steps (each step joins neighbouring lanes)."""
    u = np.uint64
    shift = u(8) * (u(8) - length.astype(np.uint64))
    x = word << shift  # drop the bytes past the string; zero bytes lead
    inside = ~((u(1) << shift) - u(1))
    if ((x & inside & u(0xF0F0F0F0F0F0F0F0)) != (u(0x3030303030303030) & inside)).any():
        return None
    if (((x & inside & u(0x0F0F0F0F0F0F0F0F)) + u(0x0606060606060606)) & u(0xF0F0F0F0F0F0F0F0)).any():
        return None
    x = x & u(0x0F0F0F0F0F0F0F0F)
    x = (x * u(2561)) >> u(8)
    x = ((x & u(0x00FF00FF00FF00FF)) * u(6553601)) >> u(16)
    x = ((x & u(0x0000FFFF0000FFFF)) * u(42949672960001)) >> u(32)
    return x.astype(np.int64)


def _postings_fast(data: bytes, pos: int, slab: int = 1 << 20):
    """The bulk decoding of a postings map whose rows are decimal fixstr
    keys of at most 8 digits and whose tfs are positive fixints (bytes
    below 0x80: every byte at or above 0x80 in the map is then a key
    header, except inside term strings and map headers, which the per-term
    loop reads). None when the map is not of that form."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n_terms, pos = _map_len(data, pos)
    marks = np.flatnonzero(buf[pos:] >= 0x80) + pos
    terms, firsts, counts = [], [], []
    for _ in range(n_terms):
        term, pos = _unpack_at(data, pos)
        if type(term) is not str:
            return None
        n, pos = _map_len(data, pos)
        i0 = int(np.searchsorted(marks, pos))
        if n:
            if i0 + n > len(marks) or marks[i0] != pos:
                return None
            last = int(marks[i0 + n - 1])
            head = int(buf[last])
            if head & 0xE0 != 0xA0:
                return None
            pos = last + (head & 0x1F) + 2
        terms.append(term)
        firsts.append(i0)
        counts.append(n)
    counts = np.asarray(counts, dtype=np.int64)
    indptr = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    total = int(indptr[-1])
    idx = np.repeat(np.asarray(firsts, dtype=np.int64) - indptr[:-1], counts) + np.arange(total)
    # consecutive entries of a term must abut: then the marks are the
    # entries' headers, exactly as a sequential parse finds them
    last_of_term = np.zeros(total, dtype=bool)
    last_of_term[indptr[1:][counts > 0] - 1] = True
    padded = np.concatenate([buf, np.zeros(32, dtype=np.uint8)])
    words = np.ndarray((len(padded) - 8,), dtype="<u8", buffer=padded, strides=(1,))
    rows = np.empty(total, dtype=np.int64)
    tfs = np.empty(total, dtype=np.int64)

    def decode(lo: int) -> bool:
        sl = slice(lo, lo + slab)
        h = marks[idx[sl]]
        hb = padded[h].astype(np.int64)
        length = hb & 0x1F
        if ((hb & 0xE0) != 0xA0).any() or length.min() < 1 or length.max() > 8:
            return False
        row = _swar_digits(words[h + 1], length)
        if row is None:
            return False
        tf = padded[h + length + 1]
        if (tf >= 0x80).any():
            return False
        inner = ~last_of_term[sl]
        if (marks[idx[sl][inner] + 1] != (h + length + 2)[inner]).any():
            return False
        rows[sl] = row
        tfs[sl] = tf
        return True

    if not all(map_slabs(decode, list(range(0, total, slab)))):
        return None
    return (terms, indptr, rows, tfs), pos


def int_map_hook(data: bytes, pos: int):
    """:func:`unpack` hook for a map ``{str(int): int}`` (BM25 lengths, row
    maps) → ``((keys int64, values int64), pos)`` in the map's order, read
    in one tight loop (a key or value of another form raises)."""
    n, p = _map_len(data, pos)
    keys = np.empty(n, dtype=np.int64)
    vals = np.empty(n, dtype=np.int64)
    size = len(data)
    for i in range(n):
        b = data[p]
        if not 0xA0 <= b <= 0xBF or p + 1 + (b & 0x1F) > size:
            raise ValueError("int map: a key is not a short decimal string")
        q = p + 1 + (b & 0x1F)
        keys[i] = int(data[p + 1:q])
        v = data[q]
        if v < 0x80:
            vals[i], p = v, q + 1
        elif 0xCC <= v <= 0xCF:
            w = 1 << (v - 0xCC)
            if q + 1 + w > size:
                raise _Truncated("Unpack failed: incomplete input")
            vals[i], p = int.from_bytes(data[q + 1:q + 1 + w], "big"), q + 1 + w
        else:
            vals[i], p = _unpack_at(data, q)
    return (keys, vals), p


def postings_hook(data: bytes, pos: int):
    """:func:`unpack` hook for a BM25 postings map ``{term: {str(row):
    tf}}`` → ``((terms, indptr int64, rows int64, tfs int64), pos)``,
    terms in the map's order and each term's rows in its map's order. The
    bulk path reads the form :func:`pack_postings` writes for tfs below
    128; any other map decodes entry by entry, with the same result."""
    try:
        fast = _postings_fast(data, pos)
    except ValueError:  # a misread under the fast form's assumption
        fast = None
    if fast is not None:
        return fast
    obj, end = _unpack_at(data, pos)
    terms = list(obj)
    counts = [len(obj[t]) for t in terms]
    indptr = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    rows = np.fromiter((int(r) for t in terms for r in obj[t]), dtype=np.int64, count=int(indptr[-1]))
    tfs = np.fromiter((int(v) for t in terms for v in obj[t].values()), dtype=np.int64,
                      count=int(indptr[-1]))
    return (terms, indptr, rows, tfs), end
