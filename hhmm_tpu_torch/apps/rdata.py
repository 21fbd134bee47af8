"""Minimal pure-Python reader for R workspace files (``.RData``).

The reference's tick dataset (`tayal2009/data/<SYM>.TO/*.RData`,
`tayal2009/main.R:15-58`) is stored as gzipped R serialization
("RDX2", format version 2/3, XDR byte order): each file holds one
binding, an ``xts`` double matrix with a POSIXct ``index`` attribute
and PRICE/SIZE columns. R is not a dependency, so this module
implements the subset of the serialization grammar those files (and R
workspaces generally) use: pairlists, symbols, character /
logical / integer / real / complex / raw / string / generic vectors,
attributes, reference objects, and the common ALTREP wrappers
(compact integer/real sequences and wrapped vectors).

Format reference: R Internals §"Serialization Formats" (public
documentation of the RDX2 grammar); no reference-project code exists
for this (the reference loads the files with base R's ``load``).
"""

from __future__ import annotations

import gzip
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["RVector", "load_rdata", "load_tick_rdata", "load_tick_days_rdata"]

# SEXP type codes (R Internals, SEXPTYPE table)
_NILSXP = 0
_SYMSXP = 1
_LISTSXP = 2
_CLOSXP = 3
_ENVSXP = 4
_PROMSXP = 5
_LANGSXP = 6
_CHARSXP = 9
_LGLSXP = 10
_INTSXP = 13
_REALSXP = 14
_CPLXSXP = 15
_STRSXP = 16
_DOTSXP = 17
_VECSXP = 19
_EXPRSXP = 20
_RAWSXP = 24
_S4SXP = 25

# serialization pseudo-types (serialize.c)
_REFSXP = 255
_NILVALUE_SXP = 254
_GLOBALENV_SXP = 253
_UNBOUNDVALUE_SXP = 252
_MISSINGARG_SXP = 251
_BASENAMESPACE_SXP = 250
_NAMESPACESXP = 249
_PACKAGESXP = 248
_PERSISTSXP = 247
_EMPTYENV_SXP = 242
_BASEENV_SXP = 241
_ATTRLANGSXP = 240
_ATTRLISTSXP = 239
_ALTREP_SXP = 238

_HAS_OBJ = 0x100
_HAS_ATTR = 0x200
_HAS_TAG = 0x400

_NA_INTEGER = -2147483648


@dataclass
class RVector:
    """A decoded R vector: ``values`` is a NumPy array (atomic types),
    a list of ``str | None`` (character vectors), or a list of decoded
    children (generic vectors); ``attributes`` maps attribute name →
    decoded value."""

    values: Any
    attributes: Dict[str, Any] = field(default_factory=dict)

    @property
    def dim(self) -> Optional[Tuple[int, ...]]:
        d = self.attributes.get("dim")
        return None if d is None else tuple(int(v) for v in d.values)

    def matrix(self) -> np.ndarray:
        """Column-major (R layout) reshape to the ``dim`` attribute."""
        d = self.dim
        if d is None:
            raise ValueError("R object has no dim attribute")
        return np.asarray(self.values).reshape(d, order="F")

    def colnames(self) -> Optional[List[Optional[str]]]:
        dn = self.attributes.get("dimnames")
        if dn is None or len(dn.values) < 2 or dn.values[1] is None:
            return None
        col = dn.values[1]
        return list(col.values) if isinstance(col, RVector) else None


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.refs: List[Any] = []

    # --- primitives (XDR = big-endian) ---
    def _int(self) -> int:
        (v,) = struct.unpack_from(">i", self.buf, self.pos)
        self.pos += 4
        return v

    def _ints(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.buf, dtype=">i4", count=n, offset=self.pos)
        self.pos += 4 * n
        return out.astype(np.int32)

    def _doubles(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.buf, dtype=">f8", count=n, offset=self.pos)
        self.pos += 8 * n
        return out.astype(np.float64)

    def _bytes(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def _length(self) -> int:
        n = self._int()
        if n == -1:  # long vector: upper/lower 32-bit halves
            hi, lo = self._int(), self._int()
            n = (hi << 32) | (lo & 0xFFFFFFFF)
        return n

    # --- grammar ---
    def read_header(self) -> None:
        if self._bytes(2) != b"X\n":
            raise ValueError("only XDR-format R serialization is supported")
        version = self._int()
        self._int()  # writer version
        self._int()  # min reader version
        if version not in (2, 3):
            raise ValueError(f"unsupported serialization version {version}")
        if version == 3:
            n = self._int()  # native encoding string
            self._bytes(n)

    def read_item(self) -> Any:
        flags = self._int()
        ptype = flags & 0xFF

        if ptype == _NILVALUE_SXP or ptype == _NILSXP:
            return None
        if ptype == _REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self._int()
            return self.refs[idx - 1]
        if ptype == _SYMSXP:
            name = self.read_item()  # CHARSXP
            self.refs.append(name)
            return name
        if ptype in (_PACKAGESXP, _NAMESPACESXP, _PERSISTSXP):
            self._int()  # string-vector marker
            obj = ("namespace", self._read_strsxp_body())
            self.refs.append(obj)
            return obj
        if ptype in (_GLOBALENV_SXP, _EMPTYENV_SXP, _BASEENV_SXP,
                     _UNBOUNDVALUE_SXP, _MISSINGARG_SXP, _BASENAMESPACE_SXP):
            return ("env", ptype)
        if ptype == _ENVSXP:
            obj: Dict[str, Any] = {}
            self.refs.append(obj)
            self._int()  # locked flag
            self.read_item()  # enclosure
            frame = self.read_item()  # frame pairlist
            self.read_item()  # hash table
            self.read_item()  # attributes
            if isinstance(frame, _Pairlist):
                obj.update(frame.to_dict())
            return obj
        if ptype in (_LISTSXP, _LANGSXP, _ATTRLISTSXP, _ATTRLANGSXP,
                     _CLOSXP, _PROMSXP, _DOTSXP):
            attrs = self.read_item() if flags & _HAS_ATTR else None
            tag = self.read_item() if flags & _HAS_TAG else None
            car = self.read_item()
            cdr = self.read_item()
            return _Pairlist(tag, car, cdr, attrs)
        if ptype == _CHARSXP:
            n = self._int()
            if n == -1:
                return None  # NA_character_
            return self._bytes(n).decode("utf-8", errors="replace")
        if ptype == _ALTREP_SXP:
            return self._read_altrep()

        # vector types: data, then attributes if flagged
        if ptype == _LGLSXP or ptype == _INTSXP:
            n = self._length()
            vals = self._ints(n)
            return self._finish_vector(flags, vals)
        if ptype == _REALSXP:
            n = self._length()
            return self._finish_vector(flags, self._doubles(n))
        if ptype == _CPLXSXP:
            n = self._length()
            d = self._doubles(2 * n)
            return self._finish_vector(flags, d[0::2] + 1j * d[1::2])
        if ptype == _RAWSXP:
            n = self._length()
            return self._finish_vector(
                flags, np.frombuffer(self._bytes(n), dtype=np.uint8)
            )
        if ptype == _STRSXP:
            n = self._length()
            vals = [self.read_item() for _ in range(n)]
            return self._finish_vector(flags, vals)
        if ptype in (_VECSXP, _EXPRSXP):
            n = self._length()
            vals = [self.read_item() for _ in range(n)]
            return self._finish_vector(flags, vals)
        if ptype == _S4SXP:
            attrs = self.read_item() if flags & _HAS_ATTR else None
            return RVector(None, _attrs_to_dict(attrs))
        raise ValueError(f"unsupported SEXP type {ptype} at offset {self.pos}")

    def _read_strsxp_body(self) -> List[Optional[str]]:
        n = self._length()
        return [self.read_item() for _ in range(n)]

    def _finish_vector(self, flags: int, values: Any) -> RVector:
        attrs = self.read_item() if flags & _HAS_ATTR else None
        return RVector(values, _attrs_to_dict(attrs))

    def _read_altrep(self) -> Any:
        info = self.read_item()  # pairlist: class symbol, package, type
        state = self.read_item()
        attr = self.read_item()
        cls = info.car if isinstance(info, _Pairlist) else None
        cls_name = cls if isinstance(cls, str) else None
        if cls_name == "compact_intseq":
            n, start, incr = np.asarray(state.values, dtype=np.float64)
            vals = (start + incr * np.arange(int(n))).astype(np.int32)
            return RVector(vals, _attrs_to_dict(attr))
        if cls_name == "compact_realseq":
            n, start, incr = np.asarray(state.values, dtype=np.float64)
            return RVector(start + incr * np.arange(int(n)), _attrs_to_dict(attr))
        if cls_name in ("wrap_real", "wrap_integer", "wrap_logical",
                        "wrap_string", "wrap_complex", "wrap_raw"):
            payload = _altrep_payload(state)
            if isinstance(payload, RVector):
                payload.attributes.update(_attrs_to_dict(attr))
                return payload
            return RVector(payload, _attrs_to_dict(attr))
        if cls_name == "deferred_string":
            # state = (data to convert, metadata); realize eagerly
            payload = _altrep_payload(state)
            vals = [str(v) for v in np.asarray(payload.values)]
            return RVector(vals, _attrs_to_dict(attr))
        raise ValueError(f"unsupported ALTREP class {cls_name!r}")


def _altrep_payload(state):
    """The wrapped data of an ALTREP wrapper state. R serializes wrapper
    state as the pairlist CONS(wrapped, metadata) (altclasses.c); older
    writers used a generic vector (data, metadata)."""
    if isinstance(state, _Pairlist):
        return state.car
    if isinstance(state, RVector) and isinstance(state.values, list):
        return state.values[0]
    return state


@dataclass
class _Pairlist:
    tag: Any
    car: Any
    cdr: Any
    attrs: Any = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        node: Any = self
        while isinstance(node, _Pairlist):
            if isinstance(node.tag, str):
                out[node.tag] = node.car
            node = node.cdr
        return out


def _attrs_to_dict(attrs: Any) -> Dict[str, Any]:
    return attrs.to_dict() if isinstance(attrs, _Pairlist) else {}


def load_rdata(path: str) -> Dict[str, Any]:
    """Decode every top-level binding in an ``.RData`` file → name → value
    (``RVector`` for vectors/matrices)."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        raw = gzip.decompress(f.read()) if head == b"\x1f\x8b" else f.read()
    if not raw.startswith(b"RDX2\n") and not raw.startswith(b"RDX3\n"):
        raise ValueError(f"{path}: not an RDX2/RDX3 RData file")
    r = _Reader(raw[5:])
    r.read_header()
    top = r.read_item()
    if isinstance(top, _Pairlist):
        return top.to_dict()
    raise ValueError(f"{path}: top-level object is not a bindings pairlist")


def _parse_index_seconds(obj: RVector) -> np.ndarray:
    """The xts time index: an ``index`` attribute of POSIXct seconds
    (UTC epoch), or a zoo-style separate index object."""
    idx = obj.attributes.get("index")
    if idx is None:
        raise ValueError("xts object has no index attribute")
    return np.asarray(idx.values, dtype=np.float64)


def load_tick_rdata(path: str) -> Dict[str, np.ndarray]:
    """One tick day from a reference-format ``.RData``: the file's single
    xts binding → ``{"price", "size", "t_seconds"}`` with NA rows dropped
    (the driver's ``na.omit(series[, 1:2])``, `tayal2009/main.R:57`)."""
    bindings = load_rdata(path)
    xts = [v for v in bindings.values() if isinstance(v, RVector) and v.dim]
    if len(xts) != 1:
        raise ValueError(
            f"{path}: expected exactly one matrix binding, got {sorted(bindings)}"
        )
    obj = xts[0]
    mat = obj.matrix()
    if mat.ndim != 2 or mat.shape[1] < 2:
        raise ValueError(f"{path}: expected an [n, >=2] tick matrix, got {mat.shape}")
    t = _parse_index_seconds(obj)
    names = obj.colnames()
    if names and "PRICE" in names and "SIZE" in names:
        price = mat[:, names.index("PRICE")]
        size = mat[:, names.index("SIZE")]
    else:  # driver convention: first two columns are PRICE, SIZE
        price, size = mat[:, 0], mat[:, 1]
    ok = np.isfinite(price) & np.isfinite(size)
    price, size, t = price[ok], size[ok], t[ok]
    if np.any(np.diff(t) < 0):
        order = np.argsort(t, kind="stable")
        price, size, t = price[order], size[order], t[order]
    return {"price": price, "size": size, "t_seconds": t}


_DAY_RE = re.compile(r"(\d{4}[.\-]\d{2}[.\-]\d{2})")


def load_tick_days_rdata(
    directory: str, symbol: Optional[str] = None, days: Optional[int] = None
) -> List[Dict[str, np.ndarray]]:
    """All ``*.RData`` tick days in ``directory`` ordered by the date in
    the file name — the RData twin of
    :func:`hhmm_tpu_torch.apps.data_io.load_tick_days`."""
    entries = []
    for name in os.listdir(directory):
        if not name.endswith(".RData"):
            continue
        if symbol is not None and symbol not in name:
            continue
        m = _DAY_RE.search(name)
        if m is None:
            raise ValueError(f"{name}: no YYYY.MM.DD date in file name")
        entries.append((m.group(1).replace("-", "."), name))
    if not entries:
        raise ValueError(f"no matching .RData files in {directory}")
    entries.sort()
    if days is not None:
        entries = entries[:days]
    return [load_tick_rdata(os.path.join(directory, name)) for _, name in entries]
