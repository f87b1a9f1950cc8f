"""Avro binary codec + object container files, from scratch.

Port of ``photon_tpu/io/avro.py``, copied because the port imports nothing
of the JAX package. A container either package writes, the other reads.

Parity: the reference stores ALL data and models as Avro on HDFS
(⟦photon-client/.../data/avro/AvroUtils.scala⟧, ⟦photon-avro-schemas/⟧ —
SURVEY.md §2.3/§2.4). No Avro library ships in this image, so this module
implements the Avro 1.x specification directly:

* primitive binary encodings — zigzag-varint ``int``/``long``, little-endian
  IEEE ``float``/``double``, length-prefixed ``bytes``/``string``;
* complex types — records (fields in declaration order), enums (index),
  arrays/maps (blocks terminated by count 0), unions (branch index then
  value), fixed;
* object container files — ``Obj\\x01`` magic, file-metadata map carrying the
  writer schema JSON + codec, 16-byte sync marker, and data blocks of
  (record count, byte length, payload, sync); ``null`` and ``deflate``
  (raw zlib) codecs.

Python values map naturally: records ↔ dicts, arrays ↔ lists, maps ↔ dicts,
enums ↔ strings, null union branches ↔ None. Schemas are plain parsed-JSON
dicts; named-type references are resolved through a registry so photon's
nested ``NameTermValueAvro`` reuse works.

The readers decode training data with the native block decoder
(``io/streaming.py``); this codec is the per-record reference and fallback,
and it writes every container.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterable, Iterator, Optional, Union

MAGIC = b"Obj\x01"
SYNC_SIZE = 16

_PRIMITIVES = frozenset(
    ("null", "boolean", "int", "long", "float", "double", "bytes", "string")
)
_FLOAT = struct.Struct("<f")
_DOUBLE = struct.Struct("<d")

Schema = Union[str, dict, list]


# ---------------------------------------------------------------------------
# schema handling


class SchemaError(ValueError):
    pass


def parse_schema(schema: Union[str, Schema]) -> Schema:
    """Accept a JSON string or an already-parsed schema object."""
    if isinstance(schema, str) and schema.lstrip().startswith(("{", "[", '"')):
        return json.loads(schema)
    return schema


def _collect_names(schema: Schema, names: dict) -> None:
    """Register named types (record/enum/fixed) for by-name references."""
    if isinstance(schema, list):
        for s in schema:
            _collect_names(s, names)
    elif isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed"):
            name = schema["name"]
            ns = schema.get("namespace")
            full = f"{ns}.{name}" if ns and "." not in name else name
            names[full] = schema
            names[name.split(".")[-1]] = schema
        if t == "record":
            for f in schema.get("fields", ()):
                _collect_names(f["type"], names)
        elif t == "array":
            _collect_names(schema["items"], names)
        elif t == "map":
            _collect_names(schema["values"], names)


def _resolve(schema: Schema, names: dict) -> Schema:
    if isinstance(schema, str) and schema not in _PRIMITIVES:
        try:
            return names[schema]
        except KeyError:
            raise SchemaError(f"unresolved named type {schema!r}") from None
    if isinstance(schema, dict) and isinstance(schema.get("type"), str) and (
        schema["type"] not in _PRIMITIVES
        and schema["type"] not in ("record", "enum", "fixed", "array", "map")
    ):
        return _resolve(schema["type"], names)
    return schema


# ---------------------------------------------------------------------------
# primitive binary encoding


_ONE_BYTE = tuple(bytes((b,)) for b in range(0x80))


def _write_long(out: BinaryIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)  # zigzag
    if n < 0x80:  # one byte: most lengths, counts and union branches
        out.write(_ONE_BYTE[n])
        return
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes((b | 0x80,)))
        else:
            out.write(bytes((b,)))
            return


def encode_long(n: int) -> bytes:
    """The zigzag-varint bytes of ``n`` (what ``_write_long`` writes)."""
    n = (n << 1) ^ (n >> 63)
    if n < 0x80:
        return _ONE_BYTE[n]
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def encode_string(s: str) -> bytes:
    """A ``string``'s bytes: its utf-8 length, then the utf-8."""
    b = s.encode("utf-8")
    return encode_long(len(b)) + b


def _read_long(buf: memoryview, pos: int) -> tuple[int, int]:
    b = buf[pos]
    if b < 0x80:  # one byte: most lengths, counts and union branches
        return (b >> 1) ^ -(b & 1), pos + 1
    shift = 0
    acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1), pos


# ---------------------------------------------------------------------------
# schema-driven encode


class Encoder:
    """Schema-driven encoder, compiled once into nested closures as the
    ``Decoder`` is; a union still matches each value against its branches."""

    def __init__(self, schema: Union[str, Schema]):
        self.schema = parse_schema(schema)
        self.names: dict = {}
        _collect_names(self.schema, self.names)
        self._encode = self._compile(self.schema, {})

    def encode(self, value: Any, out: Optional[BinaryIO] = None) -> bytes:
        buf = out or io.BytesIO()
        self._encode(value, buf)
        return b"" if out is not None else buf.getvalue()

    def _compile(self, schema: Schema, named: dict):
        """``fn(value, out)`` for ``schema``; ``named`` as in ``Decoder``."""
        schema = _resolve(schema, self.names)
        if isinstance(schema, list):  # union
            branches = [(_resolve(b, self.names), self._compile(b, named))
                        for b in schema]

            def enc_union(v, out):
                for i, (branch, fn) in enumerate(branches):
                    if _union_match(branch, v):
                        _write_long(out, i)
                        fn(v, out)
                        return
                raise SchemaError(f"value {v!r} matches no union branch {schema}")
            return enc_union
        t = schema if isinstance(schema, str) else schema["type"]
        if t == "null":
            return lambda v, out: None
        if t == "boolean":
            return lambda v, out: out.write(b"\x01" if v else b"\x00")
        if t in ("int", "long"):
            return lambda v, out: _write_long(out, int(v))
        if t in ("float", "double"):
            pack = (_FLOAT if t == "float" else _DOUBLE).pack
            return lambda v, out: out.write(pack(float(v)))
        if t in ("bytes", "string"):
            as_str = t == "string"

            def enc_bytes(v, out):
                b = v.encode("utf-8") if as_str else v
                _write_long(out, len(b))
                out.write(b)
            return enc_bytes
        if t == "fixed":
            size = schema["size"]

            def enc_fixed(v, out):
                if len(v) != size:
                    raise SchemaError("fixed size mismatch")
                out.write(v)
            return enc_fixed
        if t == "enum":
            symbols = schema["symbols"]
            return lambda v, out: _write_long(out, symbols.index(v))
        if t in ("array", "map"):
            is_map = t == "map"
            item = self._compile(schema["values" if is_map else "items"], named)
            key = self._compile("string", named)

            def enc_blocks(v, out):
                if v:
                    _write_long(out, len(v))
                    if is_map:
                        for k, x in v.items():
                            key(k, out)
                            item(x, out)
                    else:
                        for x in v:
                            item(x, out)
                _write_long(out, 0)
            return enc_blocks
        if t == "record":
            rid = id(schema)
            if rid in named:
                return lambda v, out: named[rid](v, out)
            named[rid] = None
            fields = [(f["name"], "default" in f, f.get("default"),
                       self._compile(f["type"], named)) for f in schema["fields"]]

            def enc_record(v, out):
                for name, has_default, default, fn in fields:
                    if name in v:
                        fv = v[name]
                    elif has_default:
                        fv = default
                    else:
                        raise SchemaError(f"missing field {name!r} with no default")
                    fn(fv, out)
            named[rid] = enc_record
            return enc_record

        def unknown(v, out):
            raise SchemaError(f"unknown type {t!r}")
        return unknown


def _union_match(schema: Schema, v: Any) -> bool:
    t = schema if isinstance(schema, str) else (
        schema[0] if isinstance(schema, list) else schema["type"]
    )
    if t == "null":
        return v is None
    if v is None:
        return False
    if t == "boolean":
        return isinstance(v, bool)
    if t in ("int", "long"):
        return isinstance(v, int) and not isinstance(v, bool)
    if t in ("float", "double"):
        return isinstance(v, float) or (
            isinstance(v, int) and not isinstance(v, bool)
        )
    if t in ("bytes", "fixed"):
        return isinstance(v, (bytes, bytearray))
    if t in ("string", "enum"):
        return isinstance(v, str)
    if t == "array":
        return isinstance(v, (list, tuple))
    if t in ("map", "record"):
        return isinstance(v, dict)
    return True


# ---------------------------------------------------------------------------
# schema-driven decode


class Decoder:
    """Schema-driven decoder. The schema is compiled once into nested
    closures, one per schema node (named types resolved, record fields and
    union branches bound), so decoding a record makes no schema lookups."""

    def __init__(self, schema: Union[str, Schema]):
        self.schema = parse_schema(schema)
        self.names: dict = {}
        _collect_names(self.schema, self.names)
        self._decode = self._compile(self.schema, {})

    def decode(self, data: Union[bytes, memoryview], pos: int = 0) -> tuple[Any, int]:
        return self._decode(memoryview(data), pos)

    def _compile(self, schema: Schema, named: dict):
        """``fn(buf, pos) -> (value, pos)`` for ``schema``. ``named`` maps a
        record's id to its decoder (None while its fields compile, so a
        recursive reference defers to it)."""
        schema = _resolve(schema, self.names)
        if isinstance(schema, list):  # union
            branches = [self._compile(s, named) for s in schema]

            def dec_union(buf, pos):
                i, pos = _read_long(buf, pos)
                return branches[i](buf, pos)
            return dec_union
        t = schema if isinstance(schema, str) else schema["type"]
        if t == "null":
            return lambda buf, pos: (None, pos)
        if t == "boolean":
            return lambda buf, pos: (buf[pos] != 0, pos + 1)
        if t in ("int", "long"):
            return _read_long
        if t in ("float", "double"):
            unpack, width = ((_FLOAT.unpack_from, 4) if t == "float"
                             else (_DOUBLE.unpack_from, 8))
            return lambda buf, pos: (unpack(buf, pos)[0], pos + width)
        if t in ("bytes", "string"):
            as_str = t == "string"

            def dec_bytes(buf, pos):
                n, pos = _read_long(buf, pos)
                raw = buf[pos : pos + n]
                return (str(raw, "utf-8") if as_str else bytes(raw)), pos + n
            return dec_bytes
        if t == "fixed":
            size = schema["size"]
            return lambda buf, pos: (bytes(buf[pos : pos + size]), pos + size)
        if t == "enum":
            symbols = schema["symbols"]

            def dec_enum(buf, pos):
                i, pos = _read_long(buf, pos)
                return symbols[i], pos
            return dec_enum
        if t in ("array", "map"):
            is_map = t == "map"
            item = self._compile(schema["values" if is_map else "items"], named)
            key = self._compile("string", named)

            def dec_blocks(buf, pos):
                out = {} if is_map else []
                while True:
                    count, pos = _read_long(buf, pos)
                    if count == 0:
                        return out, pos
                    if count < 0:  # block with byte size
                        _, pos = _read_long(buf, pos)
                        count = -count
                    for _ in range(count):
                        if is_map:
                            k, pos = key(buf, pos)
                            out[k], pos = item(buf, pos)
                        else:
                            v, pos = item(buf, pos)
                            out.append(v)
            return dec_blocks
        if t == "record":
            rid = id(schema)
            if rid in named:
                return lambda buf, pos: named[rid](buf, pos)
            named[rid] = None
            fields = [(f["name"], self._compile(f["type"], named))
                      for f in schema["fields"]]

            def dec_record(buf, pos):
                rec = {}
                for name, fn in fields:
                    rec[name], pos = fn(buf, pos)
                return rec, pos
            named[rid] = dec_record
            return dec_record

        def unknown(buf, pos):
            raise SchemaError(f"unknown type {t!r}")
        return unknown


# ---------------------------------------------------------------------------
# object container files


class ContainerWriter:
    """Incremental Avro object-container writer: header on open, records
    appended across calls in sync-marked blocks — the streaming form of
    :func:`write_container` (chunked scoring writes scores as they are
    computed instead of materializing every record first)."""

    def __init__(
        self,
        path: str,
        schema: Union[str, Schema],
        codec: str = "null",
        block_records: int = 4096,
        sync: Optional[bytes] = None,
    ):
        if codec not in ("null", "deflate"):
            raise SchemaError(f"unsupported codec {codec!r}")
        self.schema = parse_schema(schema)
        self._enc = Encoder(self.schema)
        self._sync = sync or os.urandom(SYNC_SIZE)
        self._codec = codec
        self._block_records = block_records
        self._block = io.BytesIO()
        self._count = 0
        self.n_written = 0
        self._path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        meta = {
            "avro.schema": json.dumps(self.schema).encode(),
            "avro.codec": codec.encode(),
        }
        menc = Encoder({"type": "map", "values": "bytes"})
        self._f.write(menc.encode(meta))
        self._f.write(self._sync)

    def _flush_block(self) -> None:
        if self._count == 0:
            return
        payload = self._block.getvalue()
        if self._codec == "deflate":
            payload = zlib.compress(payload)[2:-4]  # raw deflate, no hdr/cksum
        hdr = io.BytesIO()
        _write_long(hdr, self._count)
        _write_long(hdr, len(payload))
        self._f.write(hdr.getvalue())
        self._f.write(payload)
        self._f.write(self._sync)
        self._block.seek(0)
        self._block.truncate()
        self._count = 0

    def write(self, rec: Any) -> None:
        # Roll back on mid-record encode failure (e.g. a union mismatch in a
        # later field): partial bytes would otherwise poison the block and
        # corrupt every subsequent record when flushed.
        start = self._block.tell()
        try:
            self._enc.encode(rec, out=self._block)
        except Exception:
            self._block.seek(start)
            self._block.truncate()
            raise
        self._count += 1
        self.n_written += 1
        if self._count >= self._block_records:
            self._flush_block()

    def write_encoded(self, raw: bytes) -> None:
        """Append one record already encoded under this writer's schema."""
        self._block.write(raw)
        self._count += 1
        self.n_written += 1
        if self._count >= self._block_records:
            self._flush_block()

    def write_many(self, records: Iterable[Any]) -> int:
        for rec in records:
            self.write(rec)
        return self.n_written

    def close(self) -> None:
        if self._f is not None:
            self._flush_block()
            self._f.close()
            self._f = None

    def abort(self) -> None:
        """Close WITHOUT flushing the buffered block and rename the output to
        ``<path>.partial``.

        Avro containers have no end marker, so a flushed-then-abandoned file
        is indistinguishable from complete output; an aborted chunked run
        must not leave a well-formed partial file under the final name.
        """
        if self._f is not None:
            self._f.close()
            self._f = None
            try:
                os.replace(self._path, self._path + ".partial")
            except OSError:
                pass  # unlinked/moved underneath us; nothing to mark

    def __enter__(self) -> "ContainerWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        else:
            self.close()


def write_container(
    path: str,
    schema: Union[str, Schema],
    records: Iterable[Any],
    codec: str = "null",
    block_records: int = 4096,
    sync: Optional[bytes] = None,
) -> int:
    """Write an Avro object container file; returns the record count."""
    with ContainerWriter(path, schema, codec, block_records, sync) as w:
        return w.write_many(records)


def _stream_varint(f, first: bytes) -> int:
    # varint (non-zigzag framing handled by _read_long) from the raw
    # stream; EOF mid-varint means a truncated container, not a spin.
    buf = bytearray(first)
    while buf[-1] & 0x80:
        b = f.read(1)
        if not b:
            raise SchemaError("truncated avro container (EOF mid-varint)")
        buf += b
    v, _ = _read_long(memoryview(bytes(buf)), 0)
    return v


def read_blocks(path: str) -> tuple[Schema, Iterator[tuple[int, bytes]]]:
    """Read an Avro object container file → (writer schema, iterator of
    ``(record count, payload)`` blocks, decompressed and sync-checked).

    The header is parsed eagerly under its own file handle (schema-only
    callers leak nothing); the returned iterator opens the file again when
    first advanced.
    """
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise SchemaError(f"{path}: not an Avro object container file")
        # Decode the metadata map incrementally from the head of the file.
        head = f.read(1 << 16)
        mdec = Decoder({"type": "map", "values": "bytes"})
        while True:
            try:
                meta, pos = mdec.decode(head)
                break
            except IndexError:  # metadata longer than the head buffer
                more = f.read(1 << 16)
                if not more:
                    raise SchemaError(f"{path}: truncated container header") from None
                head += more
        if "avro.schema" not in meta:
            raise SchemaError(f"{path}: container header missing avro.schema")
        schema = json.loads(meta["avro.schema"])
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise SchemaError(f"unsupported codec {codec!r}")
        f.seek(4 + pos)
        sync = f.read(SYNC_SIZE)
        data_start = 4 + pos + SYNC_SIZE

    def blocks() -> Iterator[tuple[int, bytes]]:
        with open(path, "rb") as f:
            f.seek(data_start)
            while True:
                hdr = f.read(1)
                if not hdr:
                    return
                count = _stream_varint(f, hdr)
                hdr = f.read(1)
                if not hdr:
                    raise SchemaError(
                        "truncated avro container (EOF before block size)"
                    )
                size = _stream_varint(f, hdr)
                payload = f.read(size)
                if len(payload) < size:
                    raise SchemaError(
                        f"{path}: truncated avro container (block payload "
                        f"{len(payload)} < {size} bytes)"
                    )
                if codec == "deflate":
                    payload = zlib.decompress(payload, wbits=-15)
                if f.read(SYNC_SIZE) != sync:
                    raise SchemaError(f"{path}: sync marker mismatch (corrupt block)")
                yield count, payload

    return schema, blocks()


def read_container(path: str) -> tuple[Schema, Iterator[Any]]:
    """Read an Avro object container file → (writer schema, record iterator);
    the header and blocks as ``read_blocks`` reads them."""
    schema, blocks = read_blocks(path)
    dec = Decoder(schema)

    def records() -> Iterator[Any]:
        for count, payload in blocks:
            mv = memoryview(payload)
            pos = 0
            for _ in range(count):
                rec, pos = dec.decode(mv, pos)
                yield rec

    return schema, records()


def read_records(path: str) -> list[Any]:
    """Convenience: fully materialize a container file's records."""
    _, it = read_container(path)
    return list(it)
