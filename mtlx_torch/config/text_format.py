"""Protobuf text format without protobuf: the reader of pipeline files and
label maps.

Three parts:
  * a minimal wire-format decoder (varints, fixed 32/64-bit values and
    length-delimited fields), which reads the serialized
    FileDescriptorProtos of `protos/descriptors.py` into a schema and
    parses `tf.train.Example` records (`data/example_decoder.py`), with
    the encoder that writes them;
  * the schema: each message's fields (name, number, label, type, type
    name, proto2 default, oneof) and each enum's values;
  * a text-format parser that builds `Message` objects, and a printer
    that writes one back out.

A `Message` answers what the port asks of a config: attribute access
with proto2 defaults, repeated fields as lists, `HasField`,
`WhichOneof`, and enums as ints. Float fields hold float32 values, as
protobuf's do. Parsing follows protobuf's `text_format.Parse`: an
unknown field, a bad enum value, a duplicate singular field or a second
member of a oneof raises `ParseError` naming the line.
"""

from __future__ import annotations

import functools
import math
import re
import struct
from typing import Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------- wire format

WIRE_VARINT, WIRE_FIXED64, WIRE_BYTES, WIRE_FIXED32 = 0, 1, 2, 5


def read_varint(buf, pos: int) -> Tuple[int, int]:
    """(value, next position) of the varint at `pos`."""
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes")


def iter_fields(buf) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a serialized
    message: an int for varint and fixed fields, a memoryview slice for
    length-delimited ones."""
    view = memoryview(buf)
    pos, end = 0, len(view)
    while pos < end:
        key, pos = read_varint(view, pos)
        number, wire = key >> 3, key & 7
        if wire == WIRE_VARINT:
            value, pos = read_varint(view, pos)
        elif wire == WIRE_BYTES:
            n, pos = read_varint(view, pos)
            if pos + n > end:
                raise ValueError("truncated length-delimited field")
            value = view[pos:pos + n]
            pos += n
        elif wire == WIRE_FIXED32:
            value = int.from_bytes(view[pos:pos + 4], "little")
            pos += 4
        elif wire == WIRE_FIXED64:
            value = int.from_bytes(view[pos:pos + 8], "little")
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire} (field {number})")
        yield number, wire, value


def signed64(value: int) -> int:
    """A varint read as int64 (two's complement)."""
    return value - (1 << 64) if value >= 1 << 63 else value


def write_varint(out: bytearray, value: int) -> None:
    value &= (1 << 64) - 1
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def write_bytes_field(out: bytearray, number: int, payload) -> None:
    write_varint(out, (number << 3) | WIRE_BYTES)
    write_varint(out, len(payload))
    out += payload


# ---------------------------------------------------------------- schema

# FieldDescriptorProto.Type
TYPE_DOUBLE, TYPE_FLOAT, TYPE_INT64, TYPE_UINT64, TYPE_INT32 = 1, 2, 3, 4, 5
TYPE_FIXED64, TYPE_FIXED32, TYPE_BOOL, TYPE_STRING, TYPE_GROUP = 6, 7, 8, 9, 10
TYPE_MESSAGE, TYPE_BYTES, TYPE_UINT32, TYPE_ENUM = 11, 12, 13, 14
TYPE_SFIXED32, TYPE_SFIXED64, TYPE_SINT32, TYPE_SINT64 = 15, 16, 17, 18
LABEL_REPEATED = 3

_INT_RANGES = {
    TYPE_INT32: (-(1 << 31), (1 << 31) - 1), TYPE_SINT32: (-(1 << 31), (1 << 31) - 1),
    TYPE_SFIXED32: (-(1 << 31), (1 << 31) - 1),
    TYPE_INT64: (-(1 << 63), (1 << 63) - 1), TYPE_SINT64: (-(1 << 63), (1 << 63) - 1),
    TYPE_SFIXED64: (-(1 << 63), (1 << 63) - 1),
    TYPE_UINT32: (0, (1 << 32) - 1), TYPE_FIXED32: (0, (1 << 32) - 1),
    TYPE_UINT64: (0, (1 << 64) - 1), TYPE_FIXED64: (0, (1 << 64) - 1),
}


def _f32(x: float) -> float:
    """x rounded to float32, as protobuf stores a float field."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


class FieldType:
    __slots__ = ("name", "number", "repeated", "type", "type_name", "default_text", "oneof")

    def __init__(self, name, number, repeated, type_, type_name, default_text, oneof):
        self.name = name
        self.number = number
        self.repeated = repeated
        self.type = type_
        self.type_name = type_name
        self.default_text = default_text
        self.oneof = oneof


class EnumType:
    def __init__(self, full_name: str, values: List[Tuple[str, int]]):
        self.full_name = full_name
        self.values = values
        self.by_name = {n: v for n, v in values}
        self.by_number = {}
        for n, v in values:
            self.by_number.setdefault(v, n)


class MessageType:
    def __init__(self, full_name: str, fields: List[FieldType], oneofs: List[str]):
        self.full_name = full_name
        self.fields = fields
        self.by_name = {f.name: f for f in fields}
        self.oneofs = {name: [f.name for f in fields if f.oneof == name] for name in oneofs}


class Schema:
    """Messages and enums of a set of FileDescriptorProtos, by full name."""

    def __init__(self, files) -> None:
        self.messages: Dict[str, MessageType] = {}
        self.enums: Dict[str, EnumType] = {}
        for serialized in files:
            self._add_file(serialized)

    def _add_file(self, buf) -> None:
        package = ""
        messages, enums = [], []
        for number, _, value in iter_fields(buf):
            if number == 2:
                package = bytes(value).decode()
            elif number == 4:
                messages.append(value)
            elif number == 5:
                enums.append(value)
        for m in messages:
            self._add_message(m, package)
        for e in enums:
            self._add_enum(e, package)

    def _add_enum(self, buf, scope: str) -> None:
        name, values = "", []
        for number, _, value in iter_fields(buf):
            if number == 1:
                name = bytes(value).decode()
            elif number == 2:
                vname, vnum = "", 0
                for n2, _, v2 in iter_fields(value):
                    if n2 == 1:
                        vname = bytes(v2).decode()
                    elif n2 == 2:
                        vnum = signed64(v2)
                values.append((vname, vnum))
        full = f"{scope}.{name}" if scope else name
        self.enums[full] = EnumType(full, values)

    def _add_message(self, buf, scope: str) -> None:
        name = ""
        raw_fields, nested, nested_enums, oneofs = [], [], [], []
        for number, _, value in iter_fields(buf):
            if number == 1:
                name = bytes(value).decode()
            elif number == 2:
                raw_fields.append(value)
            elif number == 3:
                nested.append(value)
            elif number == 4:
                nested_enums.append(value)
            elif number == 8:
                oneofs.append(next((bytes(v).decode() for n, _, v in iter_fields(value)
                                    if n == 1), ""))
        full = f"{scope}.{name}" if scope else name
        fields = []
        for f in raw_fields:
            d = {"oneof_index": None, "type_name": "", "default_value": None, "label": 1}
            for n2, _, v2 in iter_fields(f):
                if n2 == 1:
                    d["name"] = bytes(v2).decode()
                elif n2 == 3:
                    d["number"] = v2
                elif n2 == 4:
                    d["label"] = v2
                elif n2 == 5:
                    d["type"] = v2
                elif n2 == 6:
                    d["type_name"] = bytes(v2).decode().lstrip(".")
                elif n2 == 7:
                    d["default_value"] = bytes(v2).decode()
                elif n2 == 9:
                    d["oneof_index"] = v2
            oneof = oneofs[d["oneof_index"]] if d["oneof_index"] is not None else None
            fields.append(FieldType(d["name"], d["number"], d["label"] == LABEL_REPEATED,
                                    d["type"], d["type_name"], d["default_value"], oneof))
        self.messages[full] = MessageType(full, fields, oneofs)
        for m in nested:
            self._add_message(m, full)
        for e in nested_enums:
            self._add_enum(e, full)

    def default(self, field: FieldType):
        """The proto2 default of a singular scalar field."""
        t, text = field.type, field.default_text
        if t == TYPE_ENUM:
            enum = self.enums[field.type_name]
            return enum.by_name[text] if text is not None else enum.values[0][1]
        if t in (TYPE_FLOAT, TYPE_DOUBLE):
            v = _parse_float(text) if text is not None else 0.0
            return _f32(v) if t == TYPE_FLOAT else v
        if t == TYPE_BOOL:
            return text == "true"
        if t == TYPE_STRING:
            return text if text is not None else ""
        if t == TYPE_BYTES:
            return _unescape(text) if text is not None else b""
        return int(text) if text is not None else 0

    def new(self, full_name: str) -> "Message":
        return Message(self, self.messages[full_name])


# ---------------------------------------------------------------- messages


class RepeatedMessages(list):
    """A repeated message field: a list with protobuf's `add()`."""

    def __init__(self, schema: Schema, full_name: str):
        super().__init__()
        self._schema = schema
        self._full_name = full_name

    def add(self) -> "Message":
        m = self._schema.new(self._full_name)
        self.append(m)
        return m


class Message:
    """A parsed message. Set fields live in `_values`; a singular message
    field read before it is set is a default child that becomes present
    (in its parent and up the chain) when one of its fields is set."""

    __slots__ = ("_schema", "_type", "_values", "_children", "_parent", "_parent_field")

    def __init__(self, schema: Schema, mtype: MessageType, parent=None, parent_field=None):
        object.__setattr__(self, "_schema", schema)
        object.__setattr__(self, "_type", mtype)
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_children", {})
        object.__setattr__(self, "_parent", parent)
        object.__setattr__(self, "_parent_field", parent_field)

    @property
    def full_name(self) -> str:
        return self._type.full_name

    def _field(self, name: str) -> FieldType:
        f = self._type.by_name.get(name)
        if f is None:
            raise AttributeError(f'message type "{self._type.full_name}" has no field "{name}"')
        return f

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        f = self._field(name)
        if name in self._values:
            return self._values[name]
        if f.repeated:
            value = (RepeatedMessages(self._schema, f.type_name)
                     if f.type in (TYPE_MESSAGE, TYPE_GROUP) else [])
            self._values[name] = value
            return value
        if f.type in (TYPE_MESSAGE, TYPE_GROUP):
            child = self._children.get(name)
            if child is None:
                child = Message(self._schema, self._schema.messages[f.type_name], self, name)
                self._children[name] = child
            return child
        return self._schema.default(f)

    def __setattr__(self, name: str, value) -> None:
        f = self._field(name)
        if f.repeated or f.type in (TYPE_MESSAGE, TYPE_GROUP):
            raise AttributeError(f"assignment to the {'repeated' if f.repeated else 'message'} "
                                 f"field {name!r} is not allowed (as in protobuf)")
        self._set(f, _coerce(self._schema, f, value))

    def _set(self, f: FieldType, value) -> None:
        if f.oneof is not None:
            for other in self._type.oneofs[f.oneof]:
                if other != f.name:
                    self._values.pop(other, None)
                    self._children.pop(other, None)
        self._values[f.name] = value
        self._mark_present()

    def _mark_present(self) -> None:
        parent = self._parent
        if parent is not None:
            parent._set(parent._field(self._parent_field), self)
            object.__setattr__(self, "_parent", None)

    def SetInParent(self) -> None:
        self._mark_present()

    def HasField(self, name: str) -> bool:
        if name in self._type.oneofs:
            return self.WhichOneof(name) is not None
        if self._field(name).repeated:
            raise ValueError(f"HasField does not apply to the repeated field {name!r}")
        return name in self._values

    def WhichOneof(self, oneof: str) -> Optional[str]:
        members = self._type.oneofs.get(oneof)
        if members is None:
            raise ValueError(f'message type "{self._type.full_name}" has no oneof "{oneof}"')
        return next((m for m in members if m in self._values), None)

    def ListFields(self) -> List[Tuple[FieldType, object]]:
        """(field, value) of every set field, in field-number order; a
        repeated field counts when it is not empty."""
        out = []
        for f in sorted(self._type.fields, key=lambda f: f.number):
            if f.name in self._values and not (f.repeated and not self._values[f.name]):
                out.append((f, self._values[f.name]))
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, Message) or other._type is not self._type:
            return NotImplemented
        return ([(f.name, v) for f, v in self.ListFields()]
                == [(f.name, v) for f, v in other.ListFields()])

    def __repr__(self) -> str:
        return f"<{self._type.full_name}\n{to_text(self)}>"


def _coerce(schema: Schema, f: FieldType, value):
    """A Python value for field f, checked as protobuf checks an
    assignment."""
    t = f.type
    if t in (TYPE_FLOAT, TYPE_DOUBLE):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"{f.name}: a number is required, got {value!r}")
        return _f32(float(value)) if t == TYPE_FLOAT else float(value)
    if t == TYPE_BOOL:
        return bool(value)
    if t == TYPE_STRING:
        if not isinstance(value, str):
            raise TypeError(f"{f.name}: a str is required, got {value!r}")
        return value
    if t == TYPE_BYTES:
        return bytes(value)
    if t == TYPE_ENUM:
        enum = schema.enums[f.type_name]
        if isinstance(value, str):
            value = enum.by_name[value]
        if int(value) not in enum.by_number:
            raise ValueError(f"{f.name}: {value} is not a value of enum {enum.full_name}")
        return int(value)
    if isinstance(value, bool) or int(value) != value:
        raise TypeError(f"{f.name}: an integer is required, got {value!r}")
    lo, hi = _INT_RANGES[t]
    if not lo <= int(value) <= hi:
        raise ValueError(f"{f.name}: {value} is out of range")
    return int(value)


# ---------------------------------------------------------------- text parser


class ParseError(ValueError):
    pass


_TOKEN = re.compile(r"""
    (?P<space>[ \t\r\f\v]+|\#[^\n]*)
  | (?P<newline>\n)
  | (?P<string>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')
  | (?P<number>-?(?:0[xX][0-9a-fA-F]+|(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?[fF]?))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>[{}<>\[\]:,;.\-/])
""", re.VERBOSE)


def _tokenize(text: str) -> List[Tuple[str, str, int]]:
    tokens, line, pos = [], 1, 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ParseError(f"line {line}: unexpected character {text[pos]!r}")
        kind = m.lastgroup
        if kind == "newline":
            line += 1
        elif kind != "space":
            tokens.append((kind, m.group(), line))
        pos = m.end()
    return tokens


_ESCAPES = {"n": 10, "t": 9, "r": 13, "a": 7, "b": 8, "f": 12, "v": 11,
            "\\": 92, "'": 39, '"': 34, "?": 63}


def _unescape(body: str) -> bytes:
    """C-style escapes of a text-format string literal -> bytes."""
    raw = body.encode("utf-8")
    out, i = bytearray(), 0
    while i < len(raw):
        c = raw[i]
        if c != 92:
            out.append(c)
            i += 1
            continue
        i += 1
        e = chr(raw[i])
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 1
        elif e in "xX":
            j = i + 1
            while j < len(raw) and j < i + 3 and chr(raw[j]) in "0123456789abcdefABCDEF":
                j += 1
            out.append(int(raw[i + 1:j], 16))
            i = j
        elif e in "01234567":
            j = i
            while j < len(raw) and j < i + 3 and chr(raw[j]) in "01234567":
                j += 1
            out.append(int(raw[i:j], 8) & 0xFF)
            i = j
        else:
            raise ValueError(f"invalid escape \\{e}")
    return bytes(out)


def _parse_float(text: str) -> float:
    t = text.lower()
    if t.endswith("f") and not t.endswith(("inf", "-inf")):
        t = t[:-1]
    if t in ("inf", "infinity"):
        return math.inf
    if t in ("-inf", "-infinity"):
        return -math.inf
    if t in ("nan", "-nan"):
        return math.nan
    return float(t)


class _Parser:
    def __init__(self, schema: Schema, text: str):
        self.schema = schema
        self.tokens = _tokenize(text)
        self.i = 0

    # -- token access
    def peek(self) -> Optional[Tuple[str, str, int]]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def line(self) -> int:
        tok = self.peek() or (self.tokens[-1] if self.tokens else None)
        return tok[2] if tok else 1

    def error(self, msg: str, line: Optional[int] = None) -> ParseError:
        return ParseError(f"line {line if line is not None else self.line()}: {msg}")

    def try_consume(self, text: str) -> bool:
        tok = self.peek()
        if tok is not None and tok[0] in ("punct", "ident") and tok[1] == text:
            self.i += 1
            return True
        return False

    def consume(self, text: str) -> None:
        if not self.try_consume(text):
            tok = self.peek()
            raise self.error(f'expected "{text}", found {tok[1]!r}' if tok
                             else f'expected "{text}", found the end of the text')

    def next(self, what: str) -> Tuple[str, str, int]:
        tok = self.peek()
        if tok is None:
            raise self.error(f"expected {what}, found the end of the text")
        self.i += 1
        return tok

    # -- grammar
    def parse_message(self, msg: Message, end: Optional[str]) -> None:
        while True:
            if end is None and self.peek() is None:
                return
            if end is not None and self.try_consume(end):
                return
            if self.peek() is None:
                raise self.error(f'expected "{end}", found the end of the text')
            self.parse_field(msg)

    def parse_field(self, msg: Message) -> None:
        kind, name, line = self.next("a field name")
        if kind != "ident":
            raise self.error(f"expected a field name, found {name!r}", line)
        f = msg._type.by_name.get(name)
        if f is None:
            raise self.error(f'message type "{msg.full_name}" has no field named "{name}"', line)
        if f.oneof is not None:
            which = msg.WhichOneof(f.oneof)
            if which is not None and which != name:
                raise self.error(
                    f'field "{name}" is specified along with field "{which}", another member '
                    f'of oneof "{f.oneof}" for message type "{msg.full_name}"', line)
        is_message = f.type in (TYPE_MESSAGE, TYPE_GROUP)
        if is_message:
            self.try_consume(":")
        else:
            self.consume(":")
        if f.repeated and self.try_consume("["):
            if not self.try_consume("]"):
                while True:
                    self.parse_value(msg, f, line)
                    if self.try_consume("]"):
                        break
                    self.consume(",")
        else:
            self.parse_value(msg, f, line)
        if not self.try_consume(","):
            self.try_consume(";")

    def parse_value(self, msg: Message, f: FieldType, line: int) -> None:
        if f.type in (TYPE_MESSAGE, TYPE_GROUP):
            end = ">" if self.try_consume("<") else None
            if end is None:
                self.consume("{")
                end = "}"
            if f.repeated:
                child = getattr(msg, f.name).add()
            else:
                if f.name in msg._values:
                    raise self.error(f'message type "{msg.full_name}" should not have '
                                     f'multiple "{f.name}" fields', line)
                child = getattr(msg, f.name)
                child.SetInParent()
            self.parse_message(child, end)
            return
        value = self.parse_scalar(f)
        if f.repeated:
            getattr(msg, f.name).append(value)
        else:
            if f.name in msg._values:
                raise self.error(f'message type "{msg.full_name}" should not have '
                                 f'multiple "{f.name}" fields', line)
            msg._set(f, value)

    def parse_scalar(self, f: FieldType):
        t = f.type
        if t in (TYPE_STRING, TYPE_BYTES):
            kind, text, line = self.next("a string")
            if kind != "string":
                raise self.error(f"expected a string for {f.name}, found {text!r}", line)
            parts = [text]
            while self.peek() is not None and self.peek()[0] == "string":
                parts.append(self.next("a string")[1])
            try:
                raw = b"".join(_unescape(p[1:-1]) for p in parts)
            except ValueError as e:
                raise self.error(str(e), line) from None
            return raw if t == TYPE_BYTES else raw.decode("utf-8")
        negative = self.try_consume("-")
        kind, text, line = self.next("a value")
        if negative:
            text = "-" + text
        if t == TYPE_ENUM:
            enum = self.schema.enums[f.type_name]
            if kind == "ident" and not negative:
                if text not in enum.by_name:
                    raise self.error(f'enum type "{enum.full_name}" has no value named "{text}"',
                                     line)
                return enum.by_name[text]
            try:
                number = int(text, 0)
            except ValueError:
                raise self.error(f'invalid value {text!r} for enum "{enum.full_name}"', line) \
                    from None
            if number not in enum.by_number:
                raise self.error(f'enum type "{enum.full_name}" has no value with number '
                                 f"{number}", line)
            return number
        if t == TYPE_BOOL:
            if text in ("true", "True", "t", "1"):
                return True
            if text in ("false", "False", "f", "0"):
                return False
            raise self.error(f"expected a bool for {f.name}, found {text!r}", line)
        if t in (TYPE_FLOAT, TYPE_DOUBLE):
            try:
                v = _parse_float(text)
            except ValueError:
                raise self.error(f"expected a number for {f.name}, found {text!r}", line) \
                    from None
            return _f32(v) if t == TYPE_FLOAT else v
        if kind != "number" or re.fullmatch(r"-?(0[xX][0-9a-fA-F]+|[0-9]+)", text) is None:
            raise self.error(f"expected an integer for {f.name}, found {text!r}", line)
        if re.fullmatch(r"-?0[0-7]+", text):
            v = int(text.replace("0", "0o", 1), 0)  # protobuf reads a leading 0 as octal
        else:
            v = int(text, 0)
        lo, hi = _INT_RANGES[t]
        if not lo <= v <= hi:
            raise self.error(f"integer {text} is out of range for {f.name}", line)
        return v


def parse(schema: Schema, text: str, full_name: str) -> Message:
    """The message `full_name` parsed from its text format."""
    msg = schema.new(full_name)
    _Parser(schema, text).parse_message(msg, None)
    return msg


# ---------------------------------------------------------------- printer


def _format_float(v: float, single: bool) -> str:
    if math.isnan(v):
        return "nan"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    if single:  # the shortest text that reads back to the same float32
        for digits in range(1, 10):
            s = f"{v:.{digits}g}"
            if _f32(float(s)) == v:
                return s
    return repr(v)


def _escape(raw: bytes) -> str:
    out = []
    for c in raw:
        ch = chr(c)
        if ch == "\\":
            out.append("\\\\")
        elif ch == '"':
            out.append('\\"')
        elif ch == "\n":
            out.append("\\n")
        elif 32 <= c < 127:
            out.append(ch)
        else:
            out.append(f"\\{c:03o}")
    return "".join(out)


def _format_scalar(schema: Schema, f: FieldType, v) -> str:
    t = f.type
    if t == TYPE_ENUM:
        return schema.enums[f.type_name].by_number.get(v, str(v))
    if t == TYPE_BOOL:
        return "true" if v else "false"
    if t in (TYPE_FLOAT, TYPE_DOUBLE):
        return _format_float(v, t == TYPE_FLOAT)
    if t == TYPE_STRING:
        return '"' + _escape(v.encode("utf-8")) + '"'
    if t == TYPE_BYTES:
        return '"' + _escape(v) + '"'
    return str(v)


def to_text(msg: Message, indent: int = 0) -> str:
    """The text format of `msg`: set fields in field-number order, one a
    line, nested messages indented by two spaces."""
    lines = []
    pad = " " * indent
    for f, value in msg.ListFields():
        for v in (value if f.repeated else [value]):
            if f.type in (TYPE_MESSAGE, TYPE_GROUP):
                lines.append(f"{pad}{f.name} {{\n{to_text(v, indent + 2)}{pad}}}\n")
            else:
                lines.append(f"{pad}{f.name}: {_format_scalar(msg._schema, f, v)}\n")
    return "".join(lines)


@functools.lru_cache(maxsize=None)
def pipeline_schema() -> Schema:
    """The schema of the pipeline config and the label map."""
    from mtlx_torch.config.protos import descriptors

    return Schema(descriptors.FILES)
