"""The V1.GetRateLimits wire format (proto3) as the benchmark writes and
reads it, independent of the program under test.

`encode_list` / `decode_list` are a plain codec (varint and
length-delimited fields only, zero fields omitted, field numbers from the
gubernator proto).  `request_items` builds many serialized requests at
once with numpy, and `decode_responses` reads many GetRateLimitsResp
bodies at once; both fall back to nothing of the program.
"""

from __future__ import annotations

import numpy as np

REQ_FIELDS = (("name", 1, "s"), ("unique_key", 2, "s"), ("hits", 3, "i"),
              ("limit", 4, "i"), ("duration", 5, "i"),
              ("algorithm", 6, "i"), ("behavior", 7, "i"))
RESP_FIELDS = (("status", 1, "i"), ("limit", 2, "i"), ("remaining", 3, "i"),
               ("reset_time", 4, "i"), ("error", 5, "s"),
               ("metadata", 6, "m"))
U64 = (1 << 64) - 1
# the fields a decoded response column holds, in RESP_FIELDS order
RESP_COLUMNS = ("status", "limit", "remaining", "reset_time")


def _varint(v):
    v &= U64  # negatives as 64-bit two's complement (ten bytes)
    out = bytearray()
    while v > 0x7F:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _delimited(num, b):
    return _varint(num << 3 | 2) + _varint(len(b)) + b


def encode_msg(values, fields):
    """One message from a dict of field values (proto3: zero values and
    empty strings omitted; a map's entries in key order)."""
    out = bytearray()
    for name, num, kind in fields:
        v = values.get(name)
        if not v:
            continue
        if kind == "i":
            out += _varint(num << 3) + _varint(int(v))
        elif kind == "s":
            out += _delimited(num, v.encode("utf-8"))
        else:
            for k in sorted(v):
                entry = (_delimited(1, k.encode("utf-8"))
                         + _delimited(2, v[k].encode("utf-8")))
                out += _delimited(num, entry)
    return bytes(out)


def encode_list(items, fields):
    """A GetRateLimitsReq / GetRateLimitsResp: repeated field 1."""
    return b"".join(_delimited(1, encode_msg(v, fields)) for v in items)


def _read_varint(buf, i):
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, i
        shift += 7


def _wire_fields(buf):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        if key & 7 == 0:
            v, i = _read_varint(buf, i)
        elif key & 7 == 2:
            n, i = _read_varint(buf, i)
            if i + n > len(buf):
                raise ValueError("truncated field")
            v, i = bytes(buf[i:i + n]), i + n
        else:
            raise ValueError(f"wire type {key & 7}")
        yield key >> 3, v


def decode_msg(buf, fields):
    """One message's fields as a dict, every field present (proto3
    defaults); unknown fields skipped."""
    by_num = {num: (name, kind) for name, num, kind in fields}
    out = {name: ({} if kind == "m" else "" if kind == "s" else 0)
           for name, _, kind in fields}
    for num, v in _wire_fields(buf):
        if num not in by_num:
            continue
        name, kind = by_num[num]
        if kind == "i":
            out[name] = v - (1 << 64) if v >> 63 else v
        elif kind == "s":
            out[name] = v.decode("utf-8")
        else:
            e = decode_msg(v, (("key", 1, "s"), ("value", 2, "s")))
            out[name][e["key"]] = e["value"]
    return out


def decode_list(buf, fields):
    return [decode_msg(v, fields) for num, v in _wire_fields(buf)
            if num == 1]


# ------------------------------------------------------------- vectorized

def varints(values):
    """Each of `values` (non-negative int64 [n]) as varint bytes: (uint8
    [n, L], lengths [n]), L the longest length."""
    v = np.asarray(values, np.int64)
    if (v < 0).any():
        raise ValueError("varints: negative value")
    lens = np.ones(len(v), np.int64)
    for k in range(1, 10):
        over = v >= (1 << (7 * k)) if k < 9 else np.zeros(len(v), bool)
        if not over.any():
            break
        lens += over
    out = np.empty((len(v), int(lens.max(initial=1))), np.uint8)
    for k in range(out.shape[1]):
        byte = ((v >> (7 * k)) & 0x7F).astype(np.uint8)
        out[:, k] = byte | ((k < lens - 1) * 0x80).astype(np.uint8)
    return out, lens


def digits(values, width):
    """Each of `values` as `width` ASCII decimal digits: uint8 [n, width]."""
    v = np.asarray(values, np.int64)
    out = np.empty((len(v), width), np.uint8)
    for k in range(width):
        out[:, width - 1 - k] = 48 + (v // 10 ** k) % 10
    return out


def request_items(names, keys, hits, limits, durations, algorithms,
                  behaviors):
    """Serialized GetRateLimitsReq items, each framed as a repeated field 1
    entry: (flat uint8 buffer, per-item byte offsets [n + 1]).  `names`
    and `keys` are fixed-width uint8 [n, w] strings; a zero field (such as
    behavior 0, BATCHING) is omitted, as proto3 omits it.  Concatenating
    items a..b gives a request.

    Every item is laid out in the same columns, a zero field's and a short
    varint's unused columns masked out; the masked matrix read row by row
    is the concatenation."""
    n = len(hits)
    ones = np.ones(n, bool)
    vals, keep = [], []

    def byte(b, k=ones):
        vals.append(np.full(n, b, np.uint8))
        keep.append(k)

    def string(num, chars):
        byte(num << 3 | 2)
        byte(chars.shape[1])
        for j in range(chars.shape[1]):
            vals.append(chars[:, j])
            keep.append(ones)

    def integer(num, v):
        v = np.asarray(v, np.int64)
        vb, lens = varints(v)
        present = v != 0
        byte(num << 3, present)
        for j in range(int(lens.max(initial=1))):
            vals.append(vb[:, j])
            keep.append(present & (j < lens))

    byte(0x0A)
    byte(0)
    string(1, names)
    string(2, keys)
    integer(3, hits)
    integer(4, limits)
    integer(5, durations)
    integer(6, algorithms)
    integer(7, behaviors)
    mat, mask = np.stack(vals, 1), np.stack(keep, 1)
    mlen = mask[:, 2:].sum(axis=1)
    if mlen.max(initial=0) >= 128:
        raise ValueError("request item of 128 bytes or more")
    mat[:, 1] = mlen
    return mat[mask], np.concatenate([[0], np.cumsum(mlen + 2)])


def decode_responses(bodies):
    """Decode GetRateLimitsResp bodies at once.  Returns (columns, counts):
    int64 arrays of RESP_COLUMNS over every item of every body in order,
    and each body's item count.  Raises ValueError on anything but
    well-formed items of those four varint fields (an error string or
    metadata included): the caller decodes such a body with
    decode_list to report it."""
    sizes = np.array([len(b) for b in bodies], np.int64)
    b = np.frombuffer(b"".join(bodies), np.uint8)
    empty = {c: np.zeros(0, np.int64) for c in RESP_COLUMNS}
    if len(b) == 0:
        return empty, np.zeros(len(bodies), np.int64)
    if b[-1] & 0x80:
        raise ValueError("truncated varint")
    ends = np.flatnonzero((b & 0x80) == 0)
    starts = np.concatenate([[0], ends[:-1] + 1])
    tok_len = ends - starts + 1
    if tok_len.max() > 10:
        raise ValueError("varint longer than ten bytes")
    pos = np.arange(len(b)) - np.repeat(starts, tok_len)
    contrib = ((b & 0x7F).astype(np.uint64)
               << (7 * pos).astype(np.uint64))
    vals = np.add.reduceat(contrib, starts)
    if len(vals) % 2:
        raise ValueError("odd token count")
    keys, values = vals[0::2], vals[1::2].view(np.int64)
    klen, vlen = tok_len[0::2], tok_len[1::2]
    head = keys == 0x0A
    if not head[0]:
        raise ValueError("body does not start with an item")
    if not np.isin(keys[~head], (0x08, 0x10, 0x18, 0x20)).all():
        raise ValueError("a field other than status, limit, remaining, "
                         "reset_time")
    item = np.cumsum(head) - 1
    n_items = int(head.sum())
    # each item's declared length against its fields' bytes
    field_bytes = np.bincount(item[~head], weights=(klen + vlen)[~head],
                              minlength=n_items)
    if not np.array_equal(field_bytes.astype(np.int64), values[head]):
        raise ValueError("an item's length disagrees with its fields")
    cols = {}
    for c, k in zip(RESP_COLUMNS, (0x08, 0x10, 0x18, 0x20)):
        col = np.zeros(n_items, np.int64)
        m = keys == k
        if np.bincount(item[m], minlength=n_items).max(initial=0) > 1:
            raise ValueError(f"{c} repeated in an item")
        col[item[m]] = values[m]
        cols[c] = col
    # each body's items: the item heads' byte positions against the bodies'
    head_at = starts[0::2][head]
    body_of = np.searchsorted(np.cumsum(sizes), head_at, side="right")
    counts = np.bincount(body_of, minlength=len(bodies))
    return cols, counts
