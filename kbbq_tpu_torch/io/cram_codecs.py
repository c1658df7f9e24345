"""CRAM 3.0 primitive codecs: ITF-8 / LTF-8 varints and the rANS 4x8
entropy coder (orders 0 and 1).

Counterpart of ``kbbq_tpu/io/cram_codecs.py``.  ``rans_uncompress``,
``rans_compress_o0`` and ``rans_compress_o1`` run the native codec
(``csrc/kbbq_io.cc``; a failed build or a malformed blob raises, there is no
fallback).  The NumPy coder beside them (``rans_uncompress_plain``,
``rans_compress_o0_plain``, ``rans_compress_o1_plain``) is the plain version
the tests hold the codec to: the same bytes both ways, the normalisation's
tie order included.
"""

from __future__ import annotations

import numpy as np

# ----------------------------------------------------------- varints


def read_itf8(buf, pos: int):
    """CRAM ITF-8: 8-37 bit signed int, prefix-coded byte count.
    Returns (value, new_pos)."""
    b0 = int(buf[pos])
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | int(buf[pos + 1]), pos + 2
    if b0 < 0xE0:
        return (((b0 & 0x3F) << 16) | (int(buf[pos + 1]) << 8)
                | int(buf[pos + 2])), pos + 3
    if b0 < 0xF0:
        return (((b0 & 0x1F) << 24) | (int(buf[pos + 1]) << 16)
                | (int(buf[pos + 2]) << 8) | int(buf[pos + 3])), pos + 4
    v = (((b0 & 0x0F) << 28) | (int(buf[pos + 1]) << 20)
         | (int(buf[pos + 2]) << 12) | (int(buf[pos + 3]) << 4)
         | (int(buf[pos + 4]) & 0x0F))
    # 32-bit signed wrap
    if v & 0x80000000:
        v -= 1 << 32
    return v, pos + 5


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def write_itf8_array(values) -> bytes:
    """The ITF-8 encodings of every value of an integer array, back to back:
    ``b"".join(write_itf8(v) for v in values)`` without a loop per value."""
    v = np.asarray(values, np.int64).reshape(-1) & 0xFFFFFFFF
    ln = (1 + (v >= 0x80) + (v >= 0x4000) + (v >= 0x200000)
          + (v >= 0x10000000)).astype(np.int64)
    j = np.arange(5, dtype=np.int64)
    # lengths 1-4: big-endian bytes of v under a prefix of ln - 1 one-bits
    shift = np.maximum(8 * (ln[:, None] - 1 - j), 0)
    out = (v[:, None] >> shift) & 0xFF
    out[:, 0] |= np.array([0, 0, 0x80, 0xC0, 0xE0, 0], np.int64)[ln]
    # length 5: a 4-bit prefix payload, three bytes, then the low nibble
    five = ln == 5
    if five.any():
        w = v[five]
        out[five] = np.stack([0xF0 | ((w >> 28) & 0x0F), (w >> 20) & 0xFF,
                              (w >> 12) & 0xFF, (w >> 4) & 0xFF, w & 0x0F],
                             axis=1)
    return out.astype(np.uint8)[j < ln[:, None]].tobytes()


def read_ltf8(buf, pos: int):
    """CRAM LTF-8: 8-64 bit signed int. Returns (value, new_pos)."""
    b0 = int(buf[pos])
    if b0 < 0x80:
        return b0, pos + 1
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    # n extra bytes beyond the first's payload... per spec: count of
    # leading 1s in b0 = number of following bytes
    nbytes = 0
    t = b0
    while t & 0x80:
        nbytes += 1
        t = (t << 1) & 0xFF
    v = b0 & (0xFF >> nbytes) if nbytes < 8 else 0
    for i in range(nbytes):
        v = (v << 8) | int(buf[pos + 1 + i])
    if v & (1 << 63):
        v -= 1 << 64
    return v, pos + 1 + nbytes


def write_ltf8(v: int) -> bytes:
    v &= (1 << 64) - 1
    if v < 0x80:
        return bytes([v])
    for nbytes in range(1, 9):
        payload_bits = (7 - nbytes) + 8 * nbytes if nbytes < 8 else 64
        if v < (1 << payload_bits):
            prefix = (0xFF << (8 - nbytes)) & 0xFF
            if nbytes < 8:
                first = prefix | (v >> (8 * nbytes))
            else:
                first = 0xFF
            out = [first]
            for i in range(nbytes - 1, -1, -1):
                out.append((v >> (8 * i)) & 0xFF)
            return bytes(out)
    raise ValueError("ltf8 overflow")


# ----------------------------------------------------------- rANS 4x8

_RANS_L = 1 << 23       # lower renormalization bound
_TF_SHIFT = 12          # frequencies normalize to 4096
_TOTFREQ = 1 << _TF_SHIFT


def _normalize_freqs(counts: np.ndarray) -> np.ndarray:
    """Scale a 256-bin histogram to sum exactly TOTFREQ, every nonzero
    bin keeping freq >= 1."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(256, np.int64)
    f = counts.astype(np.float64) * _TOTFREQ / total
    out = np.floor(f).astype(np.int64)
    out[(counts > 0) & (out == 0)] = 1
    diff = _TOTFREQ - int(out.sum())
    # distribute the remainder over the largest bins (any rule works —
    # the table is transmitted, so decode needs no agreement here — but
    # the native codec must produce the identical stream, so the tie
    # order is pinned: stable descending-count, lower symbol first)
    order = np.argsort(-counts, kind="stable")
    i = 0
    while diff != 0:
        j = order[i % 256]
        if counts[j] > 0 and (diff > 0 or out[j] > 1):
            out[j] += 1 if diff > 0 else -1
            diff += -1 if diff > 0 else 1
        i += 1
    return out


def _write_freq_table(F: np.ndarray) -> bytes:
    """htslib rans_static.c order-0 frequency-table wire format:
    ascending symbols, u7/u15 freqs, consecutive-run shorthand,
    0-symbol terminator."""
    out = bytearray()
    rle = 0
    for j in range(256):
        if not F[j]:
            continue
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j and F[j - 1]:
                r = j + 1
                while r < 256 and F[r]:
                    r += 1
                rle = r - (j + 1)
                out.append(rle)
        f = int(F[j])
        if f < 128:
            out.append(f)
        else:
            out.append(0x80 | (f >> 8))
            out.append(f & 0xFF)
    out.append(0)
    return bytes(out)


def _read_freq_table(buf, pos: int):
    F = np.zeros(256, np.int64)
    rle = 0
    j = buf[pos]
    pos += 1
    while True:
        f = buf[pos]
        pos += 1
        if f >= 128:
            f = ((f & 0x7F) << 8) | buf[pos]
            pos += 1
        F[j] = f
        if rle:
            rle -= 1
            j += 1
        else:
            nj = buf[pos]
            pos += 1
            if nj == j + 1:
                j = nj
                rle = buf[pos]
                pos += 1
            else:
                j = nj
        if j == 0 and rle == 0:
            # terminator unless 0 is genuinely next (ascending order
            # makes a real symbol 0 impossible after the first)
            break
    return F, pos


def _enc_tables(F: np.ndarray):
    C = np.concatenate([[0], np.cumsum(F)[:-1]])
    return C


def _rans_encode_stream(data: np.ndarray, F: np.ndarray, C: np.ndarray,
                        state_of: np.ndarray) -> tuple[bytes, list]:
    """Core 4-state rANS encode: data processed in reverse, byte i
    owned by state state_of[i].  Returns (byte stream, final states)."""
    x = [_RANS_L, _RANS_L, _RANS_L, _RANS_L]
    out = bytearray()
    xmax_mul = (_RANS_L >> _TF_SHIFT) << 8
    for i in range(len(data) - 1, -1, -1):
        s = int(data[i])
        j = int(state_of[i])
        f = int(F[s])
        xm = xmax_mul * f
        while x[j] >= xm:
            out.append(x[j] & 0xFF)
            x[j] >>= 8
        x[j] = ((x[j] // f) << _TF_SHIFT) + (x[j] % f) + int(C[s])
    return bytes(out), x


def rans_compress_o0(data: bytes) -> bytes:
    """rANS 4x8 order-0 (CRAM block method 4, order byte 0), by the native
    codec."""
    from . import native_lib
    return native_lib.rans_compress(data, 0)


def rans_compress_o0_plain(data: bytes) -> bytes:
    """NumPy version of ``rans_compress_o0``: the same bytes."""
    arr = np.frombuffer(data, np.uint8)
    counts = np.bincount(arr, minlength=256)
    F = _normalize_freqs(counts)
    C = _enc_tables(F)
    state_of = np.arange(arr.size) & 3
    stream, x = _rans_encode_stream(arr, F, C, state_of)
    ft = _write_freq_table(F)
    body = bytearray(ft)
    for j in range(4):
        body += int(x[j]).to_bytes(4, "little")
    body += stream[::-1]
    hdr = bytes([0]) + len(body).to_bytes(4, "little") \
        + len(data).to_bytes(4, "little")
    return hdr + bytes(body)


def _rans_decode_stream(buf, pos: int, n_out: int, F, C, state_of,
                        ctx_of=None):
    """4-state decode; F/C are [256] (o0) or [256,256] (o1, indexed by
    running context per state)."""
    x = []
    for j in range(4):
        x.append(int.from_bytes(buf[pos:pos + 4], "little"))
        pos += 4
    out = np.zeros(n_out, np.uint8)
    if F.ndim == 1:
        lut = np.zeros(_TOTFREQ, np.uint8)
        for s in range(256):
            if F[s]:
                lut[C[s]:C[s] + F[s]] = s
        Fs, Cs = F, C
    else:
        lut = np.zeros((256, _TOTFREQ), np.uint8)
        for c in range(256):
            for s in range(256):
                if F[c, s]:
                    lut[c, C[c, s]:C[c, s] + F[c, s]] = s
        ctx = [0, 0, 0, 0]
    n = len(buf)
    for i in range(n_out):
        j = int(state_of[i])
        xi = x[j]
        m = xi & (_TOTFREQ - 1)
        if F.ndim == 1:
            s = int(lut[m])
            f, c = int(Fs[s]), int(Cs[s])
        else:
            cc = ctx[j]
            s = int(lut[cc, m])
            f, c = int(F[cc, s]), int(C[cc, s])
            ctx[j] = s
        out[i] = s
        xi = f * (xi >> _TF_SHIFT) + m - c
        while xi < _RANS_L and pos < n:
            xi = (xi << 8) | buf[pos]
            pos += 1
        x[j] = xi
    return out.tobytes()


def _declared_size(blob, expected: int | None) -> int:
    if len(blob) < 9:
        raise ValueError("rANS: blob shorter than its header")
    n_out = int.from_bytes(bytes(blob[5:9]), "little")
    if expected is not None and expected != n_out:
        raise ValueError("rANS: uncompressed size mismatch")
    return n_out


def rans_uncompress(blob: bytes, expected: int | None = None) -> bytes:
    """Decode a CRAM rANS 4x8 blob (order 0 or 1) by the native codec;
    ValueError when it is malformed or `expected` is not its size."""
    from . import native_lib
    return native_lib.rans_uncompress(blob, _declared_size(blob, expected))


def rans_uncompress_plain(blob: bytes, expected: int | None = None) -> bytes:
    """NumPy version of ``rans_uncompress``: the same bytes."""
    n_out = _declared_size(blob, expected)
    order = blob[0]
    pos = 9
    if order == 0:
        F, pos = _read_freq_table(blob, pos)
        C = _enc_tables(F)
        state_of = np.arange(n_out) & 3
        return _rans_decode_stream(blob, pos, n_out, F, C, state_of)
    if order != 1:
        raise ValueError(f"rANS: unknown order {order}")
    F2, pos = _read_freq_table_o1(blob, pos)
    C2 = np.zeros_like(F2)
    for c in range(256):
        C2[c] = _enc_tables(F2[c])
    return _rans_decode_o1(blob, pos, n_out, F2, C2)


def _quarters(n: int):
    """Order-1 splits the payload into 4 quarters; the last one takes
    the remainder (htslib layout: decode round-robins the quarters'
    i-th bytes, then state 3 finishes its tail)."""
    q = n >> 2
    return [(0, q), (q, 2 * q), (2 * q, 3 * q), (3 * q, n)]


def _write_freq_table_o1(F2: np.ndarray) -> bytes:
    """Order-1 tables: for each context with any counts, the context
    byte then its order-0-format table; same run shorthand on contexts;
    0 terminator."""
    out = bytearray()
    rle = 0
    for c in range(256):
        if not F2[c].sum():
            continue
        if rle:
            rle -= 1
        else:
            out.append(c)
            if c and F2[c - 1].sum():
                r = c + 1
                while r < 256 and F2[r].sum():
                    r += 1
                rle = r - (c + 1)
                out.append(rle)
        out += _write_freq_table(F2[c])
    out.append(0)
    return bytes(out)


def _read_freq_table_o1(buf, pos: int):
    F2 = np.zeros((256, 256), np.int64)
    rle = 0
    c = buf[pos]
    pos += 1
    while True:
        F2[c], pos = _read_freq_table(buf, pos)
        if rle:
            rle -= 1
            c += 1
        else:
            nc = buf[pos]
            pos += 1
            if nc == c + 1:
                c = nc
                rle = buf[pos]
                pos += 1
            else:
                c = nc
        if c == 0 and rle == 0:
            break
    return F2, pos


def rans_compress_o1(data: bytes) -> bytes:
    """rANS 4x8 order-1: context = previous byte within each quarter
    (first byte of a quarter uses context 0), by the native codec."""
    from . import native_lib
    return native_lib.rans_compress(data, 1)


def rans_compress_o1_plain(data: bytes) -> bytes:
    """NumPy version of ``rans_compress_o1``: the same bytes."""
    arr = np.frombuffer(data, np.uint8)
    n = arr.size
    qs = _quarters(n)
    counts = np.zeros((256, 256), np.int64)
    for a, b in qs:
        if b > a:
            seg = arr[a:b]
            ctx = np.concatenate([[0], seg[:-1]])
            np.add.at(counts, (ctx, seg), 1)
    F2 = np.zeros_like(counts)
    for c in range(256):
        if counts[c].sum():
            F2[c] = _normalize_freqs(counts[c])
    C2 = np.zeros_like(F2)
    for c in range(256):
        C2[c] = _enc_tables(F2[c])

    x = [_RANS_L] * 4
    out = bytearray()
    xmax_mul = (_RANS_L >> _TF_SHIFT) << 8

    def put(j, i, a):
        """Encode arr[i] (quarter starting at a) with state j."""
        s = int(arr[i])
        cc = int(arr[i - 1]) if i > a else 0
        f = int(F2[cc, s])
        xm = xmax_mul * f
        while x[j] >= xm:
            out.append(x[j] & 0xFF)
            x[j] >>= 8
        x[j] = ((x[j] // f) << _TF_SHIFT) + (x[j] % f) + int(C2[cc, s])

    # exact reverse of the decode order: state-3 tail first, then the
    # round-robin (j descending within each position)
    isz4 = n >> 2
    a3 = qs[3][0]
    for i in range(n - 1, a3 + isz4 - 1, -1):
        put(3, i, a3)
    for i in range(isz4 - 1, -1, -1):
        for j in range(3, -1, -1):
            a = qs[j][0]
            put(j, a + i, a)
    ft = _write_freq_table_o1(F2)
    body = bytearray(ft)
    for j in range(4):
        body += int(x[j]).to_bytes(4, "little")
    body += out[::-1]
    hdr = bytes([1]) + len(body).to_bytes(4, "little") \
        + len(data).to_bytes(4, "little")
    return hdr + bytes(body)


def _rans_decode_o1(buf, pos: int, n_out: int, F2, C2) -> bytes:
    x = []
    for j in range(4):
        x.append(int.from_bytes(buf[pos:pos + 4], "little"))
        pos += 4
    qs = _quarters(n_out)
    out = bytearray(n_out)
    # per-context symbol lookup, built lazily (most contexts unused)
    luts: dict = {}

    def lut_for(c):
        t = luts.get(c)
        if t is None:
            t = np.zeros(_TOTFREQ, np.uint8)
            Fc, Cc = F2[c], C2[c]
            for s in range(256):
                if Fc[s]:
                    t[Cc[s]:Cc[s] + Fc[s]] = s
            luts[c] = t
        return t

    n = len(buf)
    ctx = [0, 0, 0, 0]

    def get(j, dst):
        nonlocal pos
        cc = ctx[j]
        xi = x[j]
        m = xi & (_TOTFREQ - 1)
        s = int(lut_for(cc)[m])
        out[dst] = s
        xi = int(F2[cc, s]) * (xi >> _TF_SHIFT) + m - int(C2[cc, s])
        while xi < _RANS_L and pos < n:
            xi = (xi << 8) | buf[pos]
            pos += 1
        x[j] = xi
        ctx[j] = s

    isz4 = n_out >> 2
    for i in range(isz4):
        for j in range(4):
            get(j, qs[j][0] + i)
    for dst in range(qs[3][0] + isz4, n_out):
        get(3, dst)
    return bytes(out)
