"""The port's host IO codec (csrc/kbbq_io.cc through io/native_lib.py)
against its NumPy versions and the JAX package: the FASTQ record scan, the
padded-array decode and the quality write-back, BGZF in both directions,
and the .gz outputs of the entry points.  The codec builds here with g++.
Tolerance: exact equality.
"""

import gzip
import os

import numpy as np
import pytest

from kbbq_tpu.io import bgzf as jbgzf
from kbbq_tpu.io import fastq as jfq
from kbbq_tpu.oracle import kmers as jokm
from kbbq_tpu.pipeline import RecalConfig as JRecalConfig
from kbbq_tpu.pipeline import recalibrate_fastq as j_recalibrate_fastq
from kbbq_tpu.utils import synth as jsynth

from kbbq_tpu_torch.io import bgzf, native_lib
from kbbq_tpu_torch.io import fastq as tfq
from kbbq_tpu_torch.pipeline import RecalConfig, recalibrate_fastq

DATA = os.path.join(os.path.dirname(__file__), "data")


def _ragged(seed, n_reads=600, max_len=150, lower=True):
    """FASTQ text with reads of 1..max_len bases, N bases, lower-case
    sequences, empty and odd names."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for i in range(n_reads):
        m = int(rng.integers(1, max_len + 1))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), m,
                               p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        if lower and i % 7 == 0:
            seq = seq.lower()
        q = bytes((rng.integers(0, 45, m) + 33).astype(np.uint8))
        name = [f"r{i}/1", f"r{i}/2 c", "", f" x{i}/2"][i % 4]
        out += b"@%s\n%s\n+%s\n%s\n" % (name.encode(), seq,
                                        b"" if i % 3 else b"r", q)
    return bytes(out)


TEXTS = {
    "tiny": lambda: open(os.path.join(DATA, "tiny.fq"), "rb").read(),
    "ragged": lambda: _ragged(1),
    "long_reads": lambda: _ragged(2, n_reads=300, max_len=600),
    "many_short": lambda: _ragged(3, n_reads=3000, max_len=20),
    "no_trailing_newline": lambda: _ragged(4, n_reads=40)[:-1],
    "empty": lambda: b"",
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_index_extract_render_match_plain_and_jax(name):
    data = TEXTS[name]()
    nat, plain = tfq.parse_fastq_bytes(data), tfq.parse_fastq_bytes_plain(data)
    jax = jfq.parse_fastq_bytes(data)
    for field in ("buf", "name_starts", "name_ends", "seq_starts",
                  "seq_ends", "qual_starts", "qual_ends"):
        a = getattr(nat, field)
        assert np.array_equal(a, getattr(plain, field)), field
        assert np.array_equal(a, getattr(jax, field)), field
        assert a.dtype == getattr(plain, field).dtype
    for L in (None, 700):
        got = tfq.extract_padded_arrays(nat, L)
        want = tfq.extract_padded_arrays_plain(plain, L)
        jwant = jfq.extract_padded_arrays(jax, L)
        for a, b, c in zip(got, want, jwant):
            assert a.dtype == b.dtype == c.dtype
            assert np.array_equal(a, b) and np.array_equal(a, c)
    codes, quals, mask, _ = got
    # the decode's mask is its uint8 buffer seen as bool
    assert mask.dtype == bool and (mask.base is None
                                   or mask.base.dtype == np.uint8)
    rng = np.random.default_rng(len(data))
    new = rng.integers(0, 94, quals.shape).astype(np.int8)
    r = tfq.render_fastq_with_quals(nat, new, mask)
    assert r == tfq.render_fastq_with_quals_plain(plain, new, mask)
    assert r == jfq.render_fastq_with_quals(jax, new, mask)
    assert tfq.render_fastq_with_quals(nat, quals, mask) == \
        nat.buf.tobytes()


def _long_names(seed, n_reads=300):
    """Names whose first token is longer than the columns seconds_mask
    gathers (some ending '/2'), whitespace at and past that column, names
    of whitespace only, a tab before the comment."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    cols = tfq._NAME_COLS
    for i in range(n_reads):
        body = "x" * int(rng.integers(cols - 3, cols + 4))
        name = [f"{body}/2", f"{body}/1 c/2", f"{body[:cols - 2]}/2 tail",
                f"{body[:cols - 1]} /2", " \t ", f"r{i}/2\tc", f"{body}/2\t",
                "/2 " + body][i % 8]
        out += b"@%s\nACGT\n+\nIIII\n" % name.encode()
    return bytes(out)


@pytest.mark.parametrize("name", sorted(TEXTS) + ["long_names"])
def test_seconds_mask_equals_the_jax_packages(name):
    data = _long_names(5) if name == "long_names" else TEXTS[name]()
    fq = tfq.parse_fastq_bytes(data)
    want = np.zeros(fq.num_reads, bool)
    for i in range(fq.num_reads):          # the JAX package's rule, per name
        tok = fq.name_bytes(i).split()
        want[i] = bool(tok) and tok[0].endswith(b"/2")
    assert np.array_equal(fq.seconds_mask(), want)
    if name != "long_names":              # (whitespace-only names: JAX raises)
        assert np.array_equal(jfq.parse_fastq_bytes(data).seconds_mask(), want)
    if name in ("long_names", "ragged"):
        assert 0 < want.sum() < fq.num_reads


MALFORMED = [
    b"@r1\nACGT\n+\nIIII\n@r2\nACGT\n+\n",        # a record cut short
    b"@a\nAC\n+\n",                               # no quality line
    b"r1\nACGT\n+\nFFFF\n",                       # no '@'
    b"@r1\nACGT\n+\nFFFF\nr2\nACGT\n+\nFFFF\n",   # the second has no '@'
    b"@r1\nACGT\n+\nFFF\n",                       # quality shorter
    b"@r1\nACGT\n+\nFFFF\n@r2\nAC\n+\nFFF",       # longer, no last newline
]


@pytest.mark.parametrize("data", MALFORMED, ids=range(len(MALFORMED)))
def test_malformed_input_raises_the_plain_versions_error(data):
    with pytest.raises(ValueError) as plain:
        tfq.parse_fastq_bytes_plain(data)
    with pytest.raises(ValueError) as nat:
        tfq.parse_fastq_bytes(data)
    assert str(nat.value) == str(plain.value)
    with pytest.raises(ValueError):
        jfq.parse_fastq_bytes(data)


def test_scanner_refuses_what_only_it_checks():
    """A third line without its '+': the NumPy version takes it as a record,
    the scanner names the record's byte offset."""
    data = b"@r1\nACGT\n+\nFFFF\n@r2\nACGT\nx\nFFFF\n"
    assert tfq.parse_fastq_bytes_plain(data).num_reads == 2
    with pytest.raises(ValueError, match="at byte 16"):
        tfq.parse_fastq_bytes(data)
    idx = native_lib.fastq_index(np.frombuffer(data[:16], np.uint8))
    assert idx.shape == (1, 8) and idx[0].tolist() == [1, 3, 4, 8, 0, 0,
                                                      11, 15]


@pytest.mark.parametrize("size", [0, 1, 1000, 0xFF00, 0xFF00 + 1, 70000,
                                  500_000])
def test_bgzf_equals_the_jax_package_and_round_trips(size):
    rng = np.random.default_rng(size)
    # half random bytes, half FASTQ-like text: both compress ratios
    data = (rng.integers(0, 256, size // 2, dtype=np.uint8).tobytes()
            + _ragged(size, n_reads=size // 200 + 1)[:size - size // 2])
    got = bgzf.compress(data, 2)
    assert got == jbgzf.compress(data, 2) == bgzf._compress_py(data, 2)
    assert got == jbgzf._compress_py(data, 2)
    assert got.endswith(bgzf.BGZF_EOF) and bgzf.is_bgzf(got)
    assert bgzf.decompress(got) == data == gzip.decompress(got)
    assert jbgzf.decompress(got) == data
    assert bgzf.compress(data) == got            # level 2 is the default
    assert bgzf.compress(data, 6) == jbgzf.compress(data, 6)


def test_bgzf_refuses_garbage():
    with pytest.raises(bgzf.BGZFError):
        bgzf.decompress(b"garbage" * 10)
    good = bgzf.compress(b"ACGT" * 50000)
    bad = bytearray(good)
    bad[40] ^= 0xFF                               # inside the first payload
    with pytest.raises(bgzf.BGZFError):
        bgzf.decompress(bytes(bad))


@pytest.mark.parametrize("pieces", [1, 3, 1000])
def test_stream_writer_equals_whole_compress(tmp_path, pieces):
    data = _ragged(9, n_reads=5000)
    cuts = np.linspace(0, len(data), pieces + 1).astype(int)
    p = tmp_path / "w.gz"
    with open(p, "wb") as f:
        w = bgzf.BGZFStreamWriter(f, flush_bytes=200_000)
        for a, b in zip(cuts[:-1], cuts[1:]):
            w.write(data[a:b])
        w.close()
    assert p.read_bytes() == jbgzf.compress(data, 2)
    sink = tfq.open_fastq_sink(str(tmp_path / "s.fq.gz"))
    sink.write(data[:12345])
    sink.flush()
    sink.write(data[12345:])
    sink.close()
    assert (tmp_path / "s.fq.gz").read_bytes() == p.read_bytes()


def _small_fastq(tmp_path, name, seed, read_len=60):
    ds = jsynth.make_dataset(genome_len=1200, read_len=read_len,
                             coverage=15.0, error_rate=0.02, seed=seed,
                             paired=True, n_rate=0.01)
    p = tmp_path / name
    p.write_bytes(jsynth.to_fastq_bytes(ds))
    return p


def test_gz_outputs_are_the_jax_packages_bytes(tmp_path):
    """One input to a .gz path, and two inputs to one .gz sink (blocks run
    across the files' boundary): the files the JAX package writes, byte for
    byte; .gz paths per input hold each input's BGZF bytes."""
    a = _small_fastq(tmp_path, "a.fq", 5)
    b = _small_fastq(tmp_path, "b.fq", 6, read_len=45)
    cfg = dict(k=16, coverage=15.0, batch_size=64)
    two, jtwo = tmp_path / "two.fq.gz", tmp_path / "j_two.fq.gz"
    recalibrate_fastq([str(a), str(b)], str(two), RecalConfig(**cfg),
                      device="cpu")
    j_recalibrate_fastq([str(a), str(b)], str(jtwo), JRecalConfig(**cfg))
    raw = two.read_bytes()
    assert raw == jtwo.read_bytes()
    assert bgzf.is_bgzf(raw) and raw.endswith(bgzf.BGZF_EOF)
    # one input to a .gz path: the JAX package's writer on the same records
    one = tmp_path / "one.fq.gz"
    recalibrate_fastq(str(a), str(one), RecalConfig(**cfg), device="cpu")
    recs = gzip.decompress(one.read_bytes())
    jfq._write_out(recs, str(tmp_path / "j_one.fq.gz"))
    assert one.read_bytes() == (tmp_path / "j_one.fq.gz").read_bytes()
    outs = [str(tmp_path / "a.out.fq.gz"), str(tmp_path / "b.out.fq.gz")]
    plain = [str(tmp_path / "a.out.fq"), str(tmp_path / "b.out.fq")]
    recalibrate_fastq([str(a), str(b)], outs, RecalConfig(**cfg),
                      device="cpu")
    recalibrate_fastq([str(a), str(b)], plain, RecalConfig(**cfg),
                      device="cpu")
    for o, p in zip(outs, plain):
        assert open(o, "rb").read() == jbgzf.compress(open(p, "rb").read(),
                                                      2)


def test_failed_build_raises_with_the_compilers_words(tmp_path, monkeypatch):
    """No compiler (or one that fails): the codec raises, nothing falls
    back to the NumPy versions."""
    monkeypatch.setattr(native_lib, "_lib", None)
    monkeypatch.setattr(native_lib, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_lib, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        tfq.parse_fastq_bytes(b"@a\nACGT\n+\nIIII\n")
    bad_src = tmp_path / "broken.cc"
    bad_src.write_text("this is not C++\n")
    monkeypatch.setattr(native_lib, "CXX", "g++")
    monkeypatch.setattr(native_lib, "SOURCE", str(bad_src))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_lib.library()
    assert not os.path.exists(native_lib.LIBRARY)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_failed_build_raises_on_the_bam_paths(tmp_path, monkeypatch):
    """Without the codec the BAM index, decode and write-back raise: no
    NumPy route is taken."""
    from kbbq_tpu_torch.io import bam_vec
    from kbbq_tpu_torch.io.bam import index_bam_bytes
    data, offs, _ = _bam_stream(1, n=3)
    monkeypatch.setattr(native_lib, "_lib", None)
    monkeypatch.setattr(native_lib, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_lib, "CXX", str(tmp_path / "no-such-g++"))
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((3, 8), np.int8)
    for call in (lambda: native_lib.bam_offsets(data),
                 lambda: index_bam_bytes(b"BAM\x01" + bytes(8) + data),
                 lambda: bam_vec.decode_group(buf, offs, offs, [0] * 3, 8,
                                              False, out, out.copy()),
                 lambda: bam_vec.write_quals(buf.copy(), offs, [8] * 3,
                                             [0] * 3, out)):
        with pytest.raises(RuntimeError, match="not found"):
            call()


def test_build_is_fresh_and_reused(tmp_path, monkeypatch):
    """A build goes to a temporary name and is renamed; a library newer
    than its source is loaded as it is."""
    monkeypatch.setattr(native_lib, "_lib", None)
    monkeypatch.setattr(native_lib, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(tmp_path))
    path = native_lib.build()
    assert path == native_lib.LIBRARY and native_lib.build_seconds > 0
    mtime = os.path.getmtime(path)
    native_lib.build_seconds = 0.0
    assert native_lib.build() == path and os.path.getmtime(path) == mtime
    assert native_lib.build_seconds == 0.0
    assert native_lib.library().kbbq_bgzf_size(None, 0) == 0


def test_port_never_loads_the_jax_packages_library():
    import kbbq_tpu_torch
    assert native_lib.LIBRARY.startswith(
        os.path.dirname(kbbq_tpu_torch.__file__))
    native_lib.library()
    maps = open("/proc/self/maps").read()
    port_lib = os.path.realpath(native_lib.LIBRARY)
    assert port_lib in maps
    assert native_lib.SOURCE.endswith(os.path.join("kbbq_tpu_torch", "csrc",
                                                   "kbbq_io.cc"))


def test_codec_refuses_offsets_outside_the_buffer():
    """The bindings check sizes and bounds before handing pointers over."""
    buf = np.frombuffer(b"@a\nACGT\n+\nIIII\n", np.uint8)
    out = [np.empty((1, 8), dt) for dt in (np.int8, np.int8, np.uint8)]
    lut = tfq._ENCODE_LUT
    native_lib.fastq_extract(buf, [3], [10], [4], 8, lut, *out)  # the record
    assert out[0][0, :4].tolist() == lut[np.frombuffer(b"ACGT",
                                                        np.uint8)].tolist()
    for ss, qs, ln in (([3], [14], [4]), ([-1], [10], [4]), ([3], [10], [9]),
                       ([3], [10], [-1])):
        with pytest.raises(ValueError):
            native_lib.fastq_extract(buf, ss, qs, ln, 8, lut, *out)
    with pytest.raises(ValueError):                 # wrong output dtype
        native_lib.fastq_extract(buf, [3], [10], [4], 8, lut, out[0], out[1],
                                 out[0])
    with pytest.raises(ValueError, match="outside"):
        native_lib.fastq_write_quals(buf.copy(), [14], [4],
                                     np.zeros((1, 4), np.int8))


def test_encode_table_and_padding_of_the_decode():
    """Every byte value through the decode: the encode table's codes, quals
    clipped to [0, 93], padding code 4 / qual 0 / mask 0."""
    seq = bytes(range(33, 127))
    data = b"@a\n%s\n+\n%s\n@b\nA\n+\n%s\n" % (seq, seq[::-1], bytes([32]))
    fq = tfq.parse_fastq_bytes(data)
    got = tfq.extract_padded_arrays(fq, 100)
    want = tfq.extract_padded_arrays_plain(tfq.parse_fastq_bytes_plain(data),
                                           100)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    codes, quals, mask, lens = got
    assert lens.tolist() == [94, 1] and quals.min() == 0 and quals.max() == 93
    assert (codes[1, 1:] == 4).all() and not mask[1, 1:].any()
    assert np.array_equal(codes[0, :94],
                          jokm._ENCODE_LUT[np.frombuffer(seq, np.uint8)])


# ------------------------------------------------------------------ BAM

def _bam_stream(seed, n=300, max_len=160):
    """Raw BAM records (block_size + body) of random bodies of 33..max_len
    bytes -> (bytes, offs, sizes)."""
    rng = np.random.default_rng(seed)
    out, offs, sizes = bytearray(), [], []
    for _ in range(n):
        size = int(rng.integers(33, max_len))
        out += int(size).to_bytes(4, "little", signed=True)
        offs.append(len(out))
        sizes.append(size)
        out += rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    return bytes(out), np.asarray(offs, np.int64), np.asarray(sizes,
                                                            np.int64)


@pytest.mark.parametrize("cut", [0, 1, 3, 4, 20])
@pytest.mark.parametrize("start", [0, "second"])
def test_bam_offsets_match_plain_and_stop_at_a_truncated_record(cut, start):
    from kbbq_tpu_torch.io import bam_stream
    data, offs, sizes = _bam_stream(cut)
    data = data[:len(data) - cut]
    s = 0 if start == 0 else int(offs[1] - 4)
    got = native_lib.bam_offsets(data, s)
    want = bam_stream._scan_record_index_plain(data, s)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    keep = offs.size - (cut > 0)
    first = 0 if start == 0 else 1
    assert np.array_equal(got[0], offs[first:keep])
    assert np.array_equal(got[1], sizes[first:keep])
    assert got[2] == (len(data) if cut == 0 else int(offs[keep] - 4))


@pytest.mark.parametrize("size", [0, -7])
def test_bam_offsets_refuse_a_size_that_is_not_positive(size):
    from kbbq_tpu_torch.io import bam_stream
    from kbbq_tpu_torch.io.bam import BAMError
    data, offs, _ = _bam_stream(9, n=5)
    at = int(offs[3] - 4)
    bad = data[:at] + int(size).to_bytes(4, "little", signed=True) + \
        data[at + 4:]
    with pytest.raises(ValueError, match=f"malformed BAM record size at "
                                         f"byte {at}$"):
        native_lib.bam_offsets(bad)
    for fn in (bam_stream._scan_record_index,
               bam_stream._scan_record_index_plain):
        with pytest.raises(BAMError, match=f"byte {at}$"):
            fn(bad, 0)


def test_bam_offsets_of_more_records_than_a_first_guess():
    """Records shorter than any real one (5 bytes): the index loops past
    its first capacity and still finds them all."""
    data = b"".join(b"\x01\x00\x00\x00" + bytes([i % 256])
                    for i in range(1000))
    offs, sizes, end = native_lib.bam_offsets(data)
    assert offs.tolist() == list(range(4, 5000, 5)) and end == 5000
    assert (sizes == 1).all()


def _decode_case(seed, n=400, lens=(1, 2, 7, 150, 151)):
    rng = np.random.default_rng(seed)
    L = int(rng.choice(lens))
    buf = rng.integers(0, 256, 20000, dtype=np.uint8)
    seq = rng.integers(0, 20000 - (L + 1) // 2, n)
    qual = rng.integers(0, 20000 - L, n)
    rev = rng.random(n) < 0.5
    return buf, seq, qual, rev, L


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("use_oq", [False, True])
def test_bam_decode_matches_plain(seed, use_oq):
    """Every nibble and byte value, odd lengths, reverse rows, OQ values
    (phred + 33 clipped to [0, 93]) and QUAL (clipped to 93), into a wider
    output: the NumPy version's bytes, the columns past L untouched."""
    from kbbq_tpu_torch.io import bam_vec
    buf, seq, qual, rev, L = _decode_case(seed, n=1500 if seed else 3)
    n, W = seq.size, L + 3
    got = [np.full((n, W), 77, np.int8) for _ in range(2)]
    want = [np.full((n, W), 77, np.int8) for _ in range(2)]
    bam_vec.decode_group(buf, seq, qual, rev, L, use_oq, *got)
    bam_vec.decode_group_plain(buf, seq, qual, rev, L, use_oq, *want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert (got[0][:, L:] == 77).all()
    assert set(np.unique(got[0][:, :L])) <= {0, 1, 2, 3, 4}
    assert got[1][:, :L].min() >= 0 and got[1][:, :L].max() <= 93


@pytest.mark.parametrize("seed", range(4))
def test_bam_write_quals_matches_plain(seed):
    """Mixed and odd lengths, reverse rows: the NumPy version's bytes, and
    nothing outside the QUAL fields written."""
    from kbbq_tpu_torch.io import bam_vec
    rng = np.random.default_rng(seed)
    n, W = 2000 if seed else 5, 151
    lens = rng.integers(1, W + 1, n)
    qoff = np.cumsum(np.r_[0, lens[:-1] + 3]) + 2
    buf = rng.integers(0, 256, int(qoff[-1] + lens[-1] + 5), dtype=np.uint8)
    rev = rng.random(n) < 0.5
    new_q = rng.integers(0, 94, (n, W)).astype(np.int8)
    got, want = buf.copy(), buf.copy()
    bam_vec.write_quals(got, qoff, lens, rev, new_q)
    bam_vec.write_quals_plain(want, qoff, lens, rev, new_q)
    assert np.array_equal(got, want)
    is_q = np.zeros(buf.size, bool)
    for o, m in zip(qoff, lens):
        is_q[o:o + m] = True
    assert np.array_equal(got[~is_q], buf[~is_q])
    i = int(np.flatnonzero(rev)[0])
    assert got[qoff[i]:qoff[i] + lens[i]].tolist() == \
        new_q[i, :lens[i]][::-1].tolist()


@pytest.mark.parametrize("layout", ["uniform", "mixed"])
def test_bam_append_oq_matches_plain(layout):
    """Records that grow an OQ tag (the ORIGINAL qualities + 33, wrapping
    for 0xff) and records copied as they are: the NumPy version's bytes
    (its fixed-size reshape for the uniform layout)."""
    from kbbq_tpu_torch.io import bam_vec
    rng = np.random.default_rng(4)
    if layout == "uniform":
        n, size = 50, 90
        data = bytearray()
        for _ in range(n):
            data += size.to_bytes(4, "little") + rng.integers(
                0, 256, size, dtype=np.uint8).tobytes()
        offs = 4 + np.arange(n, dtype=np.int64) * (size + 4)
        sizes = np.full(n, size, np.int64)
        prim = np.arange(n)
    else:
        data, offs, sizes = _bam_stream(5, n=300)
        prim = np.flatnonzero(rng.random(offs.size) < 0.8)
    buf = np.frombuffer(bytes(data), np.uint8)
    lens = np.minimum(sizes[prim] - 20, 40)
    qoff = offs[prim] + 10
    wbuf = buf.copy()
    wbuf[qoff] ^= 0x5A                 # rewritten QUAL bytes: taken from wbuf
    got = bam_vec.append_oq(wbuf, buf, offs, sizes, prim, qoff, lens)
    want = bam_vec.append_oq_plain(wbuf, buf, offs, sizes, prim, qoff, lens)
    assert np.array_equal(got, want)
    assert got.size == buf.size + int((lens + 4).sum())


def test_bam_bindings_refuse_offsets_outside_the_buffer():
    buf = np.zeros(64, np.uint8)
    out = [np.empty((1, 8), np.int8) for _ in range(2)]
    native_lib.bam_decode(buf, [60], [56], [True], 8, False, *out)
    for seq, qual, L in (([61], [0], 8), ([0], [57], 8), ([-1], [0], 8)):
        with pytest.raises(ValueError, match="outside"):
            native_lib.bam_decode(buf, seq, qual, [False], L, False, *out)
    with pytest.raises(ValueError):                  # output narrower than L
        native_lib.bam_decode(buf, [0], [0], [False], 9, False, *out)
    with pytest.raises(ValueError, match="outside"):
        native_lib.bam_write_quals(buf.copy(), [60], [5], [False],
                                   np.zeros((1, 5), np.int8))
    with pytest.raises(ValueError, match="longer"):
        native_lib.bam_write_quals(buf.copy(), [0], [6], [False],
                                   np.zeros((1, 5), np.int8))
    with pytest.raises(ValueError, match="outside"):
        native_lib.bam_append_oq(buf, buf, [4], [61], [0], [-1])


# ------------------------------------------------------------------- rANS

@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 4, 5, 999, 1000, 1001, 20000])
def test_rans_bindings_round_trip_and_equal_the_plain_coder(order, n):
    from kbbq_tpu_torch.io import cram_codecs
    rng = np.random.default_rng(n + order)
    data = bytes(rng.integers(30, 42, n).astype(np.uint8))
    blob = native_lib.rans_compress(data, order)
    plain = (cram_codecs.rans_compress_o0_plain if order == 0
             else cram_codecs.rans_compress_o1_plain)
    assert blob == plain(data)
    assert native_lib.rans_uncompress(blob, n) == data
    # from a numpy array and from a memoryview alike
    assert native_lib.rans_uncompress(np.frombuffer(blob, np.uint8), n) == \
        native_lib.rans_uncompress(memoryview(blob), n) == data


def test_rans_bindings_check_sizes_and_orders():
    blob = native_lib.rans_compress(b"ACGT" * 100, 0)
    for n in (399, 401):
        with pytest.raises(ValueError, match="rc=-2"):
            native_lib.rans_uncompress(blob, n)
    with pytest.raises(ValueError, match="negative"):
        native_lib.rans_uncompress(blob, -1)
    with pytest.raises(ValueError, match="order"):
        native_lib.rans_compress(b"ACGT", 2)
    for cut in (0, 5, 9, 12, 20):
        with pytest.raises(ValueError, match="rANS: malformed"):
            native_lib.rans_uncompress(blob[:cut], 400)


def test_failed_build_raises_on_the_rans_paths(tmp_path, monkeypatch):
    """Without the codec the CRAM block coder raises: the NumPy coder is
    never reached from the reader or the writer."""
    from kbbq_tpu_torch.io import cram_codecs
    blob = native_lib.rans_compress(b"ACGT" * 100, 1)
    monkeypatch.setattr(native_lib, "_lib", None)
    monkeypatch.setattr(native_lib, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_lib, "CXX", str(tmp_path / "no-such-g++"))
    for call in (lambda: cram_codecs.rans_uncompress(blob),
                 lambda: cram_codecs.rans_compress_o0(b"ACGT"),
                 lambda: cram_codecs.rans_compress_o1(b"ACGT" * 400)):
        with pytest.raises(RuntimeError, match="not found"):
            call()
