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
