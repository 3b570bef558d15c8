"""The port's threaded record reader (data/native.py, csrc/host/recordio.cpp)
against the port's memmap TokenCache and the JAX package's
NativeTokenCache on record files of data/records.py: the same arrays byte
for byte (tokens, lengths, masks), at one and at several threads. An index
out of range raises IndexError, a meta file that disagrees with the
record file ValueError, a failed build RuntimeError with the compiler's
output (no fallback); two processes building at once leave one library;
the port never maps the JAX package's native/librecordio.so."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from cocodr_tpu_torch.data import native
from cocodr_tpu_torch.data.records import RecordWriter, TokenCache

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """1,000 records of 0-40 tokens at max_len 32 (longer ones cut)."""
    path = str(tmp_path_factory.mktemp("rec") / "passages")
    rng = np.random.default_rng(0)
    with RecordWriter(path, 32) as w:
        for _ in range(1000):
            w.write(rng.integers(0, 50_000, rng.integers(0, 41)).tolist())
    return path


def same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n_threads", [1, 4])
def test_gathers_equal_token_cache_and_the_jax_reader(records, n_threads):
    """batch, batch_with_mask, __getitem__ and lengths, over batches that
    do and do not reach the threads (n >= 2 x n_threads), repeats and an
    empty batch."""
    from cocodr_tpu.data.native import NativeTokenCache as JaxNative

    ours = native.NativeTokenCache(records, n_threads=n_threads)
    plain, jax_reader = TokenCache(records), JaxNative(records, n_threads)
    assert len(ours) == len(plain) == 1000 and ours.max_len == 32
    rng = np.random.default_rng(1)
    for idx in (rng.integers(0, 1000, 777), [0, 999, 5, 5], [3],
                np.zeros(0, np.int64)):
        for method in ("batch", "batch_with_mask"):
            got = getattr(ours, method)(idx)
            for ref in (getattr(plain, method)(idx),
                        getattr(jax_reader, method)(idx)):
                for a, b in zip(got, ref):
                    same(a, b)
    same(ours.lengths(), plain.lengths())
    same(ours.lengths(), jax_reader.lengths())
    for i in (0, 17, 999):
        (n, toks), (m, ref) = ours[i], plain[i]
        assert n == m
        same(toks, ref)
    jax_reader.close()
    ours.close()
    ours.close()
    with pytest.raises(ValueError, match="closed"):
        ours.batch([0])


def test_index_out_of_range_raises(records):
    ours = native.NativeTokenCache(records)
    for idx in ([1000], [0, -1], np.arange(990, 1010)):
        with pytest.raises(IndexError, match="out of range"):
            ours.batch(idx)
        with pytest.raises(IndexError, match="out of range"):
            ours.batch_with_mask(idx)


@pytest.mark.parametrize("meta", [
    {"total_number": 999}, {"total_number": 1001}, {"embedding_size": 31},
    {"type": "int64"}])
def test_meta_mismatch_raises(records, tmp_path, meta):
    path = tmp_path / "rec"
    path.write_bytes(Path(records).read_bytes())
    with open(records + "_meta") as f:
        good = json.load(f)
    (tmp_path / "rec_meta").write_text(json.dumps({**good, **meta}))
    with pytest.raises(ValueError):
        native.NativeTokenCache(str(path))


def test_open_token_cache_chooses_the_reader(records, monkeypatch):
    """The native reader by default, the memmap one when asked, and a
    build that fails raises where the JAX factory fell back."""
    assert isinstance(native.open_token_cache(records),
                      native.NativeTokenCache)
    assert isinstance(native.open_token_cache(records, prefer_native=False),
                      TokenCache)

    def broken():
        raise RuntimeError("building the record reader failed")

    monkeypatch.setattr(native, "library", broken)
    with pytest.raises(RuntimeError, match="failed"):
        native.open_token_cache(records)


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                      monkeypatch):
    src = tmp_path / "recordio.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", src)
    with pytest.raises(RuntimeError, match="recordio.cpp") as err:
        native._build(tmp_path / "out")
    assert "error" in str(err.value)
    assert not list((tmp_path / "out").iterdir())  # no library, no tmp dir


def test_two_processes_building_at_once_leave_one_library(tmp_path,
                                                          records):
    """Both processes build into one fresh root and read a record; the
    root then holds one library and no temporary directory."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from cocodr_tpu_torch.data import native
        lib = native.library(Path(sys.argv[1]))
        native.library = lambda: lib
        print(native.NativeTokenCache({records!r})[3][0])
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    want = str(TokenCache(records)[3][0])
    assert [o.strip() for o, _ in outs] == [want, want]
    built = native.build_dir(tmp_path)
    assert [p.name for p in tmp_path.iterdir()] == [built.name]
    assert [p.name for p in built.iterdir()] == [native.LIB_NAME]


def test_the_jax_packages_library_is_never_mapped(records):
    """In a fresh process the reader maps the port's own build, and not
    native/librecordio.so."""
    code = textwrap.dedent(f"""
        from cocodr_tpu_torch.data.native import open_token_cache
        open_token_cache({records!r}).batch([0, 1])
        print(open("/proc/self/maps").read())
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert str(native.build_dir() / native.LIB_NAME) in out.stdout
    assert str(ROOT / "native" / "librecordio.so") not in out.stdout
