"""Token records: the port's copy of data/records.py against the JAX
package's, on the same token lists. The file format must be the same byte
for byte, and each package must read the other's files."""
import numpy as np
import pytest

from cocodr_tpu.data import records as jrec
from cocodr_tpu_torch.data import records as trec


def _docs(n=23, max_len=12, seed=0):
    rng = np.random.RandomState(seed)
    # lengths 0..max_len+3: empty records and records cut at max_len too
    return [rng.randint(1, 30000, rng.randint(0, max_len + 4)).tolist()
            for _ in range(n)]


def _write(mod, path, docs, max_len=12):
    with mod.RecordWriter(str(path), max_len) as w:
        offsets = [w.write(d) for d in docs]
    return offsets


def test_files_are_byte_identical(tmp_path):
    docs = _docs()
    jo = _write(jrec, tmp_path / "jax", docs)
    to = _write(trec, tmp_path / "port", docs)
    assert jo == to == list(range(len(docs)))
    for suffix in ("", "_meta"):
        assert ((tmp_path / f"jax{suffix}").read_bytes()
                == (tmp_path / f"port{suffix}").read_bytes())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    docs = _docs(seed=1)
    path = tmp_path / "recs"
    _write(jrec if writer == "jax" else trec, path, docs)
    jc, tc = jrec.TokenCache(str(path)), trec.TokenCache(str(path))
    assert len(tc) == len(jc) == len(docs) and tc.max_len == 12
    np.testing.assert_array_equal(tc.lengths(), jc.lengths())
    np.testing.assert_array_equal(tc.lengths(),
                                  [min(len(d), 12) for d in docs])
    idx = np.array([5, 0, 22, 5, 13])
    for got, want in zip(tc.batch_with_mask(idx), jc.batch_with_mask(idx)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tc.batch(idx), jc.batch(idx)):
        np.testing.assert_array_equal(got, want)
    n, toks = tc[3]
    assert n == min(len(docs[3]), 12)
    np.testing.assert_array_equal(toks[:n], docs[3][:n])


def test_size_mismatch_raises(tmp_path):
    path = tmp_path / "recs"
    _write(trec, path, _docs(n=4))
    with open(path, "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError, match="size"):
        trec.TokenCache(str(path))


def test_id_maps_cross_load(tmp_path):
    mapping = {f"doc{i}": i for i in range(50)}
    trec.save_id_map(mapping, str(tmp_path / "port.pkl"))
    jrec.save_id_map(mapping, str(tmp_path / "jax.pkl"))
    assert jrec.load_id_map(str(tmp_path / "port.pkl")) == mapping
    assert trec.load_id_map(str(tmp_path / "jax.pkl")) == mapping
    assert ((tmp_path / "port.pkl").read_bytes()
            == (tmp_path / "jax.pkl").read_bytes())
