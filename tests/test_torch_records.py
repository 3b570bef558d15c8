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


@pytest.mark.parametrize("graded", [True, False])
def test_qrels_match_jax(tmp_path, graded):
    """write_qrels writes the JAX package's bytes, and load_qrels reads
    them to the same map (tests/test_data.py:91), graded or not."""
    rows = [(0, 5, 1), (0, 7, 2), (3, 1, 1), (3, 1, 3)]
    a, b = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    jrec.write_qrels(a, rows)
    trec.write_qrels(b, rows)
    assert open(a, "rb").read() == open(b, "rb").read()
    got = trec.load_qrels(b, graded=graded)
    assert got == jrec.load_qrels(a, graded=graded)
    assert got == ({0: {5: 1, 7: 2}, 3: {1: 3}} if graded
                   else {0: {5: 1, 7: 1}, 3: {1: 1}})


@pytest.fixture()
def tiny_tokenizer(tmp_path):
    """tests/test_data.py's tokenizer: a BertTokenizerFast over a vocab
    file written here."""
    transformers = pytest.importorskip("transformers")
    vocab = (
        "[PAD] [UNK] [CLS] [SEP] [MASK] the quick brown fox jumps over lazy "
        "dog a an ##s hello world query document test".split()
    )
    vp = tmp_path / "vocab.txt"
    vp.write_text("\n".join(vocab))
    return transformers.BertTokenizerFast(vocab_file=str(vp),
                                          do_lower_case=False)


@pytest.mark.parametrize("lowercase,n_workers", [(True, 1), (False, 2)])
def test_msmarco_preprocess_matches_jax(tmp_path, tiny_tokenizer, lowercase,
                                        n_workers):
    """tests/test_data.py:149 through both packages: collection.tsv,
    queries.tsv and TREC qrels (plain and gzipped) give byte-identical
    records, pickles and offset-space qrels, and equal id maps; lowercase
    as condenser models take it, fork workers writing the serial bytes."""
    import gzip

    from cocodr_tpu.data import preprocess as jpre
    from cocodr_tpu_torch.data import preprocess as tpre

    coll = tmp_path / "collection.tsv"
    coll.write_text("".join(f"{10 * i}\tThe Quick brown FOX {'dog ' * i}\n"
                            for i in range(1, 9)))
    qs = tmp_path / "queries.tsv"
    qs.write_text("7\tquick Fox\n9\tLazy dog a\n")
    qrels = "7\t0\t20\t1\n9\t0\t10\t2\nbad line\n"
    (tmp_path / "qrels.tsv").write_text(qrels)
    with gzip.open(tmp_path / "qrels.tsv.gz", "wt") as f:
        f.write(qrels)
    out = {}
    for name, mod in (("j", jpre), ("t", tpre)):
        d = tmp_path / name
        d.mkdir()
        p2o = mod.tokenize_msmarco_passages(
            str(coll), str(d / "passages"), tiny_tokenizer, 8,
            lowercase=lowercase, n_workers=n_workers)
        q2o = mod.tokenize_queries(str(qs), str(d / "queries"),
                                   tiny_tokenizer, 6, lowercase=lowercase)
        rows = [mod.rewrite_qrels(str(tmp_path / src), str(d / f"q{i}.tsv"),
                                  q2o, p2o)
                for i, src in enumerate(("qrels.tsv", "qrels.tsv.gz"))]
        out[name] = (p2o, q2o, rows)
    assert out["t"] == out["j"]
    assert out["t"][2][0] == [(0, 1, 1), (1, 0, 2)]
    for f in ("passages", "passages_meta", "passages.pid2offset.pickle",
              "queries", "queries_meta", "queries.qid2offset.pickle",
              "q0.tsv", "q1.tsv"):
        assert (tmp_path / "j" / f).read_bytes() == (
            tmp_path / "t" / f).read_bytes(), f


def test_msmarco_docs_preprocess_matches_jax(tmp_path, tiny_tokenizer):
    """msmarco-docs.tsv (data_type=0): D-prefixed ids, url <sep> title
    <sep> body cut at 10,000 characters, and D-prefixed qrels docids:
    byte-identical records and equal maps."""
    from cocodr_tpu.data import preprocess as jpre
    from cocodr_tpu_torch.data import preprocess as tpre

    docs = tmp_path / "docs.tsv"
    docs.write_text("D3\thttp://a\tThe fox\tquick " * 1 + "dog " * 3000 + "\n"
                    "D8\thttp://b\tLazy\tdog world\n")
    (tmp_path / "qrels").write_text("1 0 D8 1\n")
    q = {1: 0}
    out = {}
    for name, mod in (("j", jpre), ("t", tpre)):
        p2o = mod.tokenize_msmarco_passages(
            str(docs), str(tmp_path / f"{name}_docs"), tiny_tokenizer, 16,
            data_type=0)
        rows = mod.rewrite_qrels(str(tmp_path / "qrels"),
                                 str(tmp_path / f"{name}_q"), q, p2o,
                                 delimiter=" ", docid_prefix=True)
        out[name] = (p2o, rows)
    assert out["t"] == out["j"] == ({3: 0, 8: 1}, [(0, 1, 1)])
    for suffix in ("_docs", "_docs_meta", "_q"):
        assert (tmp_path / f"j{suffix}").read_bytes() == (
            tmp_path / f"t{suffix}").read_bytes(), suffix
