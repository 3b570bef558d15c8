"""What the tests of the port's CLI share (tests/test_torch_cli_*.py): the
tiny HuggingFace checkpoint of tests/test_cli.py (BERT, 2 layers, H 32, a
vocabulary of 18 words), the BEIR, MS MARCO and triples files written from
a seed, and the helpers that run a subcommand and read its JSON lines.
Each test file imports the fixtures it uses; this file's own tests hold
the fixtures' files to what the subcommands read."""
import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

CPU = ["--cpu-devices", "1"]
WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa filler "
         "study report").split()
VOCAB = "[PAD] [UNK] [CLS] [SEP] [MASK]".split() + WORDS


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """Tiny HF BertForMaskedLM checkpoint dir + matching tokenizer files
    (tests/test_cli.py's fixture), written as pytorch_model.bin."""
    d = tmp_path_factory.mktemp("hf_ckpt")
    torch.manual_seed(0)
    cfg = transformers.BertConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64,
    )
    m = transformers.BertForMaskedLM(cfg)
    m.save_pretrained(str(d), safe_serialization=False)
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    tok = transformers.BertTokenizerFast(vocab_file=str(d / "vocab.txt"))
    tok.save_pretrained(str(d))
    return str(d)


def write_beir(tmp_path, n_docs=8, name="beir", seed=None):
    """tests/test_cli.py's BEIR task (n_docs 8, seed None); with a seed,
    n_docs documents of random words, 6 queries, 2 relevant docs each."""
    beir = tmp_path / name
    (beir / "qrels").mkdir(parents=True)
    if seed is None:
        words = ["alpha", "beta", "gamma", "delta"]
        docs = [f"{words[i % 4]} {words[i % 4]} filler" for i in range(n_docs)]
        queries = words
        rel = [(j, i) for j in range(4) for i in range(n_docs) if i % 4 == j]
    else:
        rng = np.random.RandomState(seed)
        docs = [" ".join(rng.choice(WORDS, rng.randint(3, 10)))
                for _ in range(n_docs)]
        queries = [" ".join(rng.choice(WORDS, 3)) for _ in range(6)]
        rel = [(j, int(i)) for j in range(6)
               for i in rng.choice(n_docs, 2, replace=False)]
    with open(beir / "corpus.jsonl", "w") as f:
        for i, text in enumerate(docs):
            f.write(json.dumps({"_id": f"d{i}", "title": "",
                                "text": text}) + "\n")
    with open(beir / "queries.jsonl", "w") as f:
        for j, text in enumerate(queries):
            f.write(json.dumps({"_id": f"q{j}", "text": text}) + "\n")
    with open(beir / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for j, i in rel:
            f.write(f"q{j}\td{i}\t1\n")
    return str(beir)


def write_marco(tmp_path, n_docs=32, name="marco"):
    """tests/test_cli.py's MS MARCO records: n_docs passages of 8 tokens,
    8 train and 4 dev queries of 5, query q's positive passage q * 4."""
    from cocodr_tpu_torch.data.records import RecordWriter, write_qrels

    rng = np.random.RandomState(0)
    data = tmp_path / name
    data.mkdir()
    with RecordWriter(str(data / "passages"), 12) as w:
        for _ in range(n_docs):
            w.write([2] + rng.randint(5, 18, size=6).tolist() + [3])
    for split, n in (("train-query", 8), ("dev-query", 4)):
        with RecordWriter(str(data / split), 8) as w:
            for _ in range(n):
                w.write([2] + rng.randint(5, 18, size=3).tolist() + [3])
    step = n_docs // 8
    write_qrels(str(data / "train-qrel.tsv"),
                [(q, q * step, 1) for q in range(8)])
    write_qrels(str(data / "dev-qrel.tsv"),
                [(q, q * step, 1) for q in range(4)])
    return data


def write_marco_tsv(tmp_path, n_docs=40, n_train=12, n_dev=6, seed=0):
    """An MS MARCO-shaped TSV collection from a seed: collection.tsv
    (pid \\t text, mixed case, some accents and punctuation),
    queries.{train,dev}.tsv, qrels.{train,dev}.tsv (TREC, one positive a
    query), top1000.dev.tsv (qid \\t pid, 5 candidates a dev query) ->
    the directory."""
    rng = np.random.RandomState(seed)
    d = tmp_path / "marco_tsv"
    d.mkdir()
    extra = ["Alpha", "BETA,", "Gamma.", "délta", "zeta!", "(eta)"]
    pool = WORDS + extra

    def text(n):
        return " ".join(rng.choice(pool, n))

    pids = rng.permutation(1000)[:n_docs] + 7
    with open(d / "collection.tsv", "w") as f:
        for pid in pids:
            f.write(f"{pid}\t{text(rng.randint(4, 30))}\n")
    for split, n, base in (("train", n_train, 100), ("dev", n_dev, 500)):
        qids = base + np.arange(n) * 3
        with open(d / f"queries.{split}.tsv", "w") as f:
            for q in qids:
                f.write(f"{q}\t{text(rng.randint(2, 6))}\n")
        with open(d / f"qrels.{split}.tsv", "w") as f:
            for q in qids:
                f.write(f"{q}\t0\t{rng.choice(pids)}\t1\n")
        if split == "dev":
            with open(d / "top1000.dev.tsv", "w") as f:
                for q in qids:
                    for pid in rng.choice(pids, 5, replace=False):
                        f.write(f"{q}\t{pid}\tq\tp\n")
    return d


def write_triples(tmp_path, n=40, seed=0):
    """query \\t positive \\t negative lines of random words."""
    rng = np.random.RandomState(seed)
    path = tmp_path / "triples.tsv"
    with open(path, "w") as f:
        for _ in range(n):
            f.write("\t".join(" ".join(rng.choice(WORDS, k))
                              for k in (3, 8, 8)) + "\n")
    return str(path)


def json_lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_fixture_files_parse(tmp_path):
    """The MS MARCO TSVs parse as preprocess-msmarco reads them (every
    qrels id in the collection and query files), the BEIR task has its
    qrels, the triples have three columns."""
    d = write_marco_tsv(tmp_path)
    pids = {int(ln.split("\t")[0]) for ln in open(d / "collection.tsv")}
    for split in ("train", "dev"):
        qids = {int(ln.split("\t")[0])
                for ln in open(d / f"queries.{split}.tsv")}
        for ln in open(d / f"qrels.{split}.tsv"):
            q, _, p, r = ln.split()
            assert int(q) in qids and int(p) in pids and r == "1"
    beir = write_beir(tmp_path, n_docs=20, name="b2", seed=1)
    assert len(open(os.path.join(beir, "corpus.jsonl")).readlines()) == 20
    assert all(len(ln.split("\t")) == 3
               for ln in open(write_triples(tmp_path)))
