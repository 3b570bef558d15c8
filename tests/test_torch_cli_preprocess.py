"""The port CLI's preprocessing subcommands and the tokenizer surface they
and the COCO collator read, against the JAX CLI and BertTokenizerFast from
the same vocab.txt: preprocess-msmarco and preprocess-coco write the JAX
CLI's files byte for byte; WordPieceTokenizer's vocab_size, special token
ids and lists, num_special_tokens_to_add and convert_ids_to_tokens equal
BertTokenizerFast's; the collator and the span writer give the same arrays
and files with either tokenizer at the same seed."""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from cocodr_tpu.cli import main as jax_main
from cocodr_tpu_torch import cli
from cocodr_tpu_torch.data.coco_collator import CoCondenserCollator
from cocodr_tpu_torch.data.coco_spans import preprocess_corpus_to_spans
from cocodr_tpu_torch.data.records import load_id_map
from cocodr_tpu_torch.data.tokenizer import load_tokenizer
from test_torch_cli_fixtures import (  # noqa: F401
    VOCAB,
    hf_checkpoint,
    write_beir,
    write_marco_tsv,
)

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """(port, BertTokenizerFast) over one vocab.txt with a token listed
    twice and a continuation piece."""
    d = tmp_path_factory.mktemp("vocab")
    vocab = VOCAB + ["##s", "##ing", "alpha", "run"]
    (d / "vocab.txt").write_text("\n".join(vocab))
    return (load_tokenizer(str(d)),
            transformers.BertTokenizerFast(vocab_file=str(d / "vocab.txt")))


@pytest.mark.parametrize("attr", ["vocab_size", "cls_token_id",
                                  "sep_token_id", "mask_token_id",
                                  "pad_token_id", "all_special_tokens"])
def test_tokenizer_surface_equals_bert_tokenizer_fast(tokenizers, attr):
    ours, theirs = tokenizers
    assert getattr(ours, attr) == getattr(theirs, attr)


def test_special_counts_and_ids_to_tokens_equal_bert_tokenizer_fast(
        tokenizers):
    """num_special_tokens_to_add for one text and a pair; every id of the
    vocabulary, one id alone, and the id of a duplicated token's first
    line (no token keeps it: None)."""
    ours, theirs = tokenizers
    for pair in (False, True):
        assert ours.num_special_tokens_to_add(pair) == \
            theirs.num_special_tokens_to_add(pair)
    ids = list(range(len(VOCAB) + 4))
    assert ours.convert_ids_to_tokens(ids) == \
        theirs.convert_ids_to_tokens(ids)
    assert ours.convert_ids_to_tokens(np.int64(7)) == \
        theirs.convert_ids_to_tokens(7)
    first_alpha = VOCAB.index("alpha")
    assert ours.convert_ids_to_tokens(first_alpha) is None
    assert theirs.convert_ids_to_tokens(first_alpha) is None


def test_coco_collator_arrays_equal_with_either_tokenizer(tokenizers):
    """CoCondenserCollator over span pairs (one-span documents among them,
    spans long enough to be truncated) at the same seed: the same
    input_ids, attention_mask and labels."""
    ours, theirs = tokenizers
    rng = np.random.RandomState(0)
    ids = sorted(ours.vocab.values())[5:]  # words and pieces
    docs = [{"spans": [[int(i) for i in rng.choice(ids, rng.randint(3, 30))]
                       for _ in range(rng.randint(1, 4))]}
            for _ in range(12)]
    out = []
    for tok in (ours, theirs):
        coll = CoCondenserCollator(tok, mlm_probability=0.3,
                                   max_seq_length=16, seed=3)
        out.append([coll.collate_spans(docs[i:i + 4]) for i in (0, 4, 8)])
    for a, b in zip(*out):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert any((b["labels"] != -100).any() for b in out[0])


def test_span_files_equal_with_either_tokenizer(tokenizers, tmp_path):
    ours, theirs = tokenizers
    beir = write_beir(tmp_path, n_docs=30, seed=2)
    paths = []
    for name, tok in (("ours", ours), ("theirs", theirs)):
        paths.append(str(tmp_path / f"{name}.jsonl"))
        n = preprocess_corpus_to_spans(os.path.join(beir, "corpus.jsonl"),
                                       paths[-1], tok, target_len=6)
        assert n == 30
    assert filecmp.cmp(*paths, shallow=False)


def _marco_argv(d, out, ckpt, model_type, workers):
    return ["preprocess-msmarco", "--collection", str(d / "collection.tsv"),
            "--train-queries", str(d / "queries.train.tsv"),
            "--train-qrels", str(d / "qrels.train.tsv"),
            "--dev-queries", str(d / "queries.dev.tsv"),
            "--dev-qrels", str(d / "qrels.dev.tsv"),
            "--out", str(out), "--tokenizer", ckpt,
            "--model-type", model_type, "--max-seq-length", "16",
            "--max-query-length", "8", "--n-workers", str(workers)]


@pytest.mark.parametrize("model_type", ["rdot_nll_condenser", "rdot_nll"])
def test_preprocess_msmarco_writes_the_jax_clis_bytes(hf_checkpoint,
                                                      tmp_path, model_type,
                                                      capsys):
    """Records, id maps and offset-space qrels byte for byte: a condenser
    model type lowercases (accents and capitals in the collection), the
    other does not; the port with --n-workers 2 writes what the JAX CLI
    writes with 1."""
    d = write_marco_tsv(tmp_path)
    jax_main(_marco_argv(d, tmp_path / "jax", hf_checkpoint, model_type, 1))
    cli.main(_marco_argv(d, tmp_path / "port", hf_checkpoint, model_type, 2))
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"wrote records to {tmp_path / 'port'}"
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert {"passages", "train-query", "dev-query", "train-qrel.tsv",
            "dev-qrel.tsv", "passages.pid2offset.pickle"} <= set(names)
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".pickle"):
            assert load_id_map(str(a)) == load_id_map(str(b)), name
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_preprocess_coco_writes_the_jax_clis_span_files(hf_checkpoint,
                                                        tmp_path, capsys):
    """Two task directories: each task's span file byte for byte, and the
    JAX CLI's report line per task (the port adds its seconds and
    docs/s)."""
    dirs = [write_beir(tmp_path, n_docs=25, name=n, seed=s)
            for n, s in (("scifact", 4), ("fiqa", 5))]
    outs = []
    for main, sub in ((jax_main, "jax"), (cli.main, "port")):
        main(["preprocess-coco", "--data-dirs", *dirs, "--out",
              str(tmp_path / sub), "--tokenizer", hf_checkpoint,
              "--target-len", "7"])
        outs.append(capsys.readouterr().out.splitlines())
    for task in ("scifact", "fiqa"):
        name = f"{task}.spans.jsonl"
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()
        spans = [json.loads(ln)["spans"]
                 for ln in open(tmp_path / "port" / name)]
        assert len(spans) == 25 and all(spans)
    for j, p in zip(*outs):
        assert p.startswith(j.replace(str(tmp_path / "jax"),
                                      str(tmp_path / "port")) + " (")
