"""The port's CLI on a RoBERTa checkpoint, against the JAX CLI (which loads
the tokenizer through transformers.AutoTokenizer): a tiny
RobertaForMaskedLM (2 layers, H 32, LayerNorm eps 1e-5, positions from
pad id 1) saved with the byte-level BPE tokenizer that tokenizers'
ByteLevelBPETokenizer trains in tmp_path (tokenizer.json, vocab.json,
merges.txt, tokenizer_config.json). preprocess-beir writes the JAX CLI's
records byte for byte from the whole checkpoint directory, from its
vocab.json + merges.txt alone and from its tokenizer.json alone; encode's
.npy agrees with the JAX CLI's within 2e-5 (both float32 on the CPU, as
tests/test_torch_cli.py holds BERT's); a COCO collator batch under the
port's BPE tokenizer equals the JAX collator's under
RobertaTokenizerFast at the same seed."""
import json

import numpy as np
import pytest
import torch

from cocodr_tpu.cli import main as jax_main
from cocodr_tpu.data.coco_collator import CoCondenserCollator as JaxCollator
from cocodr_tpu_torch import cli
from cocodr_tpu_torch.data.coco_collator import CoCondenserCollator
from cocodr_tpu_torch.data.tokenizer import load_tokenizer

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
torch.set_num_threads(1)

CPU = ["--cpu-devices", "1"]
SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
WORDS = ("dense retrieval don't It's WE'RE they've café naïve Zürich 2024 "
         "3.14 ½ 中国 😀 zero-shot COCO-DR <mask> x² \t\n").split(" ")


def texts(rng, n, lo, hi):
    return [" ".join(rng.choice(WORDS, rng.randint(lo, hi)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def roberta_dirs(tmp_path_factory):
    """-> (checkpoint dir, vocab-files-only dir, tokenizer.json-only dir,
    BEIR task dir)."""
    root = tmp_path_factory.mktemp("roberta")
    rng = np.random.RandomState(0)
    bpe = tokenizers.ByteLevelBPETokenizer()
    bpe.train_from_iterator(texts(rng, 300, 3, 20), vocab_size=300,
                            special_tokens=SPECIALS)
    (root / "vocab").mkdir()
    bpe.save_model(str(root / "vocab"))
    tok = transformers.RobertaTokenizerFast(
        vocab_file=str(root / "vocab" / "vocab.json"),
        merges_file=str(root / "vocab" / "merges.txt"))
    ckpt = root / "ckpt"
    torch.manual_seed(0)
    cfg = transformers.RobertaConfig(
        vocab_size=len(tok), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=66, type_vocab_size=1, pad_token_id=1,
        layer_norm_eps=1e-5)
    transformers.RobertaForMaskedLM(cfg).save_pretrained(
        str(ckpt), safe_serialization=False)
    tok.save_pretrained(str(ckpt))
    files, only_json = root / "files", root / "json"
    files.mkdir()
    only_json.mkdir()
    for name in ("vocab.json", "merges.txt", "tokenizer_config.json"):
        (files / name).write_bytes((ckpt / name).read_bytes())
    (only_json / "tokenizer.json").write_bytes(
        (ckpt / "tokenizer.json").read_bytes())

    beir = root / "beir"
    (beir / "qrels").mkdir(parents=True)
    with open(beir / "corpus.jsonl", "w") as f:
        for i, text in enumerate(texts(rng, 12, 2, 14)):
            f.write(json.dumps({"_id": f"d{i}", "title": f"T{i} don't",
                                "text": text}) + "\n")
    with open(beir / "queries.jsonl", "w") as f:
        for j, text in enumerate(texts(rng, 5, 1, 6)):
            f.write(json.dumps({"_id": f"q{j}", "text": text}) + "\n")
    with open(beir / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        f.writelines(f"q{j}\td{2 * j}\t1\n" for j in range(5))
    return str(ckpt), str(files), str(only_json), str(beir)


def preprocess(main, tokenizer, data_dir, out):
    main(["preprocess-beir", "--data-dir", data_dir, "--out", out,
          "--tokenizer", tokenizer, "--task", "smoke", "--query-len", "8",
          "--doc-len", "12"])


@pytest.fixture(scope="module")
def jax_records(roberta_dirs, tmp_path_factory):
    ckpt, _, _, beir = roberta_dirs
    out = tmp_path_factory.mktemp("jrec") / "rec"
    preprocess(jax_main, ckpt, beir, str(out))
    return out


@pytest.mark.parametrize("form", ["checkpoint", "vocab_files",
                                  "tokenizer_json"])
def test_preprocess_beir_records_equal_the_jax_clis(roberta_dirs,
                                                    jax_records, tmp_path,
                                                    form):
    ckpt, files, only_json, beir = roberta_dirs
    tokenizer = {"checkpoint": ckpt, "vocab_files": files,
                 "tokenizer_json": only_json}[form]
    preprocess(cli.main, tokenizer, beir, str(tmp_path / "rec"))
    for name in ("passages", "passages_meta", "queries", "queries_meta",
                 "passages.docid2offset.pickle", "queries.qid2offset.pickle"):
        assert (tmp_path / "rec" / name).read_bytes() == (
            jax_records / name).read_bytes(), name


def test_encode_npy_matches_the_jax_cli(roberta_dirs, jax_records,
                                        tmp_path):
    """The port CLI's embeddings of the JAX CLI's records: within 2e-5 of
    the JAX CLI's, both float32 on the CPU."""
    ckpt = roberta_dirs[0]
    for main, out, extra in ((cli.main, "port.npy", CPU),
                             (jax_main, "jax.npy", ["--compile-cache", ""])):
        main(["encode", "--checkpoint", ckpt, "--records",
              str(jax_records / "passages"), "--out", str(tmp_path / out),
              "--batch-size", "4"] + extra)
    e, j = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert e.shape == (12, 32) and e.dtype == np.float32
    np.testing.assert_allclose(e, j, rtol=2e-5, atol=2e-5)


def test_coco_collator_batch_equals_the_jax_collators(roberta_dirs):
    """Span pairs tokenized by each side's tokenizer (equal ids), then
    CoCondenserCollator at the same seed: every BPE piece a whole word of
    its own in both, so input_ids, attention_mask and labels equal."""
    ckpt = roberta_dirs[0]
    ours = load_tokenizer(ckpt)
    theirs = transformers.AutoTokenizer.from_pretrained(ckpt)
    rng = np.random.RandomState(1)
    docs = []
    for _ in range(12):
        spans = texts(rng, rng.randint(1, 4), 3, 30)
        ids = [ours.encode(s, add_special_tokens=False) for s in spans]
        assert ids == [theirs.encode(s, add_special_tokens=False)
                       for s in spans]
        docs.append({"spans": ids})
    out = []
    for cls, tok in ((CoCondenserCollator, ours), (JaxCollator, theirs)):
        coll = cls(tok, mlm_probability=0.3, max_seq_length=16, seed=3)
        out.append([coll.collate_spans(docs[i:i + 4]) for i in (0, 4, 8)])
    for a, b in zip(*out):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert any((b["labels"] != -100).any() for b in out[0])
    assert out[0][0]["input_ids"][0][0] == ours.cls_token_id == 0


def test_chip_smokes_roberta_tokenizer_files_read_as_auto_tokenizer(
        tmp_path):
    """chip_smoke.py's RoBERTa-base tokenizer (50,265 entries, written
    without tokenizers for the card's machine): its vocab.json + merges.txt
    directory and its tokenizer.json-alone directory give
    AutoTokenizer's ids (config.json beside the files, as a checkpoint
    has it) on the cli phase's kind of text."""
    import faulthandler

    import chip_smoke

    faulthandler.cancel_dump_traceback_later()  # the script's own watchdog
    files, only_json = tmp_path / "files", tmp_path / "json"
    files.mkdir()
    only_json.mkdir()
    chip_smoke.write_roberta_tokenizer(str(files), str(only_json))
    (files / "config.json").write_text(json.dumps({"model_type": "roberta"}))
    auto = transformers.AutoTokenizer.from_pretrained(str(files))
    assert len(auto) == auto.vocab_size == 50_265
    ours = [load_tokenizer(str(d)) for d in (files, only_json)]
    rng = np.random.RandomState(2)
    texts = [" ".join(f"w{i}" for i in rng.randint(0, 30_000, 40))
             for _ in range(50)] + ["w1234 <mask> w5185", " w7\tw12\n"]
    for text in texts:
        want = auto.encode(text, max_length=256, truncation=True)
        for tok in ours:
            assert tok.encode(text, max_length=256, truncation=True) == want
    assert ours[0].mask_token_id == ours[1].mask_token_id == 50_264
