"""The port's WordPiece tokenizer (data/tokenizer.py) against
transformers.BertTokenizerFast (what AutoTokenizer gives the JAX CLI for
a BERT checkpoint directory) on a vocabulary written in tmp_path: the same
ids and masks on every string, in both calling forms, with lowercasing on
and off."""
import json
import random

import numpy as np
import pytest

from cocodr_tpu_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer

transformers = pytest.importorskip("transformers")

WORDS = ["the", "un", "##aff", "##able", "aff", "able", "caf", "##e",
         "cafe", "hello", "world", "##s", "##ing", "run", "naive", "##ve",
         "na", "##i", "x", "##x", "ab", "##c", "é", "ü", "ß", "ñ", "##ü",
         "中", "国", "Hello", "World", "Run", "É"]
PUNCT = list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~¡¿«»…–—‘’“”。、")
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + PUNCT
# letters, accents (precomposed and combining), CJK and Hangul, every kind
# of whitespace, control and format characters, NUL, U+FFFD, supplementary
# ideographs at the edges of the CJK ranges, an emoji
ALPHABET = (list("abcdefghijklmnopqrstuvwxyzABCXYZ0123") + PUNCT
            + list("éèêëÉÀüÜßñÑçØøåÅİıǅ") + list("中国日本語한국어")
            + ["\t", "\n", "\r", " ", "\x0b", "\x0c", "\x85", "\xa0",
               "\u2003", "\u3000", "\x00", "\ufffd", "\u200b", "\u200d",
               "\x1c", "\x1f", "\x7f", "\u0301", "\u0308", "\U00020001",
               "\U0002b820", "\U0002b920", "\U0001f600"])
SPECIALS = ["[MASK]", "[CLS]", "[SEP]", "[UNK]", "[PAD]", "[mask]"]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return d


def pair(vocab_dir, lower):
    ref = transformers.BertTokenizerFast(
        vocab_file=str(vocab_dir / "vocab.txt"), do_lower_case=lower)
    return ref, WordPieceTokenizer(VOCAB, lowercase=lower)


# ASCII text with every ASCII control character
ASCII = [c for c in ALPHABET if c.isascii()] + [chr(c) for c in range(32)]


def random_strings(seed, n, alphabet=ALPHABET):
    rng = random.Random(seed)
    words = [w for w in WORDS if all(c in alphabet for c in w.lstrip("#"))]
    for _ in range(n):
        parts = []
        for _ in range(rng.randint(0, 30)):
            r = rng.random()
            if r < 0.3:
                parts.append(rng.choice(words).lstrip("#"))
            elif r < 0.35:
                parts.append(rng.choice(SPECIALS))
            else:
                parts.append(rng.choice(alphabet))
        yield "".join(parts)


@pytest.mark.parametrize("ascii_only", [False, True])
@pytest.mark.parametrize("lower", [True, False])
def test_random_strings_match_bert_tokenizer_fast(vocab_dir, lower,
                                                  ascii_only):
    ref, tok = pair(vocab_dir, lower)
    alphabet = ASCII if ascii_only else ALPHABET
    for s in random_strings(int(lower), 1500, alphabet):
        assert s.isascii() or not ascii_only
        want = ref.encode(s, add_special_tokens=True, max_length=512,
                          truncation=True)
        assert tok.encode(s, add_special_tokens=True, max_length=512,
                          truncation=True) == want, repr(s)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("text", [
    "a" * 100, "a" * 101, "x" * 100 + " hello", "hello " + "é" * 101,
    "unaffable unknownword cafés", "Hello WORLD run!", "naïve café",
    "", "   \t\n ", "[MASK]hello[SEP][UNK]", "foo[mask]bar [CLS]",
    "中国hello国", "É é é", "x" * 99 + "é"])
def test_edge_cases_match(vocab_dir, lower, text):
    """Words of 100 characters and over 100 ([UNK]), unknown words and
    pieces, case and accents, empty and blank text, special tokens in the
    text, CJK next to letters."""
    ref, tok = pair(vocab_dir, lower)
    for kw in (dict(add_special_tokens=True, max_length=512,
                    truncation=True),
               dict(add_special_tokens=False),
               dict(add_special_tokens=True, max_length=4, truncation=True)):
        assert tok.encode(text, **kw) == ref.encode(text, **kw), kw


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("max_length", [8, 32])
def test_batch_call_matches(vocab_dir, lower, max_length):
    """The batch form the serving path calls: input_ids and attention_mask
    equal, padded to max_length, truncated."""
    ref, tok = pair(vocab_dir, lower)
    texts = list(random_strings(7, 40)) + ["", "hello world" * 20]
    kw = dict(padding="max_length", truncation=True, max_length=max_length,
              return_tensors="np")
    want, got = ref(texts, **kw), tok(texts, **kw)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == np.int64
        np.testing.assert_array_equal(got[key], want[key])


def test_from_pretrained_reads_do_lower_case(vocab_dir, tmp_path):
    """A checkpoint directory: vocab.txt, and do_lower_case (default True)
    from tokenizer_config.json, as AutoTokenizer reads them."""
    text = "Hello WORLD É naïve"
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "vocab.txt").write_text((vocab_dir / "vocab.txt").read_text())
    assert load_tokenizer(str(d)).encode(text) == pair(
        vocab_dir, True)[0].encode(text)
    (d / "tokenizer_config.json").write_text(
        json.dumps({"do_lower_case": False}))
    cased = transformers.BertTokenizerFast(
        vocab_file=str(d / "vocab.txt"), do_lower_case=False)
    assert load_tokenizer(str(d)).encode(text) == cased.encode(text)
    assert load_tokenizer(str(d / "vocab.txt")).lowercase


def test_saved_tokenizer_directory_matches_auto_tokenizer(vocab_dir,
                                                          tmp_path):
    """A directory written by save_pretrained (tokenizer.json,
    tokenizer_config.json, vocab.txt): the port reads vocab.txt and the
    config and gives AutoTokenizer's ids."""
    ref = transformers.BertTokenizerFast(
        vocab_file=str(vocab_dir / "vocab.txt"), do_lower_case=True)
    ref.save_pretrained(str(tmp_path))
    auto = transformers.AutoTokenizer.from_pretrained(str(tmp_path))
    tok = load_tokenizer(str(tmp_path))
    for s in random_strings(3, 200):
        assert tok.encode(s, max_length=64, truncation=True) == auto.encode(
            s, max_length=64, truncation=True), repr(s)


def test_byte_level_bpe_directory_is_not_ported(tmp_path):
    """An old name: RoBERTa's vocab.json + merges.txt (no vocab.txt), once
    refused, now loads (ROADMAP.md item 15) and gives
    RobertaTokenizerFast's ids; tests/test_torch_bpe.py holds the rest."""
    tokenizers = pytest.importorskip("tokenizers")
    bpe = tokenizers.ByteLevelBPETokenizer()
    texts = list(random_strings(4, 200, ASCII))
    bpe.train_from_iterator(texts, vocab_size=400, special_tokens=[
        "<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    bpe.save_model(str(tmp_path))
    ref = transformers.RobertaTokenizerFast(
        vocab_file=str(tmp_path / "vocab.json"),
        merges_file=str(tmp_path / "merges.txt"))
    tok = load_tokenizer(str(tmp_path))
    for s in texts + ["hello <mask> world", " don't"]:
        assert tok.encode(s, max_length=64, truncation=True) == ref.encode(
            s, max_length=64, truncation=True), repr(s)


@pytest.mark.parametrize("strip", [None, False])
def test_final_sigma_is_lowercased_character_by_character(tmp_path, strip):
    """The fast tokenizer lowercases each character on its own, so a
    word-final capital sigma becomes σ, not the ς of str.lower."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "οδοσ", "οδος",
             "σας", "σασ"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    ref = transformers.BertTokenizerFast(
        vocab_file=str(tmp_path / "vocab.txt"), strip_accents=strip)
    tok = WordPieceTokenizer(vocab, strip_accents=strip)
    for text in ("ΟΔΟΣ ΣΑΣ", "οδος σας", "ΟΔΟΣ."):
        assert tok.encode(text) == ref.encode(text), text
    assert tok.encode("ΟΔΟΣ") == [2, 5, 3]


def test_vocabulary_without_special_tokens_is_refused():
    with pytest.raises(ValueError, match="lacks"):
        WordPieceTokenizer(["hello", "world"])
