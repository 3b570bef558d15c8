"""RoBERTa's byte-level BPE in the port (data/bpe.py, data/tokenizer.py)
against transformers.RobertaTokenizerFast and AutoTokenizer (what the JAX
CLI loads): a vocabulary trained in tmp_path by the installed tokenizers'
ByteLevelBPETokenizer on a corpus made from a seed, so nothing is
downloaded. The same ids and masks on every string, in both calling
forms; the collator's surface; the directory forms AutoTokenizer reads
(vocab.json + merges.txt, tokenizer.json with BPE or WordPiece, both
kinds of file in one directory); an unsupported component raises naming
itself. Equality is exact: tokenization has no tolerance."""
import json
import random

import numpy as np
import pytest

from cocodr_tpu_torch.data import bpe
from cocodr_tpu_torch.data.tokenizer import load_tokenizer

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
WORDS = ["hello", "world", "Hello", "WORLD", "don't", "DON'T", "it's",
         "IT'S", "we're", "WE'RE", "they've", "I'm", "I'M", "you'll",
         "YOU'LL", "he'd", "HE'D", "2024", "3.14", "1,000", "café", "naïve",
         "Zürich", "straße", "中国", "日本語", "한국어", "Ωμέγα", "ΟΔΟΣ",
         "½", "Ⅻ", "٣٤", "x²", "😀", "👍🏽", "é", "के", "running",
         "retrieval", "dense", "the", "a", "<tag>", "http://x.org/a?b=c"]
# contractions in both cases, digits, Unicode letters, numbers (Nd, Nl,
# No) and marks (Mn, Mc), whitespace runs of every White_Space kind and
# U+001C (whitespace to str.isspace only), newlines, controls, zero-width
# characters, emoji, the special tokens and <mask> beside spaces
ALPHABET = (WORDS + list("abcxyzABCXYZ0123456789'sStTrReEvVmMlLdD!?.,-_")
            + [" ", " ", "  ", "   ", "\t", "\n", "\n\n", "\r\n", "\x0b",
               "\x0c", "\x85", "\xa0", "\u2003", "\u2028", "\u202f",
               "\u3000", "\x1c", "\x00", "\x7f", "\u200b", "\u200d",
               "\ufeff", "\u0301", "\u0903", "\U0001f600", "\U0002b820",
               "'s", "'S", "'t", "'re", "'ve", "'m", "'ll", "'d", "'LL"]
            + SPECIALS + [" <mask>", "<mask> ", "  <mask>", "\n<mask>",
                          " <s> ", "<mask><mask>", "<ma", "sk>"])


def corpus(seed=0, n=400):
    rng = random.Random(seed)
    return [" ".join(rng.choice(WORDS) for _ in range(rng.randint(5, 25)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """vocab.json + merges.txt of a byte-level BPE trained on corpus()."""
    d = tmp_path_factory.mktemp("bpe")
    tok = tokenizers.ByteLevelBPETokenizer()
    tok.train_from_iterator(corpus(), vocab_size=700, min_frequency=2,
                            special_tokens=SPECIALS)
    tok.save_model(str(d))
    return d


def roberta(vocab_dir, **kw):
    return transformers.RobertaTokenizerFast(
        vocab_file=str(vocab_dir / "vocab.json"),
        merges_file=str(vocab_dir / "merges.txt"), **kw)


def random_strings(seed, n):
    rng = random.Random(seed)
    for _ in range(n):
        yield "".join(rng.choice(ALPHABET)
                      for _ in range(rng.randint(0, 24)))


def same_ids(ours, theirs, texts, **kw):
    for s in texts:
        assert ours.encode(s, **kw) == theirs.encode(s, **kw), (repr(s), kw)


def copy_dir(src, dst, names):
    dst.mkdir()
    for name in names:
        (dst / name).write_bytes((src / name).read_bytes())
    return dst


@pytest.mark.parametrize("add_prefix_space", [False, True])
def test_random_strings_match_roberta_tokenizer_fast(vocab_dir, tmp_path,
                                                     add_prefix_space):
    """add_prefix_space read from tokenizer_config.json (default false)."""
    d = copy_dir(vocab_dir, tmp_path / "ckpt", ["vocab.json", "merges.txt"])
    if add_prefix_space:
        (d / "tokenizer_config.json").write_text(
            json.dumps({"add_prefix_space": True}))
    ours = load_tokenizer(str(d))
    theirs = roberta(vocab_dir, add_prefix_space=add_prefix_space)
    texts = list(random_strings(int(add_prefix_space), 1500))
    same_ids(ours, theirs, texts, add_special_tokens=True, max_length=512,
             truncation=True)
    same_ids(ours, theirs, texts[:300], add_special_tokens=False)


@pytest.mark.parametrize("text", [
    " hello  <mask>x", "", " ", "   ", "\n\n", "a\n\n  b", "x  \t y",
    "don't DON'T Don't", "it's'S 's", "<s>hello</s><pad><unk>",
    "hello <s> world", "  <mask>  ", "a<mask> b", "<mask>", "<ma sk>",
    "hello world" * 40, "ΟΔΟΣ ΣΑΣ", "1,000.5 ½Ⅻ٣", "😀😀 👍🏽", "é́",
    "　x　 y", "\x1c\x1cz"])
def test_edge_cases_match(vocab_dir, text):
    """<mask> eating the spaces before it, special tokens in the text,
    blank text, whitespace runs before a word, case-sensitive
    contractions, long text truncated to 8 and to 512."""
    ours, theirs = load_tokenizer(str(vocab_dir)), roberta(vocab_dir)
    for kw in (dict(add_special_tokens=True, max_length=512,
                    truncation=True),
               dict(add_special_tokens=False),
               dict(add_special_tokens=True, max_length=8, truncation=True),
               dict(add_special_tokens=False, max_length=3,
                    truncation=True)):
        assert ours.encode(text, **kw) == theirs.encode(text, **kw), kw
    assert theirs.convert_ids_to_tokens(
        theirs.encode(" hello  <mask>x")) == [
            "<s>", "Ġhello", "<mask>", "x", "</s>"]


@pytest.mark.parametrize("max_length", [8, 32])
def test_batch_call_matches(vocab_dir, max_length):
    """The batch form serving and warmup call: input_ids and
    attention_mask equal, padded with <pad> to max_length, truncated."""
    ours, theirs = load_tokenizer(str(vocab_dir)), roberta(vocab_dir)
    texts = list(random_strings(7, 40)) + ["", "hello world " * 20]
    kw = dict(padding="max_length", truncation=True, max_length=max_length,
              return_tensors="np")
    want, got = theirs(texts, **kw), ours(texts, **kw)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == np.int64
        np.testing.assert_array_equal(got[key], want[key])


def test_collator_surface_equals_roberta_tokenizer_fast(vocab_dir):
    """vocab_size, the special ids and list (in transformers' order),
    num_special_tokens_to_add for one text (2) and a pair (4), and
    convert_ids_to_tokens over every id and one past the end."""
    ours, theirs = load_tokenizer(str(vocab_dir)), roberta(vocab_dir)
    for attr in ("vocab_size", "cls_token_id", "sep_token_id",
                 "pad_token_id", "mask_token_id", "all_special_tokens"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.all_special_tokens == ["<s>", "</s>", "<unk>", "<pad>",
                                       "<mask>"]
    assert [ours.num_special_tokens_to_add(p) for p in (False, True)] == [
        theirs.num_special_tokens_to_add(p) for p in (False, True)] == [2, 4]
    ids = list(range(len(theirs) + 1))
    assert ours.convert_ids_to_tokens(ids) == theirs.convert_ids_to_tokens(
        ids)
    assert ours.convert_ids_to_tokens(np.int64(5)) == \
        theirs.convert_ids_to_tokens(5)


def test_split_pattern_classes_match_the_fast_tokenizer():
    """The written-out \\p{L}, \\p{N} and \\s classes against tokenizers'
    ByteLevel pre-tokenizer on one character before a letter, a digit and
    a '!', over every assigned code point of the BMP's first 0x3000 and
    a sample above (Python's Unicode database and the fast tokenizer's
    differ only on characters Python does not assign yet)."""
    import unicodedata

    pre = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)
    ours = bpe.ByteLevel()
    cps = list(range(1, 0x3000)) + list(range(0x3000, 0x30000, 97))
    for cp in cps:
        ch = chr(cp)
        if 0xD800 <= cp <= 0xDFFF or unicodedata.category(ch) == "Cn":
            continue
        for text in (ch + "a", ch + "1", ch + "!", "a" + ch + ch + "b"):
            want = [p for p, _ in pre.pre_tokenize_str(text)]
            assert ours(text) == want, (hex(cp), text)


def test_bytes_to_unicode_is_gpt2s():
    table = bpe.bytes_to_unicode()
    assert len(set(table.values())) == 256
    assert table[ord(" ")] == "Ġ" and table[ord("\n")] == "Ċ"
    assert table[ord("a")] == "a" and table[0] == chr(256)


def save_json(tok, d, model_type=None, edit=None):
    """tok's backend as d/tokenizer.json (edit(spec) first), with a
    config.json of model_type when given."""
    d.mkdir()
    spec = json.loads(tok.backend_tokenizer.to_str())
    if edit:
        edit(spec)
    (d / "tokenizer.json").write_text(json.dumps(spec))
    if model_type:
        (d / "config.json").write_text(json.dumps({"model_type": model_type}))
    return d


def legacy_merges(spec):
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]


@pytest.mark.parametrize("edit", [None, legacy_merges],
                         ids=["pair_merges", "string_merges"])
def test_tokenizer_json_only_bpe_directory(vocab_dir, tmp_path, edit):
    """tokenizer.json alone (merges as [a, b] pairs or "a b" strings)
    against AutoTokenizer, which needs config.json's model_type beside
    it; the port takes RoBERTa's class from the BPE model."""
    ref = roberta(vocab_dir)
    ours = load_tokenizer(str(save_json(ref, tmp_path / "ours", edit=edit)))
    auto = transformers.AutoTokenizer.from_pretrained(
        str(save_json(ref, tmp_path / "auto", "roberta", edit)))
    assert type(auto).__name__ == "RobertaTokenizerFast"
    texts = list(random_strings(11, 800))
    same_ids(ours, auto, texts, max_length=64, truncation=True)
    for attr in ("vocab_size", "cls_token_id", "sep_token_id",
                 "pad_token_id", "mask_token_id", "all_special_tokens"):
        assert getattr(ours, attr) == getattr(auto, attr), attr


BERT_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
              + "the un ##aff ##able hello world ##s ##ing run cafe café "
                "οδος οδοσ σας σασ 中 国 ! , .".split())


@pytest.mark.parametrize("lower", [True, False])
def test_tokenizer_json_only_wordpiece_directory(tmp_path, lower):
    """BertTokenizerFast's tokenizer.json alone, cased and uncased (with
    the tokenizer_config.json save_pretrained writes) against
    AutoTokenizer on the same files and config.json; the Greek final
    sigma lowercased character by character, as the fast tokenizer
    does."""
    (tmp_path / "vocab.txt").write_text("\n".join(BERT_VOCAB))
    ref = transformers.BertTokenizerFast(
        vocab_file=str(tmp_path / "vocab.txt"), do_lower_case=lower)
    d = save_json(ref, tmp_path / "ours")
    cfg = json.dumps({"do_lower_case": lower})
    (d / "tokenizer_config.json").write_text(cfg)
    a = save_json(ref, tmp_path / "auto", "bert")
    (a / "tokenizer_config.json").write_text(cfg)
    ours = load_tokenizer(str(d))
    auto = transformers.AutoTokenizer.from_pretrained(str(a))
    texts = ["ΟΔΟΣ ΣΑΣ σας", "Hello, WORLD! unaffable Café", "中国run",
             "[MASK] [mask] [CLS]x", "", "x" * 101]
    texts += list(random_strings(5, 300))
    same_ids(ours, auto, texts, max_length=32, truncation=True)
    assert ours.convert_ids_to_tokens(list(range(len(BERT_VOCAB) + 1))) == \
        auto.convert_ids_to_tokens(list(range(len(BERT_VOCAB) + 1)))


def test_bert_class_sets_the_normalizer_from_its_config(tmp_path):
    """A cased tokenizer.json with config.json saying bert and no
    tokenizer_config.json: BertTokenizerFast's do_lower_case default
    (true) wins over the file, in AutoTokenizer and in the port."""
    (tmp_path / "vocab.txt").write_text("\n".join(BERT_VOCAB))
    ref = transformers.BertTokenizerFast(
        vocab_file=str(tmp_path / "vocab.txt"), do_lower_case=False)
    d = save_json(ref, tmp_path / "ckpt", "bert")
    ours = load_tokenizer(str(d))
    auto = transformers.AutoTokenizer.from_pretrained(str(d))
    same_ids(ours, auto, ["Hello WORLD Café", "ΟΔΟΣ"])
    assert ours.encode("Hello") == ours.encode("hello")


def test_added_tokens_flags_match_auto_tokenizer(vocab_dir, tmp_path):
    """Added tokens with rstrip, lstrip and normalized under a Lowercase
    normalizer, a token outside the model's vocabulary (its id the next
    free one whatever the file says), and RoBERTa's class re-making
    <mask> to eat the spaces before it where the file says not."""
    ref = roberta(vocab_dir)

    def edit(spec):
        spec["normalizer"] = {"type": "Lowercase"}
        spec["added_tokens"] += [
            dict(id=9000, content="zzq", single_word=False, lstrip=False,
                 rstrip=True, normalized=False, special=False),
            dict(id=9001, content="HeY", single_word=False, lstrip=True,
                 rstrip=False, normalized=True, special=False)]
        for tok in spec["added_tokens"]:
            if tok["content"] == "<mask>":
                tok["lstrip"] = False

    d = save_json(ref, tmp_path / "ckpt", "roberta", edit)
    ours = load_tokenizer(str(d))
    auto = transformers.AutoTokenizer.from_pretrained(str(d))
    texts = ["zzq   hello", "a  HEY b hey", "x <mask>", "ZZQ zzq\tzzq",
             "Hello  hEy<mask> zzq"] + list(random_strings(13, 400))
    same_ids(ours, auto, texts)
    assert ours.convert_ids_to_tokens(len(ref)) == "zzq" == \
        auto.convert_ids_to_tokens(len(ref))


def bert_processing(spec):
    spec["post_processor"] = {"type": "BertProcessing", "sep": ["</s>", 2],
                              "cls": ["<s>", 0]}


def template_processing(spec):
    s, a, b = ({"SpecialToken": {"id": "<s>", "type_id": 0}},
               {"Sequence": {"id": "A", "type_id": 0}},
               {"Sequence": {"id": "B", "type_id": 1}})
    e = {"SpecialToken": {"id": "</s>", "type_id": 0}}
    spec["post_processor"] = {
        "type": "TemplateProcessing", "single": [a, e],
        "pair": [s, a, e, e, b, e],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [0], "tokens": ["<s>"]},
                           "</s>": {"id": "</s>", "ids": [2],
                                    "tokens": ["</s>"]}}}


def no_regex(spec):
    spec["pre_tokenizer"]["use_regex"] = False


@pytest.mark.parametrize("edit", [bert_processing, template_processing,
                                  no_regex])
def test_bpe_component_variants_match_auto_tokenizer(vocab_dir, tmp_path,
                                                     edit):
    """BertProcessing (a pair 3), a TemplateProcessing with its special
    token after the text alone (a pair 5), ByteLevel without the split
    pattern: ids and num_special_tokens_to_add as AutoTokenizer's."""
    d = save_json(roberta(vocab_dir), tmp_path / "ckpt", "roberta", edit)
    ours = load_tokenizer(str(d))
    auto = transformers.AutoTokenizer.from_pretrained(str(d))
    same_ids(ours, auto, list(random_strings(19, 300)), max_length=16,
             truncation=True)
    for pair in (False, True):
        assert ours.num_special_tokens_to_add(pair) == \
            auto.num_special_tokens_to_add(pair)


def no_clean_text(spec):
    spec["normalizer"]["clean_text"] = False


def short_words(spec):
    spec["model"]["max_input_chars_per_word"] = 5


@pytest.mark.parametrize("edit", [no_clean_text, short_words])
def test_wordpiece_component_variants_match_auto_tokenizer(tmp_path, edit):
    """BertNormalizer without clean_text (controls kept, whitespace kept
    apart from the split) and WordPiece's max_input_chars_per_word."""
    (tmp_path / "vocab.txt").write_text("\n".join(BERT_VOCAB))
    ref = transformers.BertTokenizerFast(
        vocab_file=str(tmp_path / "vocab.txt"))
    d = save_json(ref, tmp_path / "ckpt", "bert", edit)
    ours = load_tokenizer(str(d))
    auto = transformers.AutoTokenizer.from_pretrained(str(d))
    same_ids(ours, auto, ["unaffable runs\x00x\x7f\ty", "hellos worlds"]
             + list(random_strings(23, 300)))


@pytest.mark.parametrize("options", [
    dict(unk_token="<unk>"), dict(unk_token="<unk>", fuse_unk=True),
    dict(), dict(ignore_merges=True)])
def test_bpe_model_options_match_tokenizers(options):
    """The BPE model alone against tokenizers' on words with characters
    outside the vocabulary: each one <unk>, a run of them one <unk>
    (fuse_unk), or dropped (no unk_token); ignore_merges takes a word
    found whole."""
    vocab = {c: i for i, c in enumerate(["<unk>", "a", "b", "c", "ab",
                                         "abc", "ca", "cab"])}
    merges = [("a", "b"), ("ab", "c"), ("c", "a")]
    theirs = tokenizers.Tokenizer(tokenizers.models.BPE(
        vocab, merges, **options))
    ours = bpe.BPE(vocab, merges, **options)
    for word in ("abc", "cab", "xxabyc", "axxb", "zz", "cabcab", "abab"):
        assert ours.tokenize(word) == theirs.encode(word).ids, word


def test_directory_with_both_forms_reads_tokenizer_json(vocab_dir, tmp_path):
    """vocab.json + merges.txt and a tokenizer.json that tokenizes
    otherwise (half of its merges cut) in one directory: the port and
    AutoTokenizer both read tokenizer.json; tokenizer_config.json's
    add_prefix_space applies to it."""
    ref = roberta(vocab_dir)

    def edit(spec):
        spec["model"]["merges"] = spec["model"]["merges"][:150]

    d = save_json(ref, tmp_path / "ckpt", "roberta", edit)
    for name in ("vocab.json", "merges.txt"):
        (d / name).write_bytes((vocab_dir / name).read_bytes())
    text = "hello world running retrieval"
    for cfg in ({}, {"add_prefix_space": True}):
        (d / "tokenizer_config.json").write_text(json.dumps(cfg))
        ours = load_tokenizer(str(d))
        auto = transformers.AutoTokenizer.from_pretrained(str(d))
        same_ids(ours, auto, [text] + list(random_strings(17, 200)))
    assert ours.encode(text) != ref.encode(text)
    assert ours.convert_ids_to_tokens(ours.encode("x"))[1] == "Ġ"


@pytest.mark.parametrize("part,change,name", [
    ("normalizer", {"type": "NFKC"}, "NFKC"),
    ("pre_tokenizer", {"type": "Whitespace"}, "Whitespace"),
    ("post_processor", {"type": "ByteLevel", "trim_offsets": True},
     "ByteLevel"),
    ("model", {"type": "Unigram", "vocab": []}, "Unigram"),
    ("model", {"dropout": 0.1}, "dropout"),
    ("model", {"byte_fallback": True}, "byte_fallback"),
    ("added", {"single_word": True}, "single_word"),
])
def test_unsupported_component_raises_naming_it(vocab_dir, tmp_path, part,
                                                change, name):
    def edit(spec):
        if part == "added":
            spec["added_tokens"][0].update(change)
        elif part == "model" and "type" not in change:
            spec["model"].update(change)
        else:
            spec[part] = change

    d = save_json(roberta(vocab_dir), tmp_path / "ckpt", edit=edit)
    with pytest.raises(ValueError, match=name):
        load_tokenizer(str(d))


def test_directory_without_a_tokenizer_raises(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        load_tokenizer(str(tmp_path))


def test_bpe_cache_and_merge_order(vocab_dir):
    """Merges by rank, the leftmost of equal ranks first ('aaa' with the
    one merge (a, a) gives 'aa' 'a'); a cached word gives the same ids;
    the cache stops growing at CACHE_WORDS."""
    model = bpe.BPE({"a": 0, "aa": 1, "b": 2, "ab": 3},
                    [("a", "a"), ("a", "b")])
    assert model.tokenize("aaa") == [1, 0]
    assert model.tokenize("aab") == [1, 2]
    assert model.tokenize("aab") == [1, 2]
    model._cache = dict.fromkeys(range(bpe.CACHE_WORDS))
    model.tokenize("ab")
    assert "ab" not in model._cache
    with pytest.raises(ValueError, match="not in the vocabulary"):
        bpe.BPE({"a": 0}, [("a", "a")])
