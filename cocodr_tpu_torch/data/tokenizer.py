"""Tokenizers read from a checkpoint directory, as
`transformers.AutoTokenizer` reads them for the JAX CLI, without importing
transformers or tokenizers: BERT's WordPiece and RoBERTa's byte-level BPE
(data/bpe.py). COCO-DR's published checkpoints are BERT-base uncased.

`load_tokenizer(path)` takes the form AutoTokenizer's fast tokenizer takes:
`tokenizer.json` when the directory has one, else `vocab.json` +
`merges.txt` (RoBERTa's BPE), else `vocab.txt` (BERT's WordPiece); with
`tokenizer_config.json` and, for the tokenizer's class, `config.json`'s
model_type beside them.

Every form runs the fast tokenizer's pipeline (`Tokenizer`):
  1. added tokens (the special tokens and any others) are cut out of the
     raw text first and never split: the longest at the leftmost place,
     with lstrip / rstrip eating the whitespace beside one (RoBERTa's
     <mask> eats the spaces before it); a token marked `normalized` is
     matched in the normalized text instead;
  2. normalization: none (RoBERTa), Lowercase, or BertNormalizer: control
     characters, NUL and U+FFFD dropped, whitespace mapped to a space,
     spaces put around CJK ideographs, then, with lowercasing (BERT's
     default), accents stripped (NFD, combining marks of category Mn
     dropped) and each character lowercased on its own (no final-sigma
     rule);
  3. pre-tokenization: BertPreTokenizer (split on whitespace, every
     punctuation character, ASCII or a Unicode P* category, a word of its
     own), or ByteLevel (data/bpe.py: GPT-2's split pattern, bytes mapped
     to symbols);
  4. the model: WordPiece (greedy longest match from the left,
     continuations prefixed with '##'; a word longer than 100 characters,
     or one with a piece outside the vocabulary, becomes [UNK]) or BPE
     (data/bpe.py);
  5. the post-processor's special tokens around the text: [CLS] a [SEP]
     for BERT, <s> a </s> for RoBERTa (<s> a </s></s> b </s> for a pair).

`encode` and `__call__` are the two HuggingFace calling forms the port uses
(data/preprocess.py, data/coco_spans.py, pipelines/serve.py and
pipelines/warmup.py); `vocab_size`, `all_special_tokens`, the
`*_token_id`s, `num_special_tokens_to_add` and `convert_ids_to_tokens` are
the surface the COCO collator reads (data/coco_collator.py), with
BertTokenizerFast's and RobertaTokenizerFast's values.

What transformers' tokenizer classes change in a loaded tokenizer.json is
changed here too: the class is tokenizer_config.json's tokenizer_class,
else config.json's model_type (bert and dpr read as BERT's, roberta as
RoBERTa's), else, with neither file, the one its model implies (WordPiece
BERT's, BPE RoBERTa's, where AutoTokenizer refuses the directory). BERT's
class sets BertNormalizer's lowercase, strip_accents and
handle_chinese_chars from do_lower_case (default true), strip_accents and
tokenize_chinese_chars; RoBERTa's makes <mask> eat the spaces before it;
every class sets ByteLevel's add_prefix_space from tokenizer_config.json
(default false). A component of another type raises ValueError naming it;
the decoder is not read, since nothing here decodes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# transformers' special-token attributes, in the order of its
# all_special_tokens
SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")
BERT_SPECIALS = dict(unk_token="[UNK]", sep_token="[SEP]",
                     pad_token="[PAD]", cls_token="[CLS]",
                     mask_token="[MASK]")
ROBERTA_SPECIALS = dict(bos_token="<s>", eos_token="</s>",
                        unk_token="<unk>", sep_token="</s>",
                        pad_token="<pad>", cls_token="<s>",
                        mask_token="<mask>")
MAX_WORD_CHARS = 100

# Unicode's White_Space property (Rust's char::is_whitespace), which
# Python's str.isspace widens with U+001C..U+001F; those four count as
# control characters here
WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
    "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")


def _is_control(ch: str) -> bool:
    """Category C* (Cc, Cf, Cs, Co, Cn), tab, newline and CR excluded."""
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class _CharMap(dict):
    """A str.translate table over every code point: each one's
    replacement is rule(character), worked out the first time the
    character is seen and kept, so that a text is mapped at C speed."""

    def __init__(self, rule):
        super().__init__()
        self.rule = rule

    def __missing__(self, cp: int) -> Optional[str]:
        out = self[cp] = self.rule(chr(cp))
        return out


# combining marks dropped after NFD (accent stripping)
_MARKS = _CharMap(lambda ch: None if unicodedata.category(ch) == "Mn"
                  else ch)
# each character lowercased alone, as Rust's char::to_lowercase does
_LOWER = _CharMap(str.lower)
# whitespace made one space, punctuation made a word of its own
_SPLITS = _CharMap(lambda ch: " " if ch in WHITE_SPACE
                   else f" {ch} " if _is_punctuation(ch) else ch)


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class BertNormalizer:
    """tokenizers' BertNormalizer; strip_accents None follows lowercase."""

    def __init__(self, clean_text: bool = True,
                 handle_chinese_chars: bool = True,
                 strip_accents: Optional[bool] = None,
                 lowercase: bool = True):
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.strip_accents = (lowercase if strip_accents is None
                              else strip_accents)
        self.lowercase = lowercase
        self._clean = _CharMap(self._clean_char)

    def _clean_char(self, ch: str) -> Optional[str]:
        """NUL, U+FFFD and control characters dropped, whitespace made a
        space (with clean_text), CJK ideographs spaced apart."""
        cp = ord(ch)
        if self.clean_text:
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                return None
            if ch in WHITE_SPACE:
                return " "
        if self.handle_chinese_chars and _is_cjk(cp):
            return f" {ch} "
        return ch

    def __call__(self, text: str) -> str:
        text = text.translate(self._clean)
        if self.strip_accents:
            text = unicodedata.normalize("NFD", text).translate(_MARKS)
        if self.lowercase:
            text = text.translate(_LOWER)
        return text


def lowercase(text: str) -> str:
    """tokenizers' Lowercase normalizer."""
    return text.translate(_LOWER)


def bert_pre_tokenize(text: str) -> List[str]:
    """tokenizers' BertPreTokenizer."""
    return [w for w in text.translate(_SPLITS).split(" ") if w]


class WordPiece:
    """The WordPiece model over a vocabulary (token -> id)."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##",
                 max_input_chars_per_word: int = MAX_WORD_CHARS):
        if unk_token not in vocab:
            raise ValueError(f"unk_token {unk_token!r} is not in the "
                             "vocabulary")
        self.vocab = vocab
        self.unk_id = vocab[unk_token]
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word

    def tokenize(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                if sub in self.vocab:
                    piece = self.vocab[sub]
                    break
                end -= 1
            if piece is None:
                return [self.unk_id]
            ids.append(piece)
            start = end
        return ids


@dataclasses.dataclass(frozen=True)
class AddedToken:
    """A token cut out of the text before the model sees it."""
    content: str
    id: int
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = False
    special: bool = True


@dataclasses.dataclass(frozen=True)
class Template:
    """The post-processor: special ids before and after a text, and the
    number a pair of texts takes."""
    prefix: Tuple[int, ...] = ()
    suffix: Tuple[int, ...] = ()
    pair_count: int = 0


class _Matcher:
    """Splits a text at added tokens as tokenizers' AddedVocabulary does:
    the leftmost match, the longest there; lstrip moves a match's start
    back over whitespace (not past the previous match), rstrip its end
    forward."""

    def __init__(self, patterns: Dict[str, AddedToken]):
        self.tokens = patterns
        self.regex = (re.compile("|".join(
            re.escape(p) for p in sorted(patterns, key=len, reverse=True)))
            if patterns else None)

    def split(self, text: str) -> List[Tuple[Optional[AddedToken], str]]:
        if not text:
            return []
        if self.regex is None:
            return [(None, text)]
        out, offset = [], 0
        for m in self.regex.finditer(text):
            tok = self.tokens[m.group()]
            start, stop = m.span()
            if tok.lstrip:
                while start > offset and text[start - 1] in WHITE_SPACE:
                    start -= 1
            if tok.rstrip:
                while stop < len(text) and text[stop] in WHITE_SPACE:
                    stop += 1
            if offset < start:
                out.append((None, text[offset:start]))
            out.append((tok, text[start:stop]))
            offset = stop
        if offset < len(text):
            out.append((None, text[offset:]))
        return out


class Tokenizer:
    """The fast tokenizer's pipeline and the part of transformers' surface
    the port calls. model: WordPiece or bpe.BPE (`.vocab`, `.tokenize`);
    normalizer and pre_tokenizer: callables or None; special_tokens:
    transformers' attribute -> token (bos_token .. mask_token, and
    additional_special_tokens a list)."""

    def __init__(self, model, normalizer=None, pre_tokenizer=None,
                 post_processor: Template = Template(),
                 added_tokens: Sequence[AddedToken] = (),
                 special_tokens: Optional[dict] = None):
        self.model = model
        self.normalizer = normalizer
        self.pre_tokenizer = pre_tokenizer
        self.post_processor = post_processor
        self.added_tokens = list(added_tokens)
        self.special_tokens = dict(special_tokens or {})
        self._token_to_id = dict(model.vocab)
        self._id_to_token = {i: t for t, i in model.vocab.items()}
        for tok in self.added_tokens:
            self._token_to_id[tok.content] = tok.id
            self._id_to_token[tok.id] = tok.content
        self._raw = _Matcher({t.content: t for t in self.added_tokens
                              if not t.normalized})
        self._normalized = _Matcher({
            normalizer(t.content) if normalizer else t.content: t
            for t in self.added_tokens if t.normalized})

    # transformers' names for the collator (data/coco_collator.py)
    @property
    def vocab(self) -> Dict[str, int]:
        return self.model.vocab

    @property
    def vocab_size(self) -> int:
        """The model's vocabulary, added tokens outside it not counted."""
        return len(self.model.vocab)

    def token_to_id(self, token: Optional[str]) -> Optional[int]:
        """None for None; the unknown token's id for a token not known."""
        if token is None:
            return None
        found = self._token_to_id.get(token)
        if found is None and token != self.special_tokens.get("unk_token"):
            return self.token_to_id(self.special_tokens.get("unk_token"))
        return found

    @property
    def cls_token_id(self) -> Optional[int]:
        return self.token_to_id(self.special_tokens.get("cls_token"))

    @property
    def sep_token_id(self) -> Optional[int]:
        return self.token_to_id(self.special_tokens.get("sep_token"))

    @property
    def pad_token_id(self) -> Optional[int]:
        return self.token_to_id(self.special_tokens.get("pad_token"))

    @property
    def mask_token_id(self) -> Optional[int]:
        return self.token_to_id(self.special_tokens.get("mask_token"))

    @property
    def all_special_tokens(self) -> List[str]:
        """In transformers' order: bos, eos, unk, sep, pad, cls, mask,
        then the additional ones, each once."""
        out = [self.special_tokens.get(a) for a in SPECIAL_ATTRS]
        out += self.special_tokens.get("additional_special_tokens") or []
        return list(dict.fromkeys(t for t in out if t is not None))

    def num_special_tokens_to_add(self, pair: bool = False) -> int:
        post = self.post_processor
        return post.pair_count if pair else len(post.prefix) + len(
            post.suffix)

    def convert_ids_to_tokens(self, ids):
        """An id -> its token, a list of ids -> a list (None for an id
        that no token keeps)."""
        if isinstance(ids, (int, np.integer)):
            return self._id_to_token.get(int(ids))
        return [self._id_to_token.get(int(i)) for i in ids]

    def tokenize_ids(self, text: str) -> List[int]:
        """Token ids of text, without the post-processor's tokens."""
        ids = []
        for tok, seg in self._raw.split(text):
            if tok is not None:
                ids.append(tok.id)
                continue
            if self.normalizer is not None:
                seg = self.normalizer(seg)
            for tok, sub in self._normalized.split(seg):
                if tok is not None:
                    ids.append(tok.id)
                    continue
                words = (self.pre_tokenizer(sub) if self.pre_tokenizer
                         else [sub])
                for word in words:
                    ids.extend(self.model.tokenize(word))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None,
               truncation: bool = False) -> List[int]:
        ids = self.tokenize_ids(text)
        post = self.post_processor
        extra = self.num_special_tokens_to_add() if add_special_tokens else 0
        if truncation and max_length is not None:
            ids = ids[:max(max_length - extra, 0)]
        if add_special_tokens:
            ids = [*post.prefix, *ids, *post.suffix]
        return ids

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length: int = 512, return_tensors="np"):
        """Batch form: -> {"input_ids", "attention_mask"} int64 arrays
        [len(texts), max_length], padded with the pad token to
        max_length."""
        if padding != "max_length" or return_tensors != "np":
            raise ValueError("only padding='max_length' and "
                             "return_tensors='np' are supported")
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for r, text in enumerate(texts):
            toks = self.encode(text, max_length=max_length,
                               truncation=truncation)
            if len(toks) > max_length:
                raise ValueError(f"{len(toks)} tokens exceed max_length "
                                 f"{max_length}; pass truncation=True")
            ids[r, :len(toks)] = toks
            mask[r, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class WordPieceTokenizer(Tokenizer):
    """BERT WordPiece over a vocabulary list (line i of vocab.txt has id
    i; a token listed twice takes its last line, as in transformers).
    lowercase: BertTokenizerFast's do_lower_case; strip_accents None
    follows lowercase; chinese_chars: its tokenize_chinese_chars. The
    special tokens present in the vocabulary are its added tokens."""

    def __init__(self, vocab: Sequence[str], lowercase: bool = True,
                 strip_accents: Optional[bool] = None,
                 chinese_chars: bool = True):
        ids = {tok: i for i, tok in enumerate(vocab)}
        missing = [t for t in ("[UNK]", "[CLS]", "[SEP]", "[PAD]")
                   if t not in ids]
        if missing:
            raise ValueError(f"vocabulary lacks {missing}")
        self.lowercase = lowercase
        super().__init__(
            WordPiece(ids),
            BertNormalizer(handle_chinese_chars=chinese_chars,
                           strip_accents=strip_accents, lowercase=lowercase),
            bert_pre_tokenize,
            Template((ids["[CLS]"],), (ids["[SEP]"],), 3),
            [AddedToken(t, ids[t]) for t in BERT_SPECIALS.values()
             if t in ids],
            BERT_SPECIALS)

    @classmethod
    def from_pretrained(cls, path: str) -> "WordPieceTokenizer":
        """A checkpoint directory with vocab.txt (and optionally
        tokenizer_config.json), or a vocab.txt path."""
        vocab_path, cfg = path, {}
        if os.path.isdir(path):
            vocab_path = os.path.join(path, "vocab.txt")
            cfg = _read_json(os.path.join(path, "tokenizer_config.json"))
        with open(vocab_path, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        return cls(vocab, lowercase=cfg.get("do_lower_case", True),
                   strip_accents=cfg.get("strip_accents"),
                   chinese_chars=cfg.get("tokenize_chinese_chars", True))


# ---------------------------------------------------------------------------
# Loading a directory as AutoTokenizer does


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _content(value) -> Optional[str]:
    """A special token as tokenizer_config.json writes it: a string or an
    AddedToken's dict."""
    return value["content"] if isinstance(value, dict) else value


def _added(value: dict, special: bool) -> dict:
    """AddedToken fields from a dict of tokenizer.json or
    tokenizer_config.json."""
    if value.get("single_word"):
        raise ValueError(f"added token {value['content']!r}: single_word "
                         "is not supported")
    return dict(content=value["content"], lstrip=bool(value.get("lstrip")),
                rstrip=bool(value.get("rstrip")),
                normalized=bool(value.get("normalized", not special)),
                special=bool(value.get("special", special)))


class _AddedVocabulary:
    """Added tokens in order of addition; a token added again by its
    content takes the new flags and keeps its id. A new token's id is its
    id in the model's vocabulary, else the next free one (tokenizers'
    rule, which ignores the id a file gives it)."""

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab
        self.tokens: Dict[str, AddedToken] = {}

    def add(self, fields: dict):
        content = fields["content"]
        if not content:
            return
        old = self.tokens.get(content)
        if old is not None:
            tid = old.id
        elif content in self.vocab:
            tid = self.vocab[content]
        else:
            n = len(self.vocab)
            top = max((t.id for t in self.tokens.values()), default=None)
            tid = n if top is None or (top < n and n) else top + 1
        self.tokens[content] = AddedToken(id=tid, **fields)


def _special_tokens(kind: Optional[str], cfg: dict) -> dict:
    """transformers' special-token attributes: the class's defaults,
    tokenizer_config.json's values over them."""
    out = dict(BERT_SPECIALS if kind == "bert" else
               ROBERTA_SPECIALS if kind == "roberta" else {})
    for attr in SPECIAL_ATTRS:
        if attr in cfg:
            out[attr] = _content(cfg[attr])
    if cfg.get("additional_special_tokens"):
        out["additional_special_tokens"] = [
            _content(t) for t in cfg["additional_special_tokens"]]
    return out


def _add_config_tokens(added: _AddedVocabulary, kind: Optional[str],
                       cfg: dict, specials: dict):
    """What transformers' fast tokenizer adds at load: the entries of
    tokenizer_config.json's added_tokens_decoder, then each special token
    that is not added yet; one given as an AddedToken (a dict in the
    config, or RoBERTa's mask token, which eats the spaces before it) is
    added again with its flags."""
    for _, value in sorted(cfg.get("added_tokens_decoder", {}).items(),
                           key=lambda kv: int(kv[0])):
        added.add(_added(value, special=bool(value.get("special"))))
    present = set(added.tokens)
    tokens = [(attr, cfg.get(attr, specials.get(attr)))
              for attr in SPECIAL_ATTRS]
    tokens += [(None, t) for t in cfg.get("additional_special_tokens") or []]
    for attr, value in tokens:
        if isinstance(value, dict):
            added.add(_added(value, special=True))
        elif kind == "roberta" and attr == "mask_token":
            added.add(dict(content=value, lstrip=True, rstrip=False,
                           normalized=False, special=True))
        elif value is not None and value not in present:
            added.add(dict(content=value, lstrip=False, rstrip=False,
                           normalized=False, special=True))


def _kind(cfg: dict, model_cfg: dict, model) -> Optional[str]:
    """The tokenizer class AutoTokenizer picks: 'bert', 'roberta', or None
    for another (PreTrainedTokenizerFast's rules: special tokens from the
    config alone); with neither file, the class its model implies."""
    name = (cfg.get("tokenizer_class") or model_cfg.get("model_type")
            or "").lower()
    if name.startswith("roberta"):
        return "roberta"
    if name.startswith(("bert", "dpr")):
        return "bert"
    if name:
        return None
    return "bert" if isinstance(model, WordPiece) else "roberta"


def roberta_from_files(path: str, cfg: dict) -> Tokenizer:
    """vocab.json + merges.txt as RobertaTokenizerFast reads them."""
    from cocodr_tpu_torch.data import bpe

    vocab, merges = bpe.read_vocab_merges(os.path.join(path, "vocab.json"),
                                          os.path.join(path, "merges.txt"))
    specials = _special_tokens("roberta", cfg)
    model = bpe.BPE(vocab, merges)
    added = _AddedVocabulary(model.vocab)
    if "added_tokens_decoder" not in cfg:
        # the slow RobertaTokenizer's own, which the fast one starts from
        for attr in SPECIAL_ATTRS:
            added.add(dict(content=specials[attr], lstrip=False,
                           rstrip=False, normalized=True, special=True))
    _add_config_tokens(added, "roberta", cfg, specials)
    ids = {t.content: t.id for t in added.tokens.values()}
    return Tokenizer(model, None,
                     bpe.ByteLevel(cfg.get("add_prefix_space", False)),
                     Template((ids[specials["cls_token"]],),
                              (ids[specials["sep_token"]],), 4),
                     list(added.tokens.values()), specials)


def _normalizer(spec: Optional[dict]):
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "BertNormalizer":
        return BertNormalizer(spec.get("clean_text", True),
                              spec.get("handle_chinese_chars", True),
                              spec.get("strip_accents"),
                              spec.get("lowercase", True))
    if kind == "Lowercase":
        return lowercase
    raise ValueError(f"tokenizer.json: normalizer type {kind!r} is not "
                     "supported (BertNormalizer, Lowercase or null)")


def _pre_tokenizer(spec: Optional[dict]):
    from cocodr_tpu_torch.data import bpe

    kind = spec and spec.get("type")
    if kind == "ByteLevel":
        return bpe.ByteLevel(spec.get("add_prefix_space", True),
                             spec.get("use_regex", True))
    if kind == "BertPreTokenizer":
        return bert_pre_tokenize
    raise ValueError(f"tokenizer.json: pre_tokenizer type {kind!r} is not "
                     "supported (ByteLevel or BertPreTokenizer)")


def _model(spec: dict):
    from cocodr_tpu_torch.data import bpe

    kind = spec.get("type")
    if kind == "WordPiece":
        return WordPiece(spec["vocab"], spec.get("unk_token", "[UNK]"),
                         spec.get("continuing_subword_prefix", "##"),
                         spec.get("max_input_chars_per_word",
                                  MAX_WORD_CHARS))
    if kind == "BPE":
        for key in ("dropout", "continuing_subword_prefix",
                    "end_of_word_suffix", "byte_fallback"):
            if spec.get(key):
                raise ValueError(f"tokenizer.json: BPE with {key} "
                                 f"{spec[key]!r} is not supported")
        merges = []
        for m in spec["merges"]:
            pair = tuple(m.split(" ") if isinstance(m, str) else m)
            if len(pair) != 2:
                raise ValueError(f"tokenizer.json: merge {m!r} is not a "
                                 "pair")
            merges.append(pair)
        return bpe.BPE(spec["vocab"], merges, spec.get("unk_token"),
                       bool(spec.get("fuse_unk")),
                       bool(spec.get("ignore_merges")))
    raise ValueError(f"tokenizer.json: model type {kind!r} is not "
                     "supported (BPE or WordPiece)")


def _post_processor(spec: Optional[dict]) -> Template:
    if spec is None:
        return Template()
    kind = spec.get("type")
    if kind in ("RobertaProcessing", "BertProcessing"):
        cls_id, sep_id = spec["cls"][1], spec["sep"][1]
        return Template((cls_id,), (sep_id,),
                        4 if kind == "RobertaProcessing" else 3)
    if kind == "TemplateProcessing":
        ids = {k: tuple(v["ids"]) for k, v in spec["special_tokens"].items()}

        def specials(items):
            return [i for item in items if "SpecialToken" in item
                    for i in ids[item["SpecialToken"]["id"]]]

        single = spec["single"]
        seqs = [n for n, item in enumerate(single) if "Sequence" in item]
        if len(seqs) != 1 or single[seqs[0]]["Sequence"]["id"] != "A":
            raise ValueError("tokenizer.json: a TemplateProcessing single "
                             f"template without one $A: {single}")
        return Template(tuple(specials(single[:seqs[0]])),
                        tuple(specials(single[seqs[0] + 1:])),
                        len(specials(spec["pair"])))
    raise ValueError(f"tokenizer.json: post_processor type {kind!r} is not "
                     "supported (RobertaProcessing, BertProcessing, "
                     "TemplateProcessing or null)")


def from_tokenizer_json(path: str, cfg: dict, model_cfg: dict) -> Tokenizer:
    """A directory's tokenizer.json as AutoTokenizer loads it, with the
    changes its tokenizer class makes (the module docstring)."""
    spec = _read_json(os.path.join(path, "tokenizer.json"))
    model = _model(spec["model"])
    kind = _kind(cfg, model_cfg, model)
    norm_spec = spec.get("normalizer")
    if kind == "bert" and norm_spec and norm_spec.get(
            "type") == "BertNormalizer":
        norm_spec = dict(norm_spec,
                         lowercase=cfg.get("do_lower_case", True),
                         strip_accents=cfg.get("strip_accents"),
                         handle_chinese_chars=cfg.get(
                             "tokenize_chinese_chars", True))
    pre_spec = spec.get("pre_tokenizer")
    if pre_spec and pre_spec.get("type") == "ByteLevel":
        pre_spec = dict(pre_spec,
                        add_prefix_space=cfg.get("add_prefix_space", False))
    normalizer = _normalizer(norm_spec)
    specials = _special_tokens(kind, cfg)
    added = _AddedVocabulary(model.vocab)
    for value in spec.get("added_tokens") or []:
        added.add(_added(value, special=bool(value.get("special"))))
    _add_config_tokens(added, kind, cfg, specials)
    return Tokenizer(model, normalizer, _pre_tokenizer(pre_spec),
                     _post_processor(spec.get("post_processor")),
                     list(added.tokens.values()), specials)


def load_tokenizer(path: str) -> Tokenizer:
    """The tokenizer of a checkpoint directory (the CLI's --tokenizer), or
    of a vocab.txt path."""
    if os.path.isfile(path):
        return WordPieceTokenizer.from_pretrained(path)
    files = set(os.listdir(path)) if os.path.isdir(path) else set()
    cfg = _read_json(os.path.join(path, "tokenizer_config.json"))
    if "tokenizer.json" in files:
        model_cfg = _read_json(os.path.join(path, "config.json"))
        return from_tokenizer_json(path, cfg, model_cfg)
    if {"vocab.json", "merges.txt"} <= files:
        return roberta_from_files(path, cfg)
    if "vocab.txt" in files:
        return WordPieceTokenizer.from_pretrained(path)
    raise FileNotFoundError(
        f"{path} holds no tokenizer: tokenizer.json, vocab.json + "
        "merges.txt, or vocab.txt")
