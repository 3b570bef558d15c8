"""BERT WordPiece tokenization read from a checkpoint directory's
`vocab.txt`: the port's counterpart of what `transformers.AutoTokenizer`
returns for a BERT checkpoint (a `BertTokenizerFast`), without importing
transformers. COCO-DR's published checkpoints are BERT-base uncased.

The pipeline is the fast tokenizer's:
  1. the special tokens present in the vocabulary ([CLS], [SEP], [PAD],
     [MASK], [UNK]) are cut out of the raw text first and never split;
  2. normalization (BertNormalizer): control characters, NUL and U+FFFD
     dropped, whitespace mapped to a space, spaces put around CJK
     ideographs, then, with lowercasing (the default), accents stripped
     (NFD, combining marks of category Mn dropped) and the text
     lowercased;
  3. pre-tokenization (BertPreTokenizer): split on whitespace, and every
     punctuation character (ASCII punctuation or a Unicode P* category)
     becomes a word of its own;
  4. WordPiece: greedy longest match from the left, continuations
     prefixed with '##'; a word longer than 100 characters, or one with a
     piece outside the vocabulary, becomes [UNK].

`encode` and `__call__` are the two HuggingFace calling forms the port
uses (data/preprocess.py and pipelines/serve.py); `vocab_size`,
`all_special_tokens`, the `*_token_id`s, `num_special_tokens_to_add` and
`convert_ids_to_tokens` are the surface the COCO collator reads
(data/coco_collator.py), with BertTokenizerFast's values. A directory without
`vocab.txt` (RoBERTa's byte-level BPE in `vocab.json` + `merges.txt`, or
a `tokenizer.json` alone) raises NotImplementedError: ROADMAP.md Queue 1
item 15.
"""
from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")
MAX_WORD_CHARS = 100


def _is_whitespace(ch: str) -> bool:
    """Unicode White_Space (with tab, newline and carriage return)."""
    return ch in " \t\n\r" or ch in _WHITE_SPACE


# Unicode's White_Space property, which Python's str.isspace widens with
# U+001C..U+001F; those four count as control characters here
_WHITE_SPACE = frozenset(
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
# whitespace made one space, punctuation made a word of its own
_SPLITS = _CharMap(lambda ch: " " if _is_whitespace(ch)
                   else f" {ch} " if _is_punctuation(ch) else ch)


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """BERT WordPiece over a vocabulary list (line i of vocab.txt has id
    i; a token listed twice takes its last line, as in transformers).
    lowercase: BertTokenizerFast's do_lower_case; strip_accents None
    follows lowercase; chinese_chars: its tokenize_chinese_chars."""

    def __init__(self, vocab: Sequence[str], lowercase: bool = True,
                 strip_accents: Optional[bool] = None,
                 chinese_chars: bool = True):
        self.vocab: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.lowercase = lowercase
        self.strip_accents = (lowercase if strip_accents is None
                              else strip_accents)
        self.chinese_chars = chinese_chars
        missing = [t for t in ("[UNK]", "[CLS]", "[SEP]", "[PAD]")
                   if t not in self.vocab]
        if missing:
            raise ValueError(f"vocabulary lacks {missing}")
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_token_id = self.vocab["[PAD]"]
        # the special tokens present, longest first so that none is cut
        # out of a longer one
        self._specials = sorted((t for t in SPECIAL_TOKENS if t in self.vocab),
                                key=len, reverse=True)
        self._clean = _CharMap(self._clean_char)
        self._id_to_token = {i: t for t, i in self.vocab.items()}

    # BertTokenizerFast's names for the collator (data/coco_collator.py)
    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def cls_token_id(self) -> int:
        return self.cls_id

    @property
    def sep_token_id(self) -> int:
        return self.sep_id

    @property
    def mask_token_id(self) -> Optional[int]:
        return self.vocab.get("[MASK]")

    @property
    def all_special_tokens(self) -> List[str]:
        """In transformers' order (unk, sep, pad, cls, mask)."""
        return list(SPECIAL_TOKENS)

    def num_special_tokens_to_add(self, pair: bool = False) -> int:
        """[CLS] a [SEP], or [CLS] a [SEP] b [SEP] for a pair."""
        return 3 if pair else 2

    def convert_ids_to_tokens(self, ids):
        """An id -> its token, a list of ids -> a list (None for an id
        that no token keeps: a line of a token listed twice)."""
        if isinstance(ids, (int, np.integer)):
            return self._id_to_token.get(int(ids))
        return [self._id_to_token.get(int(i)) for i in ids]

    @classmethod
    def from_pretrained(cls, path: str) -> "WordPieceTokenizer":
        """A checkpoint directory with vocab.txt (and optionally
        tokenizer_config.json), or a vocab.txt path."""
        vocab_path = path
        cfg = {}
        if os.path.isdir(path):
            vocab_path = os.path.join(path, "vocab.txt")
            cfg_path = os.path.join(path, "tokenizer_config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    cfg = json.load(f)
        if not os.path.isfile(vocab_path):
            raise NotImplementedError(
                f"{path} has no vocab.txt: only BERT WordPiece tokenizers "
                "are ported; byte-level BPE (vocab.json + merges.txt) and "
                "tokenizer.json-only checkpoints wait for ROADMAP.md Queue "
                "1 item 15"
            )
        with open(vocab_path, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        return cls(vocab, lowercase=cfg.get("do_lower_case", True),
                   strip_accents=cfg.get("strip_accents"),
                   chinese_chars=cfg.get("tokenize_chinese_chars", True))

    def _clean_char(self, ch: str) -> Optional[str]:
        """NUL, U+FFFD and control characters dropped, whitespace made a
        space, CJK ideographs spaced apart."""
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            return None
        if _is_whitespace(ch):
            return " "
        if self.chinese_chars and _is_cjk(cp):
            return f" {ch} "
        return ch

    def _normalize(self, text: str) -> str:
        text = text.translate(self._clean)
        if self.strip_accents:
            text = unicodedata.normalize("NFD", text).translate(_MARKS)
        if self.lowercase:
            text = text.lower()
        return text

    def _words(self, text: str) -> List[str]:
        return [w for w in text.translate(_SPLITS).split(" ") if w]

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > MAX_WORD_CHARS:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = self.vocab[sub]
                    break
                end -= 1
            if piece is None:
                return [self.unk_id]
            ids.append(piece)
            start = end
        return ids

    def _segments(self, text: str) -> List[str]:
        """text cut at the special tokens: [plain, special, plain, ...]."""
        parts = [text]
        for tok in self._specials:
            nxt = []
            for i, p in enumerate(parts):
                if p in self._specials:
                    nxt.append(p)
                    continue
                pieces = p.split(tok)
                for j, q in enumerate(pieces):
                    if j:
                        nxt.append(tok)
                    nxt.append(q)
            parts = nxt
        return parts

    def tokenize_ids(self, text: str) -> List[int]:
        """Token ids of text, without [CLS] / [SEP]."""
        ids = []
        for seg in self._segments(text):
            if seg in self._specials:
                ids.append(self.vocab[seg])
                continue
            for word in self._words(self._normalize(seg)):
                ids.extend(self._wordpiece(word))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None,
               truncation: bool = False) -> List[int]:
        ids = self.tokenize_ids(text)
        extra = 2 if add_special_tokens else 0
        if truncation and max_length is not None:
            ids = ids[:max(max_length - extra, 0)]
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length: int = 512, return_tensors="np"):
        """Batch form: -> {"input_ids", "attention_mask"} int64 arrays
        [len(texts), max_length], padded with [PAD] to max_length."""
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


def load_tokenizer(path: str) -> WordPieceTokenizer:
    """The tokenizer of a checkpoint directory (the CLI's --tokenizer)."""
    return WordPieceTokenizer.from_pretrained(path)
